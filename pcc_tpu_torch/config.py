"""Shared codec configuration (the PyTorch port's copy of pcc_tpu/config.py).

The reference spreads these hyperparameters across per-CLI argparse defaults
(reference train.py:33-47, compress.py:30-34) and in-code magic constants
(pn_kit.py:17-23 OCTREE_BPP_DICT, AE.py:43 quantizer spread). Here they live
in one dataclass; CLIs build it from flags with the reference's names/defaults.

`model` selects the family, as in pcc_tpu: "AE" (IPDAE) or "PPPF-AE" (PN++
encoder + FoldingNet decoder). The port implements pcc_tpu's defaults for the
fields it leaves out: the integer CDF mode. The TPU kernel
switches (fused_sa, fused_decode, pruned_knn) have no counterpart: on a CUDA
device the port always runs its kernels, and its patch selection is the
exact dense KNN whose output the pruned search reproduces bit for bit.
`compute_dtype` is pcc_tpu's: "float32", or "bfloat16" for bf16 mixed
precision in the networks (parameters, the quantizer's arithmetic and the
integer coding stay float32; ops/bf16.py), which the port serves (compress
and decompress) and trains for --model AE (cli/train.py --bf16; pcc_tpu's
PPPF-AE trainer computes in float32 whatever compute_dtype says, and so
does the port's). PPPEConfig.compute_dtype is PPPE's, which trains in bf16
(cli/train_pppe_pcd_ae.py --bf16) and serves in float32.
"""

from __future__ import annotations

import dataclasses

from pcc_tpu_torch.ops.bf16 import COMPUTE_DTYPES

# Minimum skeleton bpp per patch size K; mirrors reference pn_kit.py:17-23.
OCTREE_BPP_DICT = {
    1024: 0.07,
    512: 0.125,
    256: 0.25,
    128: 0.5,
    64: 1.0,
}

# Reference caps the adaptive-depth search at 16 (pn_kit.py:386). The device
# octree uses int32 Morton codes, which bounds depth at 10 (3*10 = 30 bits);
# FPS-sampled skeletons are losslessly separable well before depth 10.
MAX_OCTREE_DEPTH = 10

MODELS = ("AE", "PPPF-AE")

# Global RNG seed; reference seeds torch/np with 11 (train.py:18-20).
DEFAULT_SEED = 11


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Static shape/hyperparameter bundle for the patch pipeline.

    Derived quantities follow reference train.py:254:
      S = N * ALPHA // K   (number of patches / skeleton points)
      k = K // ALPHA       (points produced per decoded patch)
    """

    N: int = 8192      # points per cloud
    N0: int = 1024     # scale-transform constant (train.py:34)
    ALPHA: int = 2     # patch coverage factor
    K: int = 256       # points per patch
    d: int = 16        # bottleneck dim
    L: int = 7         # quantization levels
    sa_knn: int = 16   # KNN size inside SetAbstraction (AE.py:16)
    margin: float = 0.01  # normalize margin (pn_kit.py:47)
    max_depth: int = MAX_OCTREE_DEPTH
    model: str = "AE"  # "AE" (IPDAE) | "PPPF-AE" (train.py --model)
    # network computation dtype: "float32" or "bfloat16" (pcc_tpu's bf16
    # mixed precision); parameters, the quantizer arithmetic and the integer
    # CDFs stay float32 / exact either way
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"model={self.model!r} is not one of {MODELS}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype={self.compute_dtype!r} is not one of "
                             f"{COMPUTE_DTYPES}")
        # the encoded symbol array travels as int8: L beyond 128 would
        # silently wrap into a corrupt-but-decodable stream
        if not 2 <= self.L <= 128:
            raise ValueError(
                f"L={self.L} out of range [2, 128]: symbols are carried as "
                "int8 in the coding pipeline")

    @property
    def S(self) -> int:
        return self.N * self.ALPHA // self.K

    @property
    def k(self) -> int:
        return self.K // self.ALPHA

    @property
    def min_bpp(self) -> float:
        """Octree skeleton bpp floor for this K (pn_kit.py:17-23)."""
        return OCTREE_BPP_DICT.get(self.K, 0.25)

    @property
    def patch_scale(self) -> float:
        """Patch coordinate scaling (N/N0)^(1/3) (train.py:192)."""
        return float((self.N / self.N0) ** (1.0 / 3.0))

    def with_n(self, N: int) -> "CodecConfig":
        """Per-cloud N at compress time (compress.py:92-93)."""
        return dataclasses.replace(self, N=N)


@dataclasses.dataclass(frozen=True)
class PPPEConfig:
    """The PPPE whole-cloud pipeline's configuration (pcc_tpu/config.py:121;
    reference train_pppe_pcd_ae.py:27-29). compute_dtype "bfloat16" is
    pcc_tpu's bf16 mixed precision in the PointCloudAE (parameters float32),
    which the port trains (models/pppe.py)."""

    N: int = 8192          # points per cloud
    latent_dim: int = 256  # '--K' in the reference PPPE CLIs
    L: int = 7             # quantization bins
    coarse_points: int = 512
    margin: float = 0.01
    compute_dtype: str = "float32"  # "bfloat16" = mixed-precision networks

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype={self.compute_dtype!r} is not one of "
                             f"{COMPUTE_DTYPES}")
