"""The fused IPDAE patch encoder (counterpart of pcc_tpu/ops/sa_pallas.py,
TPU kernel _encoder_kernel, entry patch_encoder_fused).

`patch_encoder` launches the CUDA kernel csrc/patch_encoder.cu on CUDA
tensors and runs `patch_encoder_plain`, the same function in plain
PyTorch, on CPU tensors: per [N, 3] patch, knn-nearest-neighbour grouping,
the SetAbstraction MLP with a max over neighbours, the concat with xyz, the
PointNet MLP and a max over points -> the pre-spread latent [P, D]. The
kernel's design note (what bounds it on an H100, what it does about that)
is at the top of csrc/patch_encoder.cu. Neighbour selection is bit-equal
between the two; the MLP sums run in another order, so latents agree to
float32 rounding.
"""

from __future__ import annotations

import torch

from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops.knn import knn_gather, select_nearest, sq_dists

_ARGTYPES = ([cuda_lib.PTR, cuda_lib.INT, cuda_lib.INT, cuda_lib.INT]
             + [cuda_lib.PTR] * 14 + [cuda_lib.INT, cuda_lib.PTR, cuda_lib.PTR])
SA_WIDTHS = (3, 32, 64, 128)
PN_WIDTHS = (131, 128, 256, 512)        # then D
KNN_SUPPORTED = (8, 16)
MAX_POINTS = 1024
MAX_D = 64


def patch_encoder_plain(patches: torch.Tensor, sa_wb, pn_wb, knn: int,
                        chunk: int = 256) -> torch.Tensor:
    """[P, N, 3] f32 -> [P, D]. sa_wb / pn_wb: lists of ([in, out] weight,
    [out] bias) tensors. Runs `chunk` patches at a time to bound the memory
    of the [chunk, N, knn, 128] grouped activations."""
    outs = []
    for s in range(0, patches.shape[0], chunk):
        p = patches[s:s + chunk]
        idx = select_nearest(sq_dists(p, p), knn)          # [c, N, knn]
        h = knn_gather(p, idx) - p[:, :, None, :]
        for w, b in sa_wb:
            h = torch.relu(h @ w + b)
        x = torch.cat([p, h.amax(dim=2)], dim=-1)          # [c, N, 131]
        for i, (w, b) in enumerate(pn_wb):
            x = x @ w + b
            if i < len(pn_wb) - 1:
                x = torch.relu(x)
        outs.append(x.amax(dim=1))
    return torch.cat(outs)


def patch_encoder(patches: torch.Tensor, sa_wb, pn_wb, knn: int) -> torch.Tensor:
    """[P, N, 3] f32 patches -> pre-spread latent [P, D] f32: the CUDA kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if patches.device.type == "cpu":
        return patch_encoder_plain(patches, sa_wb, pn_wb, knn)
    cuda_lib.require_cuda("patch_encoder", patches, torch.float32, 3)
    P, N, C = patches.shape
    D = pn_wb[-1][0].shape[1]
    if (C != 3 or knn not in KNN_SUPPORTED or N % 16 or not knn <= N <= MAX_POINTS
            or not 0 < D <= MAX_D):
        raise ValueError(f"patch_encoder: unsupported patches {tuple(patches.shape)}, "
                         f"knn={knn}, D={D}")
    widths = [w.shape for w, _ in sa_wb] + [w.shape for w, _ in pn_wb]
    want = ([(SA_WIDTHS[i], SA_WIDTHS[i + 1]) for i in range(3)]
            + [(PN_WIDTHS[i], PN_WIDTHS[i + 1]) for i in range(3)] + [(512, D)])
    if [tuple(s) for s in widths] != want:
        raise ValueError(f"patch_encoder: weight shapes {widths} != {want}")
    args = []
    for w, b in list(sa_wb) + list(pn_wb):
        cuda_lib.require_cuda("patch_encoder weight", w, torch.float32, 2)
        cuda_lib.require_cuda("patch_encoder bias", b, torch.float32, 1)
        args += [w.data_ptr(), b.data_ptr()]
    out = torch.empty((P, D), dtype=torch.float32, device=patches.device)
    cuda_lib.launch("patch_encoder", _ARGTYPES, patches.data_ptr(), P, N, knn,
                    *args, D, out.data_ptr(), cuda_lib.stream_ptr(patches))
    return out
