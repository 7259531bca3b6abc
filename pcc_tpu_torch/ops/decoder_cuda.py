"""The fused IPDAE patch decoder (counterpart of
pcc_tpu/ops/decoder_pallas.py, TPU kernel _decoder_kernel, entry
patch_decoder_fused).

`patch_decoder` launches the CUDA kernel csrc/patch_decoder.cu on CUDA
tensors and runs `patch_decoder_plain`, the same function in plain
PyTorch, on CPU tensors: the layer-3 expansion over permuted columns, the
fold, the latent tile + concat and the point MLP -> [P, k, 3]. The first
two inv_pool layers stay outside, as in pcc_tpu (models/ipdae.py). The
kernel's design note is at the top of csrc/patch_decoder.cu.
"""

from __future__ import annotations

import torch

from pcc_tpu_torch.ops import cuda_lib

_ARGTYPES = ([cuda_lib.PTR, cuda_lib.PTR] + [cuda_lib.INT] * 4
             + [cuda_lib.PTR] * 11 + [cuda_lib.PTR])
MLP_WIDTHS = (128, 64, 32, 3)
MAX_D = 64


def permute_expansion(w3: torch.Tensor, b3: torch.Tensor, k: int):
    """Reorder inv_pool layer-3 columns ([C, k*128] kernel layout) from
    channel-major (c*k + j, the reference's [B, 128, k] view, AE.py:49) to
    point-major (j*128 + c), so point j's fold is one contiguous column
    slice."""
    C = w3.shape[0]
    w3r = w3.reshape(C, 128, k).transpose(1, 2).reshape(C, k * 128)
    b3r = b3.reshape(128, k).t().reshape(k * 128)
    return w3r.contiguous(), b3r.contiguous()


def patch_decoder_plain(h2: torch.Tensor, lat: torch.Tensor, w3r: torch.Tensor,
                        b3r: torch.Tensor, mlp_wb, k: int) -> torch.Tensor:
    """h2 [P, C], lat [P, d], permuted expansion w3r [C, k*128] / b3r,
    inv_mlp ([in, out] weight, bias) pairs -> [P, k, 3]."""
    P, d = lat.shape
    fold = torch.relu(h2 @ w3r + b3r).reshape(P, k, 128)
    x = torch.cat([fold, lat[:, None, :].expand(P, k, d)], dim=-1)
    for i, (w, b) in enumerate(mlp_wb):
        x = x @ w + b
        if i < len(mlp_wb) - 1:
            x = torch.relu(x)
    return x


def patch_decoder(h2: torch.Tensor, lat: torch.Tensor, w3r: torch.Tensor,
                  b3r: torch.Tensor, mlp_wb, k: int) -> torch.Tensor:
    """Fused patch decoder: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. Shapes as in patch_decoder_plain."""
    if h2.device.type == "cpu":
        return patch_decoder_plain(h2, lat, w3r, b3r, mlp_wb, k)
    cuda_lib.require_cuda("patch_decoder h2", h2, torch.float32, 2)
    cuda_lib.require_cuda("patch_decoder lat", lat, torch.float32, 2)
    cuda_lib.require_cuda("patch_decoder w3r", w3r, torch.float32, 2)
    cuda_lib.require_cuda("patch_decoder b3r", b3r, torch.float32, 1)
    P, C = h2.shape
    d = lat.shape[1]
    if (lat.shape[0] != P or C % 32 or not 0 < d <= MAX_D
            or tuple(w3r.shape) != (C, k * 128) or tuple(b3r.shape) != (k * 128,)):
        raise ValueError(f"patch_decoder: unsupported shapes h2 {tuple(h2.shape)}, "
                         f"lat {tuple(lat.shape)}, w3r {tuple(w3r.shape)}, k={k}")
    want = [(128 + d, 128), (128, 64), (64, 32), (32, 3)]
    if [tuple(w.shape) for w, _ in mlp_wb] != want:
        raise ValueError(f"patch_decoder: inv_mlp shapes "
                         f"{[tuple(w.shape) for w, _ in mlp_wb]} != {want}")
    args = []
    for w, b in mlp_wb:
        cuda_lib.require_cuda("patch_decoder weight", w, torch.float32, 2)
        cuda_lib.require_cuda("patch_decoder bias", b, torch.float32, 1)
        args += [w.data_ptr(), b.data_ptr()]
    out = torch.empty((P, k, 3), dtype=torch.float32, device=h2.device)
    cuda_lib.launch("patch_decoder", _ARGTYPES, h2.data_ptr(), lat.data_ptr(),
                    P, C, d, k, w3r.data_ptr(), b3r.data_ptr(), *args,
                    out.data_ptr(), cuda_lib.stream_ptr(h2))
    return out
