"""The fused IPDAE patch decoder (counterpart of
pcc_tpu/ops/decoder_pallas.py, TPU kernel _decoder_kernel, entry
patch_decoder_fused).

`patch_decoder` launches the CUDA kernel csrc/patch_decoder.cu on CUDA
tensors and runs `patch_decoder_plain`, the same function in plain
PyTorch, on CPU tensors: the layer-3 expansion over permuted columns, the
fold, the latent tile + concat and the point MLP -> [P, k, 3]. The first
two inv_pool layers stay outside, as in pcc_tpu (models/ipdae.py). The
kernel's design note is at the top of csrc/patch_decoder.cu.

The kernel takes its weights in its own layout (`pack_decoder`): every
product operand K-major (wgmma reads 32-bit operands only so) and split
into TF32 hi and lo (`split_tf32`) for its 3xTF32 products, the expansion
point-major (`expansion_kmajor`), the MLP's input columns permuted in
groups of 8 (`mlp_kmajor`) so that one layer's accumulator is the next
layer's operand as it stands.

bf16=True runs the kernel's bf16 instance (launch counter
"patch_decoder_bf16", .bf16 wgmma with both expansion operands in shared
memory), rounding where pcc_tpu's bf16 decoder kernel rounds
(decoder_pallas.py:39-70): every weight, the kernel's input h2 (which the
wrapper hands over as a bf16 tensor, rounded once), the fold and every
inv_mlp layer's output; the biases stay float32. Its layout
(`pack_decoder(..., bf16=True)`) holds each weight once as a bf16 tensor,
K-major, the inv_mlp layers in their natural column order (a bf16
accumulator is the next product's operand as it stands).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops.bf16 import kernel_dense, round_bf16

_ARGTYPES = ([cuda_lib.PTR, cuda_lib.PTR] + [cuda_lib.INT] * 4
             + [cuda_lib.PTR] * 14 + [cuda_lib.PTR, cuda_lib.PTR])
_BF16_ARGTYPES = ([cuda_lib.PTR, cuda_lib.PTR] + [cuda_lib.INT] * 4
                  + [cuda_lib.PTR] * 10 + [cuda_lib.PTR, cuda_lib.PTR])
MLP_WIDTHS = (128, 64, 32, 3)
MAX_D = 64
# the kernel's k = 8 steps read an 8-column group of a layer's input in this
# order: its accumulator columns 2t and 2t + 1 are the next product's k = t
# and t + 4 (csrc/wgmma_tf32.cuh, fragments)
GROUP_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
_TF32_HI = -(1 << 13)   # 0xffffe000 as int32: clears the 13 mantissa bits TF32 drops


class PackedDecoder(NamedTuple):
    """The kernel's weights (pack_decoder). w_hi / w_lo: the expansion
    [k*128, C]; b3r [k*128]; m_hi / m_lo: layers 1-3 [out, round8(in)];
    mb: their biases; w4 [32, 3], b4 [3]. bf16: the bf16 instance's layout
    (bf16_layout), where w_hi and m_hi are bf16 tensors (m_hi [out,
    round16(in)], natural column order), w_lo / m_lo the same tensors (the
    kernel reads one part) and w4 float32 rounded to bf16."""
    w_hi: torch.Tensor
    w_lo: torch.Tensor
    b3r: torch.Tensor
    m_hi: tuple
    m_lo: tuple
    mb: tuple
    w4: torch.Tensor
    b4: torch.Tensor
    bf16: bool = False


def permute_expansion(w3: torch.Tensor, b3: torch.Tensor, k: int):
    """Reorder inv_pool layer-3 columns ([C, k*128] kernel layout) from
    channel-major (c*k + j, the reference's [B, 128, k] view, AE.py:49) to
    point-major (j*128 + c), so point j's fold is one contiguous column
    slice."""
    C = w3.shape[0]
    w3r = w3.reshape(C, 128, k).transpose(1, 2).reshape(C, k * 128)
    b3r = b3.reshape(128, k).t().reshape(k * 128)
    return w3r.contiguous(), b3r.contiguous()


def expansion_kmajor(weight: torch.Tensor, k: int) -> torch.Tensor:
    """inv_pool layer 3's nn.Linear weight [k*128, C] (row c*k + j) with its
    rows point-major (row j*128 + c): permute_expansion(weight.t(), ...)[0].t(),
    made in one copy."""
    C = weight.shape[1]
    return weight.reshape(128, k, C).transpose(0, 1).reshape(k * 128, C).contiguous()


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = x with its 13 low mantissa bits cleared (what the
    tensor cores read of a TF32 operand) and lo = x - hi, exact in float32."""
    hi = (x.contiguous().view(torch.int32) & _TF32_HI).view(torch.float32)
    return hi, x - hi


def mlp_kmajor(w: torch.Tensor) -> torch.Tensor:
    """An inv_mlp weight [in, out] as the kernel reads it: [out, round8(in)],
    K-major, each 8-column group in GROUP_ORDER, zero past `in`."""
    cin, cout = w.shape
    kp = -(-cin // 8) * 8
    wp = torch.zeros((kp, cout), dtype=w.dtype, device=w.device)
    wp[:cin] = w
    col = torch.arange(kp, device=w.device)
    order = torch.tensor(GROUP_ORDER, device=w.device)
    return wp[col // 8 * 8 + order[col % 8]].t().contiguous()


def pack_decoder(w_kmajor: torch.Tensor, b3r: torch.Tensor, mlp_wb,
                 bf16: bool = False) -> PackedDecoder:
    """The kernel's weights from the point-major K-major expansion weight
    [k*128, C] (expansion_kmajor, or permute_expansion's w3r.t()), its
    point-major bias and the inv_mlp ([in, out] weight, bias) pairs; with
    bf16, in the bf16 instance's layout (every weight rounded to bf16, one
    part, the biases float32)."""
    if bf16:
        return bf16_layout(w_kmajor, b3r, mlp_wb)
    w_hi, w_lo = split_tf32(w_kmajor.contiguous())
    m_hi, m_lo = zip(*(split_tf32(mlp_kmajor(w)) for w, _ in mlp_wb[:3]))
    return PackedDecoder(w_hi, w_lo.contiguous(), b3r.contiguous(), tuple(m_hi),
                         tuple(t.contiguous() for t in m_lo),
                         tuple(b.contiguous() for _, b in mlp_wb[:3]),
                         mlp_wb[3][0].contiguous(), mlp_wb[3][1].contiguous())


def mlp_kmajor_bf16(w: torch.Tensor) -> torch.Tensor:
    """An inv_mlp weight [in, out] as the bf16 kernel reads it: a bf16
    [out, round16(in)], K-major, zero past `in`."""
    cin, cout = w.shape
    wp = torch.zeros((cout, -(-cin // 16) * 16), dtype=torch.bfloat16, device=w.device)
    wp[:, :cin] = w.t().to(torch.bfloat16)
    return wp


def bf16_layout(w_kmajor: torch.Tensor, b3r: torch.Tensor, mlp_wb) -> PackedDecoder:
    """pack_decoder's layout for the bf16 instance: the expansion [k*128, C]
    and layers 1-3 (mlp_kmajor_bf16) as bf16 tensors, w4 rounded to bf16 in
    float32, the biases float32 as they are."""
    w = w_kmajor.to(torch.bfloat16).contiguous()
    m = tuple(mlp_kmajor_bf16(wl) for wl, _ in mlp_wb[:3])
    return PackedDecoder(w, w, b3r.contiguous(), m, m,
                         tuple(b.contiguous() for _, b in mlp_wb[:3]),
                         round_bf16(mlp_wb[3][0]).contiguous(), mlp_wb[3][1].contiguous(),
                         bf16=True)


# the bf16 kernel's tile plan (csrc/patch_decoder.cu, dec16): 128 patch rows x
# 2 points a tile, one CTA a tile
BF16_TILE_ROWS, BF16_TILE_POINTS = 128, 2
BF16_MLP_BYTES = 2 * 64 * (3 * 128 + 2 * 64 + 32)   # the inv_mlp's tiles, once a CTA


def bf16_tma_bytes(P: int, C: int, k: int, ctas: int) -> int:
    """Bytes the bf16 kernel's TMA loads bring from L2 into shared memory
    for h2 [P, C] and k points on `ctas` CTAs: per tile, its h2 box (128
    rows x C bf16) and its two points' 256 weight rows x C; the inv_mlp's
    tiles once a CTA."""
    tiles = -(-P // BF16_TILE_ROWS) * -(-k // BF16_TILE_POINTS)
    per_tile = 2 * C * (BF16_TILE_ROWS + BF16_TILE_POINTS * 128)
    return tiles * per_tile + min(ctas, tiles) * BF16_MLP_BYTES


def patch_decoder_plain(h2: torch.Tensor, lat: torch.Tensor, w3r: torch.Tensor,
                        b3r: torch.Tensor, mlp_wb, k: int, bf16: bool = False) -> torch.Tensor:
    """h2 [P, C], lat [P, d], permuted expansion w3r [C, k*128] / b3r,
    inv_mlp ([in, out] weight, bias) pairs -> [P, k, 3]. bf16: pcc_tpu's
    bf16 kernel, every layer `kernel_dense` (h2, the weights and each
    layer's output rounded to bf16; the biases float32; the latent exact)."""
    P, d = lat.shape
    if bf16:
        fold = kernel_dense(h2, w3r, b3r, relu=True).reshape(P, k, 128)
        x = torch.cat([fold, lat[:, None, :].expand(P, k, d)], dim=-1)
        for i, (w, b) in enumerate(mlp_wb):
            x = kernel_dense(x, w, b, relu=i < len(mlp_wb) - 1)
        return x
    fold = torch.relu(h2 @ w3r + b3r).reshape(P, k, 128)
    x = torch.cat([fold, lat[:, None, :].expand(P, k, d)], dim=-1)
    for i, (w, b) in enumerate(mlp_wb):
        x = x @ w + b
        if i < len(mlp_wb) - 1:
            x = torch.relu(x)
    return x


def _check(name: str, t: torch.Tensor, shape, tma: bool = True,
           dtype: torch.dtype = torch.float32) -> None:
    """Raise unless t is a contiguous CUDA tensor of `dtype` and `shape`,
    16-byte aligned where the kernel reads it by TMA."""
    cuda_lib.require_cuda(f"patch_decoder {name}", t, dtype, len(shape))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"patch_decoder: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if tma and t.data_ptr() % 16:
        raise ValueError(f"patch_decoder: {name} is not 16-byte aligned")


def patch_decoder(h2: torch.Tensor, lat: torch.Tensor, w3r: torch.Tensor,
                  b3r: torch.Tensor, mlp_wb, k: int,
                  packed: PackedDecoder | None = None, bf16: bool = False) -> torch.Tensor:
    """Fused patch decoder: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. Shapes as in patch_decoder_plain; `packed`, the
    kernel's layout of the same weights (pack_decoder, for the same
    instance), is made from w3r, b3r and mlp_wb where the caller holds
    none. bf16: the bf16 instance."""
    if h2.device.type == "cpu":
        return patch_decoder_plain(h2, lat, w3r, b3r, mlp_wb, k, bf16=bf16)
    P, C = h2.shape
    d = lat.shape[1]
    if lat.shape[0] != P or C % (64 if bf16 else 32) or not 0 < d <= MAX_D:
        raise ValueError(f"patch_decoder: unsupported shapes h2 {tuple(h2.shape)}, "
                         f"lat {tuple(lat.shape)}")
    want = [(128 + d, 128), (128, 64), (64, 32), (32, 3)]
    if [tuple(w.shape) for w, _ in mlp_wb] != want:
        raise ValueError(f"patch_decoder: inv_mlp shapes "
                         f"{[tuple(w.shape) for w, _ in mlp_wb]} != {want}")
    if packed is None:
        if tuple(w3r.shape) != (C, k * 128):
            raise ValueError(f"patch_decoder: w3r has shape {tuple(w3r.shape)}, "
                             f"expected {(C, k * 128)}")
        packed = pack_decoder(w3r.t(), b3r, mlp_wb, bf16=bf16)
    if packed.bf16 != bf16:
        raise ValueError(f"patch_decoder: weights packed for the other instance than bf16={bf16}")
    # the weights' type and their K padding: bf16 steps 16 columns, TF32 8
    wdt, step = (torch.bfloat16, 16) if bf16 else (torch.float32, 8)
    _check("h2", h2, (P, C))
    cuda_lib.require_cuda("patch_decoder lat", lat, torch.float32, 2)
    _check("expansion hi", packed.w_hi, (k * 128, C), dtype=wdt)
    _check("expansion lo", packed.w_lo, (k * 128, C), dtype=wdt)
    _check("expansion bias", packed.b3r, (k * 128,), tma=False)
    args = []
    for i, (cin, cout) in enumerate(want[:3]):
        kp = -(-cin // step) * step
        _check(f"layer {i + 1} hi", packed.m_hi[i], (cout, kp), dtype=wdt)
        _check(f"layer {i + 1} lo", packed.m_lo[i], (cout, kp), dtype=wdt)
        _check(f"layer {i + 1} bias", packed.mb[i], (cout,), tma=False)
        args += [packed.m_hi[i].data_ptr(), packed.m_lo[i].data_ptr(), packed.mb[i].data_ptr()]
    _check("layer 4", packed.w4, (32, 3), tma=False)
    _check("layer 4 bias", packed.b4, (3,), tma=False)
    out = torch.empty((P, k, 3), dtype=torch.float32, device=h2.device)
    if bf16:
        # h2 rounded to bf16 once here (what the kernel's products read: the
        # plain version's round_bf16, pcc_tpu's in-kernel cast); one part of
        # each weight: layer i's (weight, bias) of args' (hi, lo, bias)
        h2b = h2.to(torch.bfloat16)
        cuda_lib.launch("patch_decoder_bf16", _BF16_ARGTYPES, h2b.data_ptr(), lat.data_ptr(), P,
                        C, d, k, packed.w_hi.data_ptr(), packed.b3r.data_ptr(),
                        *[a for i in range(3) for a in (args[3 * i], args[3 * i + 2])],
                        packed.w4.data_ptr(), packed.b4.data_ptr(), out.data_ptr(),
                        cuda_lib.stream_ptr(h2))
        return out
    cuda_lib.launch("patch_decoder", _ARGTYPES, h2.data_ptr(), lat.data_ptr(), P, C, d, k,
                    packed.w_hi.data_ptr(), packed.w_lo.data_ptr(), packed.b3r.data_ptr(),
                    *args, packed.w4.data_ptr(), packed.b4.data_ptr(), out.data_ptr(),
                    cuda_lib.stream_ptr(h2))
    return out
