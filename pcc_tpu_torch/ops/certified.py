"""Certified rounding in plain PyTorch: the rule by which the bf16 encoder
and the bf16 "pppf" stage (csrc/certified.cuh) run their products on the
bf16 tensor cores and still give, bit for bit, the outputs of the float32
k-order sums that the CUDA-core kernels compute.

A layer's rounded output is f(s), s the float32 sum of its K products in
k-order and f a chain of monotone float32 operations (bias, BatchNorm
affine, relu, the round to bf16). Given another sum s' of the same
products (the tensor cores') and R, the sum of their magnitudes plus the
magnitudes of the partial sums at each k16 step after the first
(`bound_sums`), `err_bound(R, K)` is an E with |s' - s| <= E under the
header's model; `certify` evaluates f at s' - E rounded down and s' + E
rounded up: where the two are bit-equal, that is f(s) (f is monotone);
elsewhere the entry is flagged and recomputed in k-order. `pack_frags`
lays a weight out as the kernels read it. `flag_shares` measures the
flagged share of a layer under the kernels' bound and under two looser
ones, for the design notes. `model_sums` checks the model itself on the
card (csrc/cert_model.cu): the tensor cores' sums, the k-order sums and E
as the kernels form them, on `stress_rows`.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops.bf16 import round_bf16

U = 2.0 ** -24
C = 50 * U * (1 + 2.0 ** -8)        # certified.cuh's kCertC


def _f32_up(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> the least float32 >= it."""
    y = x64.to(torch.float32)
    return torch.where(y.double() < x64, torch.nextafter(y, torch.full_like(y, np.inf)), y)


def _f32_down(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> the greatest float32 <= it."""
    y = x64.to(torch.float32)
    return torch.where(y.double() > x64, torch.nextafter(y, torch.full_like(y, -np.inf)), y)


def cert_a(k: int) -> float:
    """a_K = (2 K + 2) 2^-100, the products flushed below 2^-126."""
    return float(_f32_up(torch.tensor((2 * k + 2) * 2.0 ** -100, dtype=torch.float64)))


def bound_sums(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """R of x [..., K] @ w [K, N] in exact arithmetic, as float32: the sum
    of |x_k w_k| plus |the partial sum| after each k16 step but the last
    (the kernels accumulate it from the tensor cores' sums)."""
    x64, w64 = x.double(), w.double()
    r = x64.abs() @ w64.abs()
    for k0 in range(16, x.shape[-1], 16):
        r = r + (x64[..., :k0] @ w64[:k0]).abs()
    return r.to(torch.float32)


def err_bound(r: torch.Tensor, k: int) -> torch.Tensor:
    """E = C R + a_K rounded up (the kernels' __fmaf_ru)."""
    return _f32_up(r.double() * C + cert_a(k))


def certify(s: torch.Tensor, r: torch.Tensor, k: int, f):
    """(f at s - E rounded down, whether f differs at s + E rounded up):
    the value of every entry that is not flagged, and the flags."""
    e = err_bound(r, k).double()
    lo = f(_f32_down(s.double() - e))
    hi = f(_f32_up(s.double() + e))
    return lo, lo.view(torch.int32) != hi.view(torch.int32)


def bias_relu(b: torch.Tensor):
    """The encoder's epilogue: round_bf16(relu(s + b))."""
    return lambda s: round_bf16(torch.relu(s + b))


def bn_relu(b, mean, mul, beta):
    """The stage's epilogue: round_bf16(relu(fma((s + b) - mean, mul,
    beta))), the fused multiply-add in float64 rounded once."""
    def f(s):
        t = (s + b) - mean
        return round_bf16(torch.relu((t.double() * mul.double() + beta.double()).to(
            torch.float32)))
    return f


def flag_shares(x: torch.Tensor, w: torch.Tensor, f) -> dict:
    """The share of a layer's entries (x [R, K] and w [K, N] bf16 values,
    f its epilogue) that certify flags with the kernels' bound
    ("partial_sums"), with the bound linear in K, E = 3.25 K u A
    ("linear", A the sum of |x| |w|), and with that bound on A = |x_r|_2
    |w_c|_2 ("cauchy_schwarz"); the sums themselves exact."""
    s = (x.double() @ w.double()).to(torch.float32)
    k = x.shape[1]
    a = x.abs().double() @ w.abs().double()
    cs = x.double().norm(dim=1, keepdim=True) * w.double().norm(dim=0)

    def share(e):
        e = _f32_up(e).double()
        lo, hi = f(_f32_down(s.double() - e)), f(_f32_up(s.double() + e))
        return float((lo.view(torch.int32) != hi.view(torch.int32)).double().mean())

    return dict(partial_sums=float(certify(s, bound_sums(x, w), k, f)[1].double().mean()),
                linear=share(3.25 * k * U * a), cauchy_schwarz=share(3.25 * k * U * cs))


def pack_frags(w: torch.Tensor, n_align: int = 16) -> torch.Tensor:
    """W [K, N] (bf16 values, float32) -> its mma.sync B fragments as the
    kernels read them (csrc/certified.cuh): int32 [N8 / 8, KS, 32, 2] with
    K padded to KS * 16 and N to N8 (a multiple of n_align) by zeros; lane
    4 g + t of n8 tile j and k16 step s holds W[16 s + 2 t (+1)][8 j + g]
    and W[16 s + 8 + 2 t (+1)][8 j + g], the lower k in the lower 16
    bits."""
    k, n = w.shape
    kp, np_ = (k + 15) // 16 * 16, (n + n_align - 1) // n_align * n_align
    wp = torch.zeros((kp, np_), dtype=torch.bfloat16, device=w.device)
    wp[:k, :n] = w.detach().to(torch.bfloat16)
    # k = 16 s + 8 reg + 2 t + half, n = 8 j + g -> [j, s, g, t, reg, half]
    v = wp.view(kp // 16, 2, 4, 2, np_ // 8, 8).permute(4, 0, 5, 2, 1, 3).contiguous()
    return v.view(torch.int32).view(np_ // 8, kp // 16, 32, 2)


_CACHE: dict = {}


def cached_frags(ws, n_align: int = 16, cat: bool = False):
    """pack_frags of each weight in ws (None for those under 16 deep), or
    with `cat` all of them flat in one tensor, kept while the weights live
    and are not changed in place (their versions; an inference tensor,
    such as the bf16 weights a model makes under torch.inference_mode,
    has none, and is taken as it was)."""
    key = (n_align, cat) + tuple(id(w) for w in ws)
    vers = tuple(-1 if w.is_inference() else w._version for w in ws)
    hit = _CACHE.get(key)
    if hit is not None and hit[1] == vers and all(r() is w for r, w in zip(hit[0], ws)):
        return hit[2]
    frags = [pack_frags(w, n_align) if w.shape[0] >= 16 else None for w in ws]
    if cat:
        frags = torch.cat([f.flatten() for f in frags])
    _CACHE[key] = (tuple(weakref.ref(w) for w in ws), vers, frags)
    for w in ws:
        weakref.finalize(w, _CACHE.pop, key, None)
    return frags


# Rows that stress certified.cuh's model of the tensor cores' accumulation,
# at the depths of its check (K = 16, one k16 block; 131, the encoder's
# PointNet layer 1; 256; 1024, past every layer of the paths).
STRESS_KINDS = ("cancelling", "spread", "subnormal", "random")
STRESS_DEPTHS = (16, 131, 256, 1024)


def stress_rows(kind: str, k: int, seed: int, rows: int = 64, cols: int = 16):
    """(x [rows, k], w [k, cols]) bf16 values (float32) built to stress the
    model: "cancelling", rows near 1 against columns of mean 0 with large
    partial sums and small totals, signs alternating along k;
    "spread", magnitudes 2^0 to 2^-40 mixed inside every k16 block, random
    signs (the block's alignment truncates the small ones); "subnormal",
    products from 2^-96 to 2^-140, into float32's subnormal range;
    "random", relu(normal) rows and normal weights."""
    g = torch.Generator().manual_seed(seed)
    if kind == "cancelling":
        x = 1 + 0.01 * torch.rand((rows, k), generator=g)
        x = x * torch.where(torch.arange(k) % 2 == 0, 1.0, -1.0)
        w = torch.randn((k, cols), generator=g) + 4.0
        w = w - w.mean(dim=0)
    elif kind == "spread":
        ex = torch.randint(0, 41, (rows, k), generator=g).float()
        x = torch.exp2(-ex) * (1 + torch.rand((rows, k), generator=g))
        x = x * (torch.randint(0, 2, (rows, k), generator=g) * 2 - 1)
        w = torch.randn((k, cols), generator=g)
    elif kind == "subnormal":
        ex = torch.randint(33, 78, (rows, k), generator=g).float()
        x = torch.exp2(-ex) * (1 + torch.rand((rows, k), generator=g))
        x = x * (torch.randint(0, 2, (rows, k), generator=g) * 2 - 1)
        w = 2.0 ** -63 * torch.randn((k, cols), generator=g)
    elif kind == "random":
        x = torch.relu(torch.randn((rows, k), generator=g))
        w = torch.randn((k, cols), generator=g) * k ** -0.5
    else:
        raise ValueError(f"stress_rows: unknown kind {kind!r}")
    return round_bf16(x), round_bf16(w)


def _chop(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    y = x64.to(torch.float32)
    return torch.where(y.double().abs() > x64.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def model_sums_plain(x: torch.Tensor, w: torch.Tensor):
    """model_sums by the model itself: s_tc the sum in k16 blocks with every
    addition truncated toward zero, s_k the k-order fused multiply-add sum,
    E = err_bound of R, the sum of |x| |w| plus |s_tc| after each k16 step
    but the last."""
    from pcc_tpu_torch.ops.sa_cuda import fma_matmul   # sa_cuda imports this module

    p = x.double()[:, :, None] * w.double()[None]            # exact products
    k = x.shape[1]
    acc = torch.zeros(p.shape[0], p.shape[2], dtype=torch.float32)
    r = (x.abs().double() @ w.abs().double())
    for b0 in range(0, k, 16):
        if b0:
            r = r + acc.double().abs()
        for i in range(b0, min(k, b0 + 16)):
            acc = _chop(acc.double() + p[:, i])
    return acc, fma_matmul(x, w), err_bound(r.to(torch.float32), k)


_MODEL_ARGTYPES = ([cuda_lib.PTR] + [cuda_lib.INT] * 3 + [cuda_lib.PTR, cuda_lib.INT]
                   + [cuda_lib.PTR] * 4)


def model_sums(x: torch.Tensor, w: torch.Tensor):
    """(s_tc, s_k, E), each [rows, cols], of x [rows, k] @ w [k, cols] (bf16
    values, rows a multiple of 16, cols of 8): on a CUDA tensor, the kernel
    csrc/cert_model.cu (launch counter "cert_model"): the tensor cores'
    sum as certified.cuh's cert_mma forms it, the k-order sum of its
    cert_kdot and E from the same product's R register; on a CPU tensor
    the model's own sums (`model_sums_plain`). |s_tc - s_k| <= E on every
    entry is what the certified kernels rest on."""
    if x.device.type == "cpu":
        return model_sums_plain(x, w)
    m, k = x.shape
    n = w.shape[1]
    if m % 16 or n % 8 or w.shape[0] != k or not w.is_cuda:
        raise ValueError(f"model_sums: rows {m} (a multiple of 16), cols {n} (of 8), "
                         f"w {tuple(w.shape)}")
    kp = (k + 15) // 16 * 16
    xb = torch.zeros((m, kp), dtype=torch.bfloat16, device=x.device)
    xb[:, :k] = x
    frag = pack_frags(w, 8)
    out = [torch.empty((m, n), dtype=torch.float32, device=x.device) for _ in range(3)]
    cuda_lib.launch("cert_model", _MODEL_ARGTYPES, xb.data_ptr(), m, kp, k, frag.data_ptr(), n,
                    *[t.data_ptr() for t in out], cuda_lib.stream_ptr(x))
    return tuple(out)


def model_ratio(s_tc: torch.Tensor, s_k: torch.Tensor, err: torch.Tensor) -> float:
    """The largest |s_tc - s_k| / E over the entries (at most 1 where the
    model holds)."""
    return float(((s_tc.double() - s_k.double()).abs() / err.double()).max())
