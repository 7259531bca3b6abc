"""bf16 mixed precision as pcc_tpu computes it (compute_dtype "bfloat16").

pcc_tpu rounds to bf16 at fixed points, and the points differ by module:
its Pallas kernels take bf16 operands, a float32 product and sum and round
once (`kernel_dense`); flax's Dense(dtype=bfloat16) rounds the product to
bf16 and then adds the bias in bf16 (`flax_dense`); jnp arithmetic on a bf16
array rounds after every operation, with Python constants first rounded to
bf16 (`sigmoid_spread_bf16`); a bf16 result cast to float32 in the same
jitted program is not rounded at all (XLA's excess precision, `flax_dense`'s
round_out). The port keeps each module's points. The
values stay float32 tensors that are bf16-exact: a product of two is exact
in float32, so a float32 product of rounded operands is the sum of exact
products, as pcc_tpu's float32 accumulator sums them, up to the order of
the sum. No bf16 GEMM runs (cuBLAS may reduce a bf16 product in reduced
precision), and TF32 is off (device.py).

Gradients (bf16 training, flax's Dense; the encoder's kernels have their
own rules, ops/sa_cuda.py). In JAX the cotangent of a bf16 array is a bf16
array, and XLA drops a rounding where a float32 value goes to bf16 and
straight back (its excess precision, as in the forward). `round_bf16`'s
own backward in PyTorch, x.to(bfloat16).to(float32), rounds the cotangent
to bf16: the rule for the cotangent of a bf16 value. So, as measured
against jax.grad of flax's Dense(dtype=bfloat16) on XLA's CPU backend,
`flax_dense` differentiates with
  * the output's cotangent g rounded to bf16, also where the output is cast
    to float32 at once (round_out=False: `grad_round`);
  * dW = round(round(x).T @ g), a float32 product rounded once;
  * db = the sum of g over the rows as a bf16 reduction, every add rounded
    to bf16 (`bf16_reduce`: XLA's reduction of a bf16 array, in the order
    its CPU backend takes, which is what the tests hold pcc_tpu to);
  * dx = g @ round(W).T, rounded to bf16 (the cotangent of the bf16 value
    that the Dense takes), but where x is a float32 value that goes
    straight into the Dense (`round_keep_grad`: the decoder's latent), XLA
    drops that rounding and dx stays float32. (A float32 concat before the
    Dense, the decoder's fold and tiled latent, keeps it.)
Every gradient of these rules is XLA's bit for bit up to the order of a
float32 sum (tests/test_torch_port_train_bf16.py).

The PN++ families' bf16 training (PPPF-AE's encoder and PPPE's stages on
batch statistics) adds three rules, read off jax.grad of bare flax modules
and jnp ops in jitted programs on XLA's CPU backend:
  * a max over an axis of bf16 values (`max_bf16`: jnp.max's gradient,
    JAX's reduce-chooser rule): the cotangent split equally among the
    elements that reach the maximum, round(round(g) / count), each tie
    getting that share (ties are common in bf16);
  * the gather of bf16 rows by index (`gather_bf16`: index_points /
    knn_gather): its transpose is a bf16 scatter-add, which XLA runs
    update by update in the index array's order, each add rounded to bf16;
  * BatchNorm(dtype=bfloat16) in training (models/layers.py::
    batch_norm_train(..., bf16=True)): the input enters twice, promoted
    to float32 for the statistics and for the centring; each promotion's
    transpose rounds its cotangent to bf16, and the two add in bf16.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pcc_tpu_torch.ops import cuda_lib

COMPUTE_DTYPES = ("float32", "bfloat16")


def check_compute_dtype(compute_dtype: str) -> bool:
    """True for "bfloat16", False for "float32"; raise on anything else."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={compute_dtype!r} is not one of {COMPUTE_DTYPES}")
    return compute_dtype == "bfloat16"


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 (round to nearest even) -> float32."""
    return x.to(torch.bfloat16).to(torch.float32)


class _RoundKeepGrad(torch.autograd.Function):
    """round_bf16 forward, the cotangent passed on unrounded."""

    @staticmethod
    def forward(ctx, x):
        return round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradRound(torch.autograd.Function):
    """Identity forward, the cotangent rounded to bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_bf16(g)


XLA_WINDOW = 32   # the window XLA's CPU backend cuts a long reduction into
GRID_DIMS = 3     # reduced dimensions a grid of rows may have
_REDUCE_ARGTYPES = ([cuda_lib.PTR] * 5 + [ctypes.c_longlong] * 3 + [cuda_lib.INT] * 2
                    + [ctypes.c_longlong] * 2 + [cuda_lib.PTR])


def _reduce_level(dims) -> tuple:
    """One level of XLA's bf16 reduction of a grid of rows `dims` (each a
    reduced dimension): per dimension (w, p, n), windows of w rows (a
    dimension of at most XLA_WINDOW rows whole, else windows of
    XLA_WINDOW), p zero rows padded before it (the odd one after), n
    windows. A grid whose every dimension is at most XLA_WINDOW is one
    window."""
    out = []
    for d in dims:
        w = d if d <= XLA_WINDOW else XLA_WINDOW
        n = -(-d // w)
        out.append((w, (n * w - d) // 2, n))
    return tuple(out)


def bf16_reduce_plain(g: torch.Tensor, cols: int = 1) -> torch.Tensor:
    """g [d1, ..., dk, c1, ..., c_cols] -> [C] (C the columns' product):
    the sum over the grid of rows [d1, ..., dk] of g rounded to bf16, as
    XLA's CPU backend reduces a bf16 array (the order that the tests hold
    pcc_tpu's step to; measured on XLA's HLO): each window of
    `_reduce_level` summed in row-major order from 0, every add in float32
    rounded to bf16, the windows' sums reduced the same way, level after
    level, down to one row. csrc/bf16_reduce.cu computes every level in one
    launch."""
    g = round_bf16(g.reshape(*g.shape[:g.dim() - cols], -1))
    while g[..., 0].numel() > 1:
        dims, C = g.shape[:-1], g.shape[-1]
        lev = _reduce_level(dims)
        pad = []
        for d, (w, p, n) in reversed(list(zip(dims, lev))):
            pad += [p, n * w - d - p]
        g = torch.nn.functional.pad(g, [0, 0] + pad)
        g = g.reshape(*[x for w, p, n in lev for x in (n, w)], C)
        k = len(dims)
        g = g.permute(*range(0, 2 * k, 2), *range(1, 2 * k, 2), 2 * k)
        g = g.reshape(*[n for w, p, n in lev], -1, C)
        acc = g.new_zeros(g.shape[:-2] + (C,))
        for i in range(g.shape[-2]):
            acc = round_bf16(acc + g[..., i, :])
        g = acc
    return g.reshape(-1)


@functools.lru_cache(maxsize=256)
def _reduce_plan(grid: tuple) -> tuple:
    """The kernel's plan of a grid of GRID_DIMS dimensions: (its ints as
    csrc/bf16_reduce.cu reads them, a ctypes array; the scratch rows, every
    level's window count but the last's, summed)."""
    plan, sizes, dims = [0], [], grid
    while True:
        lev = _reduce_level(dims)
        plan += [*dims, *[w for w, p, n in lev], *[p for w, p, n in lev],
                 *[n for w, p, n in lev]]
        plan[0] += 1
        dims = tuple(n for w, p, n in lev)
        if math.prod(dims) == 1:
            break
        sizes.append(math.prod(dims))
    return (ctypes.c_int * len(plan))(*plan), sum(sizes)


REDUCE_COLS = 32      # columns a block of csrc/bf16_reduce.cu takes, a ticket each
_TICKETS: dict = {}   # device -> the kernel's tickets, 0 between calls


def bf16_reduce(g: torch.Tensor, cols: int = 1) -> torch.Tensor:
    """bf16_reduce_plain of g [d1, ..., dk, c1, ..., c_cols] (k at most
    GRID_DIMS, cols 1 or 2), float32 in any layout (a permuted view as it
    is), not yet rounded: the CUDA kernel csrc/bf16_reduce.cu on a CUDA
    tensor (one launch a call, launch counter "bf16_reduce"), the plain
    version on a CPU tensor."""
    if g.device.type == "cpu":
        return bf16_reduce_plain(g, cols)
    k = g.dim() - cols
    if cols not in (1, 2) or not 1 <= k <= GRID_DIMS:
        raise ValueError(f"bf16_reduce: {k} reduced dimensions (1 to {GRID_DIMS}) and {cols} "
                         "column dimensions (1 or 2)")
    if not g.is_cuda or g.dtype != torch.float32:
        raise ValueError(f"bf16_reduce: expected a float32 CUDA tensor, got {g.dtype} on "
                         f"{g.device}")
    pad = GRID_DIMS - k
    grid = (1,) * pad + tuple(g.shape[:k])
    rs = (0,) * pad + tuple(g.stride()[:k])
    c1, c0 = ((1, g.shape[-1]) if cols == 1 else tuple(g.shape[-2:]))
    sc1, sc0 = ((0, g.stride(-1)) if cols == 1 else tuple(g.stride()[-2:]))
    plan, scratch = _reduce_plan(grid)
    C = c1 * c0
    buf = torch.empty(C + scratch * C, dtype=torch.float32, device=g.device)
    tickets = _TICKETS.get(g.device)
    if tickets is None or tickets.numel() < -(-C // REDUCE_COLS):
        tickets = _TICKETS[g.device] = torch.zeros(-(-C // REDUCE_COLS), dtype=torch.int32,
                                                   device=g.device)
    cuda_lib.launch("bf16_reduce", _REDUCE_ARGTYPES, g.data_ptr(), buf.data_ptr(),
                    buf.data_ptr() + 4 * C, tickets.data_ptr(), ctypes.addressof(plan), *rs,
                    c1, c0, sc1, sc0, cuda_lib.stream_ptr(g))
    return buf[:C]


class _BiasAddBf16(torch.autograd.Function):
    """y + round_bf16(b) (both bf16 values); b's gradient the bf16
    reduction of the cotangent, rounded, over y's rows (bf16_reduce)."""

    @staticmethod
    def forward(ctx, y, b):
        return y + round_bf16(b)

    @staticmethod
    def backward(ctx, g):
        return g, bf16_reduce(g)


class _TileBf16(torch.autograd.Function):
    """x [B, C] tiled to [B, n, C]; the cotangent summed over the n copies
    as a bf16 reduction (bf16_reduce over the n rows of each of the B x C
    columns, read through the permuted view)."""

    @staticmethod
    def forward(ctx, x, n):
        return x[:, None, :].expand(x.shape[0], n, x.shape[1])

    @staticmethod
    def backward(ctx, g):
        B, n, C = g.shape
        return bf16_reduce(g.permute(1, 0, 2), cols=2).reshape(B, C), None


def tile_bf16(x: torch.Tensor, n: int) -> torch.Tensor:
    """A bf16 feature [B, C] repeated over n points ([B, n, C], jnp.repeat
    in pcc_tpu), its cotangent the bf16 reduction of the copies'."""
    return _TileBf16.apply(x, n)


def round_keep_grad(x: torch.Tensor) -> torch.Tensor:
    """A float32 value rounded to bf16 as a bf16 op takes it, its
    cotangent kept float32 (XLA's excess precision drops that rounding)."""
    return _RoundKeepGrad.apply(x)


def grad_round(x: torch.Tensor) -> torch.Tensor:
    """x as it is, its cotangent rounded to bf16: a bf16 value whose
    cotangent PyTorch would otherwise sum or scale in float32 (a bf16
    output cast to float32 at once, a bf16 feature tiled over points, a bf16
    max)."""
    return _GradRound.apply(x)


def kernel_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                 relu: bool) -> torch.Tensor:
    """One dense layer as pcc_tpu's bf16 Pallas kernels compute it: bf16
    operands x and w, their float32 product, + b (float32, rounded or not
    by the caller as the kernel rounds it), relu where asked, one rounding
    to bf16."""
    h = round_bf16(x) @ round_bf16(w)
    if b is not None:
        h = h + b
    return round_bf16(torch.relu(h) if relu else h)


def flax_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
               round_out: bool = True, x_bf16: bool = True) -> torch.Tensor:
    """flax.linen.Dense(dtype=bfloat16) on float32 parameters: x, w and b
    rounded to bf16, the product rounded to bf16, then the bias added in
    bf16 (one more rounding). round_out=False: a Dense whose result pcc_tpu
    casts to float32 straight away (`.astype(jnp.float32)` in the same
    jitted program), where XLA keeps the excess precision of the bias add
    and never rounds it: the sum of the two bf16 values in float32.
    Differentiable with the module docstring's rules; x_bf16=False: x is a
    float32 value, whose cotangent stays float32. b None: a Dense without
    bias, its rounded product, whose rounding is then the last: with
    round_out=False (PPPE's bias-free gc0 into its bf16 BatchNorm) XLA
    keeps the product unrounded too."""
    xr = round_bf16(x) if x_bf16 else round_keep_grad(x)
    y = xr @ round_bf16(w)
    if b is not None:
        y = _BiasAddBf16.apply(round_bf16(y), b)
    return round_bf16(y) if round_out else grad_round(y)


class _SigmoidSpreadBf16(torch.autograd.Function):
    """sigmoid_spread_bf16's forward, with XLA's bf16 gradient: the
    cotangent g (a bf16 value) times the rounded spread constant, rounded,
    times jax.nn.sigmoid's derivative s * (1 - s) taken in bf16 (JAX's
    logistic rule: 1 - s rounded, times s rounded), rounded."""

    @staticmethod
    def forward(ctx, latent, L):
        spread = L - 0.2
        c_mul = round_bf16(torch.tensor(spread, dtype=torch.float32)).to(latent.device)
        c_sub = round_bf16(torch.tensor(spread / 2, dtype=torch.float32)).to(latent.device)
        x = round_bf16(latent)
        s = round_bf16(1.0 / round_bf16(1.0 + round_bf16(torch.exp(-x))))
        ctx.save_for_backward(s, c_mul)
        return round_bf16(round_bf16(s * c_mul) - c_sub)

    @staticmethod
    def backward(ctx, g):
        s, c_mul = ctx.saved_tensors
        gs = round_bf16(round_bf16(g) * c_mul)
        return round_bf16(gs * round_bf16(s * round_bf16(1.0 - s))), None


def sigmoid_spread_bf16(latent: torch.Tensor, L: int) -> torch.Tensor:
    """pcc_tpu's sigmoid_spread (models/layers.py) on a bf16 array, op by op:
    jax.nn.sigmoid rounds exp(-x), 1 + that and its reciprocal to bf16 in
    turn, and the spread's Python constants L - 0.2 and (L - 0.2) / 2 round
    to bf16 before they apply (6.8 -> 6.8125 and 3.4 -> 3.40625 at L = 7).
    latent: bf16-exact float32 values -> bf16-exact float32 values; the
    gradient is XLA's (`_SigmoidSpreadBf16`)."""
    return _SigmoidSpreadBf16.apply(latent, L)


class _MaxBf16(torch.autograd.Function):
    """x.amax(dim) of bf16 values, with jnp.max's gradient in bf16."""

    @staticmethod
    def forward(ctx, x, dim):
        m = x.amax(dim=dim, keepdim=True)
        ctx.save_for_backward(x, m)
        ctx.dim = dim
        return m.squeeze(dim)

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        hit = x == m
        count = hit.sum(dim=ctx.dim, keepdim=True).to(x.dtype)
        share = round_bf16(round_bf16(g.unsqueeze(ctx.dim)) / count)
        return torch.where(hit, share, torch.zeros((), dtype=x.dtype, device=x.device)), None


def max_bf16(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The max over `dim` of bf16 values (bf16-exact float32), its cotangent
    split as jnp.max's: round(round(g) / count) to each element that
    reaches the maximum, 0 elsewhere."""
    return _MaxBf16.apply(x, dim)


def bf16_scatter_add(upd: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """upd [B, R, C] added into [B, n, C] at rows idx [B, R], as XLA's CPU
    backend runs a bf16 scatter-add: update by update in the order of R,
    each add rounded to bf16. Vectorized by rank: the r-th update of a row
    is added in pass r, every row at most once a pass."""
    B, R, C = upd.shape
    key = (idx.long() + n * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
    order = torch.sort(key, stable=True).indices
    skey = key[order]
    start = torch.ones_like(skey, dtype=torch.bool)
    start[1:] = skey[1:] != skey[:-1]
    first = torch.cummax(torch.where(start, torch.arange(len(skey), device=key.device), 0),
                         0).values
    rank = torch.empty_like(key)
    rank[order] = torch.arange(len(skey), device=key.device) - first
    u = round_bf16(upd).reshape(B * R, C)
    acc = upd.new_zeros((B * n, C))
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        take = rank == r
        rows = key[take]
        acc[rows] = round_bf16(acc[rows] + u[take])
    return acc.reshape(B, n, C)


class _GatherBf16(torch.autograd.Function):
    """rows [B, n, C] gathered at idx [B, ...], the transpose a bf16
    scatter-add in index order."""

    @staticmethod
    def forward(ctx, rows, idx):
        ctx.save_for_backward(idx)
        ctx.n = rows.shape[1]
        flat = idx.reshape(idx.shape[0], -1).long()
        out = torch.gather(rows, 1, flat[..., None].expand(-1, -1, rows.shape[-1]))
        return out.reshape(*idx.shape, rows.shape[-1])

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, C = idx.shape[0], g.shape[-1]
        return bf16_scatter_add(g.reshape(B, -1, C), idx.reshape(B, -1), ctx.n), None


def gather_bf16(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows [B, n, C] of bf16 values at idx [B, ...] -> [B, ..., C]
    (pcc_tpu's index_points / knn_gather on a bf16 array), the cotangent
    summed back as XLA sums a bf16 scatter-add (`bf16_scatter_add`)."""
    return _GatherBf16.apply(rows, idx)
