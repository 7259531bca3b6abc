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
"""

from __future__ import annotations

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
_REDUCE_ARGTYPES = [cuda_lib.PTR, cuda_lib.PTR] + [cuda_lib.INT] * 9 + [cuda_lib.PTR]


def _reduce_level(A: int, K: int) -> tuple:
    """One level of XLA's bf16 reduction of an [A, K] grid of rows: (wa, wk,
    pa, pk, A2, K2), windows of wa x wk rows (a dimension of at most
    XLA_WINDOW rows whole, else windows of XLA_WINDOW), pa / pk zero rows
    padded before each dimension (the odd one after), A2 x K2 windows. A
    grid of at most XLA_WINDOW x XLA_WINDOW is one window."""
    wa = A if A <= XLA_WINDOW else XLA_WINDOW
    wk = K if K <= XLA_WINDOW else XLA_WINDOW
    A2, K2 = -(-A // wa), -(-K // wk)
    return wa, wk, (A2 * wa - A) // 2, (K2 * wk - K) // 2, A2, K2


def bf16_reduce_plain(g: torch.Tensor) -> torch.Tensor:
    """g [A, K, C] bf16 values -> [C]: the sum over the [A, K] grid of rows
    as XLA's CPU backend reduces a bf16 array (the order that the tests
    hold pcc_tpu's step to; measured on XLA's HLO): each window of
    `_reduce_level` summed in row-major order from 0, every add in float32
    rounded to bf16, the windows' sums reduced the same way, level after
    level, down to one row. csrc/bf16_reduce.cu computes each level."""
    while g.shape[0] * g.shape[1] > 1:
        A, K, C = g.shape
        wa, wk, pa, pk, A2, K2 = _reduce_level(A, K)
        g = torch.nn.functional.pad(g, (0, 0, pk, K2 * wk - K - pk, pa, A2 * wa - A - pa))
        g = g.reshape(A2, wa, K2, wk, C).permute(0, 2, 1, 3, 4).reshape(A2, K2, wa * wk, C)
        acc = g.new_zeros((A2, K2, C))
        for i in range(wa * wk):
            acc = round_bf16(acc + g[:, :, i])
        g = acc
    return g.reshape(-1)


def bf16_reduce(g: torch.Tensor) -> torch.Tensor:
    """bf16_reduce_plain: the CUDA kernel csrc/bf16_reduce.cu (one launch a
    level, launch counter "bf16_reduce") on a CUDA tensor, the plain version
    on a CPU tensor."""
    if g.device.type == "cpu":
        return bf16_reduce_plain(g)
    cuda_lib.require_cuda("bf16_reduce", g, torch.float32, 3)
    while g.shape[0] * g.shape[1] > 1:
        A, K, C = g.shape
        wa, wk, pa, pk, A2, K2 = _reduce_level(A, K)
        out = torch.empty((A2, K2, C), dtype=torch.float32, device=g.device)
        cuda_lib.launch("bf16_reduce", _REDUCE_ARGTYPES, g.data_ptr(), out.data_ptr(), A, K, C,
                        wa, wk, pa, pk, A2, K2, cuda_lib.stream_ptr(g))
        g = out
    return g.reshape(-1)


def _grid(g: torch.Tensor) -> torch.Tensor:
    """A cotangent [rows, C] or [A, K, C] as the [A, K, C] grid of rows that
    its bias gradient reduces ([rows, C] as the grid [1, rows])."""
    if g.dim() not in (2, 3):
        raise ValueError(f"bf16 bias gradient of a {g.dim()}-d output")
    return (g.reshape(1, *g.shape) if g.dim() == 2 else g).contiguous()


class _BiasAddBf16(torch.autograd.Function):
    """y + round_bf16(b) (both bf16 values); b's gradient the bf16
    reduction of the rounded cotangent over y's rows (bf16_reduce)."""

    @staticmethod
    def forward(ctx, y, b):
        return y + round_bf16(b)

    @staticmethod
    def backward(ctx, g):
        return g, bf16_reduce(_grid(round_bf16(g)))


class _TileBf16(torch.autograd.Function):
    """x [B, C] tiled to [B, n, C]; the cotangent summed over the n copies
    as a bf16 reduction (bf16_reduce over the grid [1, n] of each column)."""

    @staticmethod
    def forward(ctx, x, n):
        return x[:, None, :].expand(x.shape[0], n, x.shape[1])

    @staticmethod
    def backward(ctx, g):
        B, n, C = g.shape
        rows = round_bf16(g).permute(1, 0, 2).reshape(1, n, B * C)
        return bf16_reduce(rows.contiguous()).reshape(B, C), None


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


def flax_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               round_out: bool = True, x_bf16: bool = True) -> torch.Tensor:
    """flax.linen.Dense(dtype=bfloat16) on float32 parameters: x, w and b
    rounded to bf16, the product rounded to bf16, then the bias added in
    bf16 (one more rounding). round_out=False: a Dense whose result pcc_tpu
    casts to float32 straight away (`.astype(jnp.float32)` in the same
    jitted program), where XLA keeps the excess precision of the bias add
    and never rounds it: the sum of the two bf16 values in float32.
    Differentiable with the module docstring's rules; x_bf16=False: x is a
    float32 value, whose cotangent stays float32."""
    xr = round_bf16(x) if x_bf16 else round_keep_grad(x)
    y = _BiasAddBf16.apply(round_bf16(xr @ round_bf16(w)), b)
    return round_bf16(y) if round_out else grad_round(y)


def sigmoid_spread_bf16(latent: torch.Tensor, L: int) -> torch.Tensor:
    """pcc_tpu's sigmoid_spread (models/layers.py) on a bf16 array, op by op:
    jax.nn.sigmoid rounds exp(-x), 1 + that and its reciprocal to bf16 in
    turn, and the spread's Python constants L - 0.2 and (L - 0.2) / 2 round
    to bf16 before they apply (6.8 -> 6.8125 and 3.4 -> 3.40625 at L = 7).
    latent: bf16-exact float32 values -> bf16-exact float32 values."""
    spread = L - 0.2
    c_mul = round_bf16(torch.tensor(spread, dtype=torch.float32))
    c_sub = round_bf16(torch.tensor(spread / 2, dtype=torch.float32))
    x = round_bf16(latent)
    s = round_bf16(1.0 / round_bf16(1.0 + round_bf16(torch.exp(-x))))
    return round_bf16(round_bf16(s * c_mul.to(x.device)) - c_sub.to(x.device))
