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
"""

from __future__ import annotations

import torch

COMPUTE_DTYPES = ("float32", "bfloat16")


def check_compute_dtype(compute_dtype: str) -> bool:
    """True for "bfloat16", False for "float32"; raise on anything else."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={compute_dtype!r} is not one of {COMPUTE_DTYPES}")
    return compute_dtype == "bfloat16"


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 (round to nearest even) -> float32."""
    return x.to(torch.bfloat16).to(torch.float32)


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
               round_out: bool = True) -> torch.Tensor:
    """flax.linen.Dense(dtype=bfloat16) on float32 parameters: x, w and b
    rounded to bf16, the product rounded to bf16, then the bias added in
    bf16 (one more rounding). round_out=False: a Dense whose result pcc_tpu
    casts to float32 straight away (`.astype(jnp.float32)` in the same
    jitted program), where XLA keeps the excess precision of the bias add
    and never rounds it: the sum of the two bf16 values in float32."""
    y = round_bf16(round_bf16(x) @ round_bf16(w)) + round_bf16(b)
    return round_bf16(y) if round_out else y


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
