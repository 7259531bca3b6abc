"""Point-set network building blocks (counterpart of pcc_tpu/models/layers.py).

Parameters carry the reference's torch names and shapes (1x1 Conv2d weights
[out, in, 1, 1], 1x1 Conv1d weights [out, in, 1], Linear weights [out, in],
BatchNorm2d parameters and running statistics), so a reference state_dict loads
as it is and pcc_tpu's importer (cli/import_torch_checkpoint.py) reads the
port's. Every layer computes channels-last, as a matmul on
weight.view(out, in): never a cuDNN convolution, which would run float32 in
TF32 by default.

bf16=True is pcc_tpu's bf16 mixed precision, parameters float32: `dense`
follows flax's Dense(dtype=bfloat16) (ops/bf16.py::flax_dense),
`sigmoid_spread` its op-by-op bf16 form.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pcc_tpu_torch.ops.bf16 import (check_compute_dtype, flax_dense, grad_round, max_bf16,
                                    round_bf16, sigmoid_spread_bf16)
from pcc_tpu_torch.ops.knn import knn_points
from pcc_tpu_torch.ops.pppf_sa_cuda import fold_bn
from pcc_tpu_torch.ops.sa_cuda import bf16_wb, sa_fused
from pcc_tpu_torch.parallel.mesh import global_mean, is_distributed


class PointConv(nn.Module):
    """The parameters of a reference 1x1 convolution (weight [out, in, 1, 1]
    for a Conv2d, [out, in, 1] for a Conv1d with conv_dims=1; bias [out],
    or none with bias=False) applied to [..., in] as x @ W + b."""

    def __init__(self, cin: int, cout: int, conv_dims: int = 2, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *([1] * conv_dims)))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def kernel(self) -> torch.Tensor:
        """[in, out] weight matrix (the flax kernel layout), contiguous."""
        cout, cin = self.weight.shape[:2]
        return self.weight.view(cout, cin).t().contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel()
        return y if self.bias is None else y + self.bias


def dense(layer: nn.Module, x: torch.Tensor, bf16: bool = False,
          to_float32: bool = False, x_bf16: bool = True) -> torch.Tensor:
    """A PointConv or nn.Linear (with its bias) on x [..., in]: the layer
    itself in float32; flax's Dense(dtype=bfloat16) rule with bf16
    (x, the kernel and the bias rounded to bf16, the product rounded, then
    the bias added in bf16), bf16-exact float32 out. to_float32: pcc_tpu
    casts this layer's bf16 result to float32 at once, and its last
    rounding does not happen (ops/bf16.py::flax_dense's round_out).
    x_bf16=False: x is a float32 value in pcc_tpu, and its cotangent
    stays float32 (flax_dense's gradient rules)."""
    if not bf16:
        return layer(x)
    w = layer.kernel() if isinstance(layer, PointConv) else layer.weight.t()
    return flax_dense(x, w, layer.bias, round_out=not to_float32, x_bf16=x_bf16)


def mlp_bf16(mlp: "PointwiseMLP", x: torch.Tensor, x_bf16: bool = True,
             to_float32: bool = False) -> torch.Tensor:
    """A PointwiseMLP as pcc_tpu's PointwiseMLP(dtype=bfloat16) computes it:
    every layer on flax's bf16 rule (`dense`), relu where the MLP has one.
    x_bf16: whether pcc_tpu's input is a bf16 value (else float32, its
    cotangent float32); to_float32: the last layer's result cast to float32
    at once."""
    n = len(mlp.mlp_Modules)
    for i, m in enumerate(mlp.mlp_Modules):
        x = dense(m[0], x, True, to_float32=to_float32 and i == n - 1,
                  x_bf16=x_bf16 or i > 0)
        if len(m) > 1:
            x = torch.relu(x)
    return x


def weights_key(tensors) -> tuple:
    """The key of values made from `tensors` and kept: each tensor's storage
    (a move to another device) and, where a tensor has one, its version
    counter (an update in place; inference tensors, made under
    torch.inference_mode, have none)."""
    return tuple((t.data_ptr(), None if t.is_inference() else t._version) for t in tensors)


def torch_dense_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Torch's Linear/Conv default init for every layer of `module`, in
    module order: kernel AND bias from U(-1/sqrt(fan_in), +1/sqrt(fan_in)).

    The nonzero bias is load-bearing (pcc_tpu/models/layers.py::TorchDense):
    at init the quantized latent rounds to all zeros, and with zero biases
    every decoder layer would output exactly 0 with relu'(0) = 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (PointConv, nn.Linear)):
                bound = float(m.weight.shape[1]) ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)


def conv_bn_relu_stack(cin: int, features: Sequence[int]) -> nn.Sequential:
    """The reference's flat Sequential of [Conv2d, BatchNorm2d, ReLU] triples
    (pointnet_sa_module.py:49-56): the conv of layer i at index 3 * i, its
    BatchNorm at 3 * i + 1. The BatchNorm modules hold the parameters and
    running statistics; the stack is evaluated by the fused stage
    (ops/pppf_sa_cuda.py) on `stack_layers`, or layer by layer with
    `batch_norm_train` while the batch statistics train."""
    mods = []
    for f in features:
        mods += [PointConv(cin, f), nn.BatchNorm2d(f), nn.ReLU()]
        cin = f
    return nn.Sequential(*mods)


def stack_layers(stack: nn.Sequential):
    """[(conv, bn)] per layer of a conv_bn_relu_stack."""
    return [(stack[i], stack[i + 1]) for i in range(0, len(stack), 3)]


BN_MOMENTUM = 0.99   # flax.linen.BatchNorm's defaults, which pcc_tpu's PN++ stages use
BN_EPS = 1e-5


def batch_norm_train(h: torch.Tensor, bn: nn.BatchNorm2d, bf16: bool = False) -> torch.Tensor:
    """BatchNorm of h [..., C] with its batch statistics, as
    flax.linen.BatchNorm computes it in training (pcc_tpu's PN++ stages,
    BN_MOMENTUM and BN_EPS): the mean and the fast
    variance mean(h^2) - mean^2, clamped at 0, over every axis but the last;
    then (h - mean) * (rsqrt(var + eps) * scale) + bias. Updates bn's running
    statistics in place, running = BN_MOMENTUM * running + (1 - BN_MOMENTUM)
    * batch, with the biased variance. (nn.BatchNorm2d in training would use
    torch's momentum 0.1 and the unbiased variance.) In a process group
    (parallel/mesh.py) the batch is the global one, as under pcc_tpu's SPMD
    partitioner: both means are averaged over the ranks, whose shards are
    equal in size, with the gradient flowing through the collective (not
    nn.SyncBatchNorm, which is torch's BatchNorm).

    bf16: flax's BatchNorm(dtype=bfloat16) on a bf16 h: the same float32
    arithmetic on h promoted to float32 (force_float32_reductions), the
    output rounded once to bf16; the running statistics float32. Its
    gradient rounds where XLA's does (ops/bf16.py): h's two uses, the
    statistics and the centring, each pass a cotangent rounded to bf16,
    and their sum is rounded again."""
    hc = h
    if bf16:
        h = grad_round(h)
        h, hc = grad_round(h), grad_round(h)
    dims = tuple(range(h.dim() - 1))
    mean, sq = h.mean(dim=dims), (h * h).mean(dim=dims)
    if is_distributed():
        mean, sq = global_mean(torch.stack([mean, sq]))
    # jnp.maximum(0, .): a variance of exactly 0 (a channel constant over
    # the batch) passes half its gradient, as flax's does
    var = torch.maximum(sq - mean * mean, h.new_zeros(()))
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
    y = (hc - mean) * (torch.rsqrt(var + BN_EPS) * bn.weight) + bn.bias
    return round_bf16(y) if bf16 else y


def batch_norm_eval(h: torch.Tensor, bn: nn.BatchNorm2d, bf16: bool = False) -> torch.Tensor:
    """BatchNorm of h [..., C] at bn's running statistics, as
    flax.linen.BatchNorm(use_running_average=True) computes it: (h - mean)
    * (rsqrt(var + eps) * scale) + bias in float32 (ops/pppf_sa_cuda.py::
    fold_bn's terms, which the fused stage takes too). The running
    statistics are read, never updated. bf16: BatchNorm(dtype=bfloat16) on
    a bf16 Dense result: h enters unrounded, as in training (XLA keeps the
    bias add's excess precision where h goes straight into the float32
    normalization: `dense(..., to_float32=True)`), the arithmetic is the
    same float32 with the parameters and statistics float32
    (force_float32_reductions), and the output is rounded once to bf16."""
    mean, mul, bias = fold_bn(bn)
    y = (h - mean) * mul + bias
    return round_bf16(y) if bf16 else y


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Straight-through rounding: round forward, identity gradient
    (reference STEQuantize, AE.py:72-85)."""
    return x + (torch.round(x) - x).detach()


def sigmoid_spread(latent: torch.Tensor, L: int, bf16: bool = False) -> torch.Tensor:
    """Squash the latent into the quantizer's range [-(L-0.2)/2, +(L-0.2)/2]
    (reference AE.py:42-44). bf16: pcc_tpu's sigmoid_spread on a bf16
    array, every operation rounded (ops/bf16.py::sigmoid_spread_bf16)."""
    if bf16:
        return sigmoid_spread_bf16(latent, L)
    spread = L - 0.2
    return torch.sigmoid(latent) * spread - spread / 2


class PointwiseMLP(nn.Module):
    """Per-point MLP [..., cin] -> [..., features[-1]] with the reference
    MLP's module tree (pn_kit.py:263-305): mlp_Modules.{i} = Sequential(
    conv[, ReLU])."""

    def __init__(self, cin: int, features: Sequence[int],
                 relu: Sequence[bool] | None = None):
        super().__init__()
        relu = list(relu) if relu is not None else [True] * len(features)
        self.mlp_Modules = nn.ModuleList()
        for f, r in zip(features, relu):
            layers = [PointConv(cin, f)] + ([nn.ReLU()] if r else [])
            self.mlp_Modules.append(nn.Sequential(*layers))
            cin = f

    def layers(self):
        """[([in, out] kernel, bias)] per layer, for the fused kernels."""
        return [(m[0].kernel(), m[0].bias) for m in self.mlp_Modules]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.mlp_Modules:
            x = m(x)
        return x


class PointNetFeat(PointwiseMLP):
    """Pointwise MLP + max over points: [B, N, C] -> [B, D] (reference
    PointNet, pn_kit.py:98-144)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).amax(dim=-2)


class SetAbstraction(nn.Module):
    """Per-point local features by KNN grouping (reference SetAbstraction
    with npoint == N, pn_kit.py:146-211): for every point, its knn nearest
    neighbours in the patch, centred, through a 3-layer MLP with relu, max
    over neighbours. [B, N, 3] -> [B, N, mlp[-1]].

    fused=True evaluates a 3-D input with ops/sa_cuda.py::sa_fused (the
    CUDA kernel on the card, its plain version on the CPU), as pcc_tpu's
    fused flag routes it to its Pallas kernel: inference only, no
    backward. The state_dict is the same either way.

    compute_dtype "bfloat16" is pcc_tpu's SetAbstraction(dtype=bfloat16),
    parameters float32, and its fused flag changes the result: fused=True
    runs sa_fused's bf16 instance (_sa_kernel's rounding: every weight and
    bias, the centred neighbours and each layer's relu output, products and
    bias adds float32) on the weights rounded once (`fused_weights`);
    fused=False runs flax's bf16 Dense rule layer by layer (`dense`: the
    product and the bias add each rounded), as pcc_tpu's
    PointwiseMLP(dtype=bfloat16) computes it, then the max. Either way the
    output holds bf16 values as float32 (pcc_tpu's module returns them as a
    bf16 array), as `dense` gives them."""

    def __init__(self, knn: int = 16, mlp: Sequence[int] = (32, 64, 128),
                 fused: bool = False, compute_dtype: str = "float32"):
        super().__init__()
        self.knn = knn
        self.fused = fused
        self.bf16 = check_compute_dtype(compute_dtype)
        cin = 3
        for i, f in enumerate(mlp):
            self.add_module(f"conv{i}", PointConv(cin, f))
            cin = f
        self.n_layers = len(mlp)
        # the bf16 kernel's rounded weights, made once per weights in eval
        # mode (fused_weights)
        self._cache = None
        self.register_load_state_dict_post_hook(SetAbstraction._drop_cache)

    def _drop_cache(self, *_) -> None:
        self._cache = None

    def train(self, mode: bool = True):
        self._drop_cache()
        return super().train(mode)

    def convs(self):
        return [getattr(self, f"conv{i}") for i in range(self.n_layers)]

    def layers(self):
        """[([in, out] kernel, bias)] per layer, for the fused kernels."""
        return [(c.kernel(), c.bias) for c in self.convs()]

    def fused_weights(self):
        """The fused kernel's ([in, out] weight, bias) pairs: `layers`; in
        bf16 rounded to bf16 (ops/sa_cuda.py::bf16_wb), in eval mode once
        per weights."""
        if not self.bf16:
            return self.layers()
        key = weights_key(list(self.parameters()))
        if self._cache is not None and self._cache[0] == key:
            return self._cache[1]
        with torch.no_grad():
            weights = bf16_wb(self.layers())
        if not self.training:
            self._cache = (key, weights)
        return weights

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        if self.fused and xyz.dim() == 3:
            return sa_fused(xyz, self.fused_weights(), self.knn, self.bf16)
        _, _, grouped = knn_points(xyz, xyz, K=self.knn, return_nn=True)
        x = grouped - xyz[..., None, :]                     # [B, N, knn, 3]
        for i, c in enumerate(self.convs()):
            # in bf16 the centred neighbours are a float32 value
            x = torch.relu(dense(c, x, self.bf16, x_bf16=i > 0))
        return max_bf16(x, -2) if self.bf16 else x.amax(dim=-2)
