"""PPPF-AE: PointNet++ encoder + FoldingNet decoder patch autoencoder, and
its conditional probability model (counterpart of pcc_tpu/models/pppf.py;
reference PPPF_AE.py + pointnet_sa_module.py).

Same graph, stage configuration (PPPF_AE.py:29-37,115-126) and state_dict
names as the reference: `encoder.sa{j}.mlp.{3i}` conv, `.{3i+1}` BatchNorm,
`decoder.mlp1/mlp2.{0,2,4}` Conv1d, `enc_proj`, `dec_proj`;
`model_pnpp.sa{j}.mlp.*`, `model_mlp.{0,2,4}`. A set-abstraction stage's
internal FPS is ops/fps.py::fps_batch. Its BatchNorm follows the module's
mode:
  * eval: frozen at the running statistics (pcc_tpu's train=False and its
    fused_train stage): the fused stage of ops/pppf_sa_cuda.py, the CUDA
    kernel on the card and its plain version on the CPU, differentiable
    through the backward kernel (pppf_sa_trainable);
  * train: batch statistics with flax's semantics, running statistics
    updated (pcc_tpu's XLA path with train=True): ball query, gather and
    the stack as plain products (layers.batch_norm_train).

compute_dtype "bfloat16" (pcc_tpu's PPPF_AE(dtype=bfloat16); parameters
float32; the modules below it take bf16=True). A stage's BatchNorm follows
the module's mode as in float32:
  * eval (pcc_tpu's fused stage, and its fused_train stage in training):
    the stage kernel's bf16 instance, in serving on the rounded weights it
    keeps (PointnetSAModule.bf16_layers), where a gradient is taken through
    pppf_sa_trainable(bf16=True) (the bf16 store mode and the bf16 stage
    backward kernel) on weights rounded per call; the features cast to
    float32 before the stage and the output back to bf16, so that both
    cotangents are rounded to bf16 there (pcc_tpu/models/pppf.py:75, 79);
  * train (pcc_tpu's XLA stage on batch statistics, pppf.py:80-90): the
    ball query and gather (the bf16 features' transpose a bf16 scatter-add,
    ops/bf16.py::gather_bf16), each layer flax's bf16 Dense, its result
    going unrounded into flax's bf16 BatchNorm (layers.batch_norm_train),
    relu, and the max over samples with jnp.max's gradient (max_bf16).
Then the global max (max_bf16), sigmoid_spread in bf16 and enc_proj on
flax's bf16 rule, then a cast to float32; the quantizer float32
(pppf.py:185-189); dec_proj and FoldingNet on flax's rule, the tiled latent
a bf16 value whose cotangent sums over its copies in bf16 (tile_bf16), the
grid and the latent rounded before mlp1 (pppf.py:131-160), the output
float32. In training every Dense follows flax's gradient rules
(ops/bf16.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from pcc_tpu_torch.models.layers import (PointConv, batch_norm_train, conv_bn_relu_stack, dense,
                                         sigmoid_spread, stack_layers, ste_round, weights_key)
from pcc_tpu_torch.ops.bf16 import (check_compute_dtype, gather_bf16, grad_round, max_bf16,
                                    tile_bf16)
from pcc_tpu_torch.ops.fps import fps_batch
from pcc_tpu_torch.ops.knn import ball_query, knn_gather
from pcc_tpu_torch.ops.pppf_sa_cuda import (bf16_layers, fold_bn, pppf_sa_fused,
                                            pppf_sa_trainable)


def _needs_grad(module: nn.Module, *tensors) -> bool:
    """Whether autograd will take a gradient through `module` on `tensors`."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in [*tensors, *module.parameters()])


class PointnetSAModule(nn.Module):
    """Canonical PN++ set abstraction: FPS -> ball query -> group(+xyz) ->
    Conv+BN+ReLU stack -> max over samples (pointnet_sa_module.py:38-93).
    [B, N, 3] xyz (+ optional [B, N, C] features) ->
    ([B, npoint, 3], [B, npoint, mlp[-1]])."""

    def __init__(self, npoint: int, radius: float, nsample: int, cin: int,
                 mlp: Sequence[int], bf16: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.bf16 = bf16
        self.mlp = conv_bn_relu_stack(cin, mlp)
        self._bf16_cache = None

    def layers(self):
        """[(W [in, out], b, mean, mul, bias)] per layer, BatchNorm folded;
        differentiable in W, b and BatchNorm's scale and bias."""
        return [(conv.kernel(), conv.bias, *fold_bn(bn)) for conv, bn in
                stack_layers(self.mlp)]

    def bf16_layers(self):
        """layers() with each W rounded to bf16, the bf16 stage's operands
        (ops/pppf_sa_cuda.py::bf16_layers), made once per weights and
        running statistics, for serving (a trained stage rounds its weights
        per call, inside pppf_sa_trainable)."""
        key = weights_key([*self.parameters(), *self.buffers()])
        if self._bf16_cache is None or self._bf16_cache[0] != key:
            with torch.no_grad():
                self._bf16_cache = (key, bf16_layers(self.layers()))
        return self._bf16_cache[1]

    def queries(self, xyz: torch.Tensor) -> torch.Tensor:
        """The stage's query centroids [B, npoint, 3]: the points themselves
        when npoint == N, else FPS from index 0."""
        if self.npoint == xyz.shape[1]:
            return xyz
        idx = fps_batch(xyz, self.npoint, torch.zeros(
            xyz.shape[0], dtype=torch.int32, device=xyz.device))
        return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3))

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None = None):
        xyz = xyz.contiguous()
        new_xyz = self.queries(xyz)
        feat = None if features is None else features.contiguous()
        kw = dict(nsample=self.nsample, radius=self.radius)
        if self.bf16 and not self.training:
            if not _needs_grad(self, xyz, feat):
                return new_xyz, pppf_sa_fused(new_xyz, xyz, feat, self.bf16_layers(), bf16=True,
                                              **kw)
            # the casts around pcc_tpu's stage round both cotangents to bf16
            out = pppf_sa_trainable(new_xyz, xyz, None if feat is None else grad_round(feat),
                                    self.layers(), bf16=True, **kw)
            return new_xyz, grad_round(out)
        if not self.training:
            return new_xyz, pppf_sa_trainable(new_xyz, xyz, feat, self.layers(), **kw)
        # batch statistics: pcc_tpu's XLA stage (pointnet_sa_module.py:74-93)
        idx = ball_query(new_xyz, xyz, self.nsample, self.radius)
        x = knn_gather(xyz, idx)                                # [B, S, ns, 3]
        if feat is not None:
            x = torch.cat([(gather_bf16 if self.bf16 else knn_gather)(feat, idx), x], dim=-1)
        for conv, bn in stack_layers(self.mlp):
            h = dense(conv, x, self.bf16, to_float32=True)
            x = torch.relu(batch_norm_train(h, bn, bf16=self.bf16))
        return new_xyz, max_bf16(x, 2) if self.bf16 else x.amax(dim=2)


class PointNetPP(nn.Module):
    """3-stage PN++ encoder -> global feature [B, feature_dim]
    (PPPF_AE.py:9-46), including the leading 3 -> 3 conv produced by the
    reference's `[3] + sa1_mlp` list."""

    def __init__(self, points: int = 512, sa1_mlp: Sequence[int] = (64, 64, 128),
                 sa2_mlp: Sequence[int] = (128, 128, 128, 256),
                 sa3_mlp: Sequence[int] = (256, 256, 512), feature_dim: int = 1024,
                 bf16: bool = False):
        super().__init__()
        self.bf16 = bf16
        self.sa1 = PointnetSAModule(points, 0.2, 32, 3, (3,) + tuple(sa1_mlp), bf16)
        self.sa2 = PointnetSAModule(128, 0.4, 64, sa1_mlp[-1] + 3, tuple(sa2_mlp), bf16)
        self.sa3 = PointnetSAModule(32, 0.8, 128, sa2_mlp[-1] + 3,
                                    tuple(sa3_mlp) + (feature_dim,), bf16)

    def forward(self, xyz: torch.Tensor):
        xyz, feat = self.sa1(xyz)
        xyz, feat = self.sa2(xyz, feat)
        xyz, feat = self.sa3(xyz, feat)
        return xyz, max_bf16(feat, 1) if self.bf16 else feat.amax(dim=1)   # [B, feature_dim]


def grid_line(d: int) -> np.ndarray:
    """The d values of the FoldingNet grid's line in [-1, 1], float32, as
    pcc_tpu's jitted programs compute jnp.linspace(-1, 1, d): s = i * f32(1 /
    (d - 1)), then s - (1 - s), one rounding each, and the last value exactly
    1. (numpy's float32 linspace differs from it in the last place in 11 of
    16 values at d = 16.)"""
    if d == 1:
        return np.full(1, -1.0, np.float32)
    s = np.arange(d, dtype=np.float32) * np.float32(1.0 / (d - 1))
    line = s - (np.float32(1.0) - s)
    line[-1] = 1.0
    return line


class FoldingNet(nn.Module):
    """Two-stage folding decoder over a grid_size^2 2D grid in [-1, 1]^2
    (PPPF_AE.py:50-109): [B, F] latent -> [B, grid_size^2, 3]. The grid's
    line is `grid_line`, bit-equal to the jnp.linspace(-1, 1, d) of
    pcc_tpu's jitted programs."""

    def __init__(self, points: int = 512, grid_size: int = 45, feature_dim: int = 1024,
                 bf16: bool = False):
        super().__init__()
        self.grid_size = grid_size
        self.bf16 = bf16
        self.mlp1 = nn.Sequential(
            PointConv(2 + feature_dim, points, conv_dims=1), nn.ReLU(),
            PointConv(points, points, conv_dims=1), nn.ReLU(),
            PointConv(points, 3, conv_dims=1))
        self.mlp2 = nn.Sequential(
            PointConv(3 + feature_dim, 128, conv_dims=1), nn.ReLU(),
            PointConv(128, 128, conv_dims=1), nn.ReLU(),
            PointConv(128, 3, conv_dims=1))

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        B = latent.shape[0]
        n = self.grid_size * self.grid_size
        line = grid_line(self.grid_size)
        gx, gy = np.meshgrid(line, line, indexing="ij")
        grid = torch.from_numpy(np.stack([gx, gy], axis=-1).reshape(1, n, 2)).to(
            latent.device).expand(B, n, 2)
        if not self.bf16:
            tiled = latent[:, None, :].expand(B, n, latent.shape[-1])    # [B, n, F]
            coarse = self.mlp1(torch.cat([grid, tiled], dim=-1))
            return self.mlp2(torch.cat([coarse, tiled], dim=-1))
        # flax's bf16 Dense layers on the grid and the latent (a bf16 value)
        # rounded to bf16, the latent's cotangent summed over its copies in bf16
        tiled = tile_bf16(latent, n)
        x = torch.cat([grid, tiled], dim=-1)
        for mlp in (self.mlp1, self.mlp2):
            for i in range(0, len(mlp), 2):
                # mlp2's last layer is cast to float32 at once, unrounded
                x = dense(mlp[i], x, bf16=True,
                          to_float32=mlp is self.mlp2 and i + 1 == len(mlp))
                if i + 1 < len(mlp):
                    x = torch.relu(x)
            if mlp is self.mlp1:
                x = torch.cat([x, tiled], dim=-1)
        return x


class PPPF_AE(nn.Module):
    """PN++ encoder -> project to d -> quantize -> project back ->
    FoldingNet with grid_size = d, so a decoded patch has d^2 points
    (PPPF_AE.py:114-150). `k` is unused, as in pcc_tpu."""

    def __init__(self, K: int = 512, k: int = 0, d: int = 16, L: int = 7,
                 dim: int = 1024, compute_dtype: str = "float32"):
        super().__init__()
        self.K, self.k, self.d, self.L, self.dim = K, k, d, L, dim
        self.bf16 = check_compute_dtype(compute_dtype)
        self.encoder = PointNetPP(points=K, feature_dim=dim, bf16=self.bf16)
        self.decoder = FoldingNet(points=K, grid_size=d, feature_dim=dim, bf16=self.bf16)
        self.enc_proj = nn.Linear(dim, d)
        self.dec_proj = nn.Linear(d, dim)

    def encode(self, xyz: torch.Tensor) -> torch.Tensor:
        """[B, K, 3] patches -> latent [B, d] in the quantizer's range (in
        bf16 each step rounded as pcc_tpu rounds it, then float32)."""
        _, latent = self.encoder(xyz)
        # cast to float32 at once in pcc_tpu (pppf.py:186), unrounded
        return dense(self.enc_proj, sigmoid_spread(latent, self.L, self.bf16), self.bf16,
                     to_float32=True)

    def decode(self, latent_q: torch.Tensor) -> torch.Tensor:
        """[B, d] quantized latent -> [B, d * d, 3] patch points."""
        # a float32 latent straight into the Dense: its cotangent stays float32
        return self.decoder(dense(self.dec_proj, latent_q, self.bf16, x_bf16=False))

    def forward(self, xyz: torch.Tensor):
        """Training pass (PPPF_AE.py:139-150): [B, K, 3] patches ->
        (reconstructed [B, d * d, 3], latent [B, d], straight-through
        quantized latent [B, d])."""
        latent = self.encode(xyz)
        latent_q = ste_round(latent)
        return self.decode(latent_q), latent, latent_q


class PPPFConditionalProbabilityModel(nn.Module):
    """PMFs from a PN++ backbone over the skeleton (PPPF_AE.py:181-228):
    [B, S, 3] -> [B, S, d, L]. The codec codes with its integer twin
    (coding/iprob_pppf.py); this float model holds the weights that twin is
    converted from. BatchNorm stays in the backbone, as in the reference
    (its bn=False flag never reaches PointnetSAModule). It takes no
    compute_dtype: no pcc_tpu path trains or runs it in bf16 while the
    codec's CDFs come from its integer twin (its PPPF_AE trainer builds it,
    like the autoencoder, in float32, train/steps_pppf.py:50-54)."""

    def __init__(self, d: int = 16, L: int = 7):
        super().__init__()
        self.d, self.L = d, L
        self.model_pnpp = PointNetPP(sa1_mlp=(64, 64, 128), sa2_mlp=(128, 128, 256),
                                     sa3_mlp=(256, 512, 1024), feature_dim=1024)
        self.model_mlp = nn.Sequential(
            PointConv(3 + 1024, 512), nn.ReLU(),
            PointConv(512, 512), nn.ReLU(),
            PointConv(512, d * L),
        )

    def forward(self, sampled_xyz: torch.Tensor) -> torch.Tensor:
        B, S, _ = sampled_xyz.shape
        _, feature = self.model_pnpp(sampled_xyz)
        tiled = feature[:, None, :].expand(B, S, feature.shape[-1])
        out = self.model_mlp(torch.cat([sampled_xyz, tiled], dim=-1))
        return torch.softmax(out.reshape(B, S, self.d, self.L), dim=-1)
