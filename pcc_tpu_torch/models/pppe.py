"""PPPE: the whole-cloud fast autoencoder family (counterpart of
pcc_tpu/models/pppe.py; reference pppe_pcd_ae.py's live classes).

A stacked PN++ encoder (one multi-scale stage and two single-scale stages,
KNN grouping) maps the whole cloud to a global latent; the latent is
straight-through quantized into L bins, dequantized, collapsed to a global
code and decoded by a small PCN-style decoder. The "compressed" file is
the raw float32 latent (cli/pppe_pcd_compress.py).

Module names are the reference's torch state_dict names, which pcc_tpu's
cli/import_torch_checkpoint.py::convert_pppe_ae_state_dict reads:
`encoder.sa_modules.0.branches.{b}.mlp_stack.{i}.{0,1}` (conv, BatchNorm),
`encoder.sa_modules.{1,2}.mlp_stack.{i}.{0,1}`, `encoder.global_conv.{0,1,3}`,
`decoder.fc_coarse.{0,2}`, `decoder.expansion_mlp.{0,2}`,
`prob.cond_proj.{0,2}`, `prob.combine.{0,2}`, `prob.{mean,scale,pmf}_head`.
The stages' convs carry a bias, which the reference's bias-free
conv2d_bn_relu lacks and pcc_tpu's TorchDense has: seeded weights set it to
0, so that the importer (which writes zeros) carries the port's weights
exactly, and pcc_tpu's checkpoints load with theirs.

In eval mode (running BatchNorm statistics) sa2 and sa3 run
ops/pppf_sa_cuda.py::pppf_sa_fused in its "pppe" layout (the CUDA kernel
csrc/pppf_sa_stage.cu on the card, its plain version on the CPU), as
pcc_tpu's fused flag routes them to its Pallas kernel; the multi-scale
stage takes one FPS and one top-32 selection for both branches and runs its
stacks as plain products, as pcc_tpu does. In training mode every stack,
sa1's branches, sa2, sa3 and global_conv's BatchNorm over the B clouds,
runs as plain products on batch statistics (layers.batch_norm_train,
flax's), as pcc_tpu's `fused and not train` gate leaves them; the
stages' FPS still runs on the FPS kernel (ops/fps.py).

compute_dtype "bfloat16" (pcc_tpu's PointCloudAE(dtype=bfloat16), which
its PPPE trainer builds under --bf16, parameters float32) trains on flax's
bf16 rules (ops/bf16.py): every stage layer flax's bf16 Dense, its result
going unrounded into flax's bf16 BatchNorm on batch statistics, relu, the
max over the K with jnp.max's gradient (max_bf16), the bf16 features
gathered with a bf16 scatter-add as their transpose (gather_bf16); the
global max, global_conv (its bias-free Dense and BatchNorm) and gc1, whose
result and the global feature are cast to float32
(pcc_tpu/models/pppe.py:179-181); the quantizer float32; PCNDecoderSmall
on flax's Dense, its two outputs cast to float32 (pppe.py:199-204; the
coarse cloud's after a reshape, which keeps its bf16 rounding). The
probability model takes no dtype in pcc_tpu and stays float32. Its bf16 eval
mode is pcc_tpu's make_pppe_model(cfg, fused=True) in eval mode (whose
fused flag changes bf16 results: the port follows fused=True, as in
float32): sa1's branches on flax's bf16 Dense and its bf16 BatchNorm at the
running statistics (layers.batch_norm_eval, which updates nothing), relu
and the max; sa2 and sa3 on the stage kernel's bf16 "pppe" instance
(pppf_sa_fused(..., bf16=True)) on weights rounded once per weights and
statistics, sa1's bf16 features going in as float32 values
(pcc_tpu/models/pppe.py:93) and the stage's bf16 values coming out; the
global max, gc0 and gc_bn at the running statistics, relu, gc1 and the
casts to float32; the quantizer float32 and the decoder as in training.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pcc_tpu_torch.config import PPPEConfig
from pcc_tpu_torch.models.layers import (PointConv, batch_norm_eval, batch_norm_train, dense,
                                         torch_dense_init_, weights_key)
from pcc_tpu_torch.ops.bf16 import check_compute_dtype, gather_bf16, max_bf16
from pcc_tpu_torch.ops.fps import fps_batch
from pcc_tpu_torch.ops.knn import knn_gather, knn_points
from pcc_tpu_torch.ops.pppf_sa_cuda import bf16_layers, fold_bn, pppf_sa_fused


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi): the values of torch.clamp, and jnp.clip's
    gradient, which is 0.5 where x sits exactly on a bound (torch.clamp's is
    1 there): torch.maximum / torch.minimum split a tie between their
    operands, as jnp.maximum / jnp.minimum do."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def quantize_st(x: torch.Tensor, min_val: float, max_val: float, levels: int) -> torch.Tensor:
    """Clamp -> scale to [0, levels-1] -> straight-through round -> clamp
    (pppe_pcd_ae.py:719-735), pcc_tpu's float32 operations in its order.
    Both clamps are jnp.clip's (`clip`): a latent on a bound, and every
    symbol 0 or levels-1 after the round, get half the gradient."""
    x_c = clip(x, min_val, max_val)
    # divide by a float32 tensor: torch's division by a Python scalar
    # multiplies by its reciprocal on the card
    span = torch.tensor(max_val - min_val + 1e-9, dtype=x.dtype, device=x.device)
    scaled = (x_c - min_val) / span * (levels - 1)
    y = (torch.round(scaled) - scaled).detach() + scaled
    return clip(y, 0.0, levels - 1.0)


def bn(h: torch.Tensor, module: nn.Module, norm, bf16: bool = False) -> torch.Tensor:
    """`norm`'s BatchNorm of h, flax's (bf16: BatchNorm(dtype=bfloat16)):
    on the batch's statistics (running ones updated) when `module` trains,
    else on the running statistics."""
    return (batch_norm_train if module.training else batch_norm_eval)(h, norm, bf16)


def conv_bn_relu(cin: int, features: Sequence[int]) -> nn.ModuleList:
    """The reference's nested conv2d_bn_relu stack (pppe_pcd_ae.py:555-568):
    mlp_stack.{i} = Sequential(conv, BatchNorm2d, ReLU)."""
    stack = nn.ModuleList()
    for f in features:
        stack.append(nn.Sequential(PointConv(cin, f), nn.BatchNorm2d(f), nn.ReLU()))
        cin = f
    return stack


class PointNetSetAbstractionKNN(nn.Module):
    """KNN-grouping SA stage (pppe_pcd_ae.py:573-614): FPS -> the K nearest
    -> centred rows [xyz - centroid | features] -> Conv + BatchNorm + ReLU
    stack -> max over the K. [B, N, 3] xyz (+ [B, N, C] features) ->
    ([B, npoint, 3], [B, npoint, mlp[-1]])."""

    def __init__(self, npoint: int, K: int, cin: int, mlp: Sequence[int], bf16: bool = False):
        super().__init__()
        self.npoint, self.K, self.bf16 = npoint, K, bf16
        self.mlp_stack = conv_bn_relu(cin, mlp)
        self._bf16_cache = None

    def layers(self):
        """[(W [in, out], b, mean, mul, bias)] per layer, BatchNorm folded."""
        return [(m[0].kernel(), m[0].bias, *fold_bn(m[1])) for m in self.mlp_stack]

    def stage_layers(self):
        """The fused stage's layers: `layers`; in bf16 with each W rounded
        (ops/pppf_sa_cuda.py::bf16_layers), made once per weights and
        running statistics."""
        if not self.bf16:
            return self.layers()
        key = weights_key([*self.parameters(), *self.buffers()])
        if self._bf16_cache is None or self._bf16_cache[0] != key:
            with torch.no_grad():
                self._bf16_cache = (key, bf16_layers(self.layers()))
        return self._bf16_cache[1]

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """The Conv + BatchNorm + ReLU stack and the max over the K (dim 2)."""
        if self.bf16:
            for m in self.mlp_stack:
                h = dense(m[0], x, True, to_float32=True)
                x = torch.relu(bn(h, self, m[1], bf16=True))
            return max_bf16(x, 2)
        for m in self.mlp_stack:
            x = torch.relu(bn(m[0](x), self, m[1]))
        return x.amax(dim=2)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None = None,
                precomputed=None):
        """precomputed: (new_xyz, knn_idx, grouped_xyz) at K' >= self.K from
        a sibling branch sharing its centroids (the MSG stage): the leading K
        slots of a sorted larger selection are this branch's own."""
        if precomputed is None:
            new_xyz = centroids(xyz, self.npoint)
            if not self.training:
                return new_xyz, pppf_sa_fused(
                    new_xyz, xyz.contiguous(),
                    None if features is None else features.contiguous(),
                    self.stage_layers(), nsample=self.K, radius=0.0, layout="pppe",
                    bf16=self.bf16)
            _, knn_idx, grouped_xyz = knn_points(new_xyz, xyz, K=self.K, return_nn=True)
        else:
            new_xyz, knn_idx, grouped_xyz = precomputed
        grouped = grouped_xyz[:, :, :self.K] - new_xyz[:, :, None, :]
        if features is not None:
            gather = gather_bf16 if self.bf16 else knn_gather
            grouped = torch.cat([grouped, gather(features, knn_idx[..., :self.K])], dim=-1)
        return new_xyz, self.stack(grouped)


def centroids(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """A stage's centroids [B, npoint, 3]: the points themselves when npoint
    == N, else FPS from index 0."""
    if npoint == xyz.shape[1]:
        return xyz
    idx = fps_batch(xyz.contiguous(), npoint,
                    torch.zeros(xyz.shape[0], dtype=torch.int32, device=xyz.device))
    return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3))


class PointNetSetAbstractionMSG(nn.Module):
    """Multi-scale grouping: the branches' outputs over the same centroids,
    concatenated (pppe_pcd_ae.py:617-632). One FPS and one top-Kmax
    selection serve every branch (pcc_tpu/models/pppe.py:109)."""

    def __init__(self, npoint: int, scales: Sequence[dict], cin: int = 3, bf16: bool = False):
        super().__init__()
        self.npoint = npoint
        self.branches = nn.ModuleList(
            [PointNetSetAbstractionKNN(npoint, sc["K"], cin, sc["mlp"], bf16) for sc in scales])

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None = None):
        new_xyz = centroids(xyz, self.npoint)
        k_max = max(b.K for b in self.branches)
        _, knn_idx, grouped_xyz = knn_points(new_xyz, xyz, K=k_max, return_nn=True)
        outs = [b(xyz, features, precomputed=(new_xyz, knn_idx, grouped_xyz))[1]
                for b in self.branches]
        return new_xyz, torch.cat(outs, dim=-1)


class PointNet2EncoderFull(nn.Module):
    """Stacked SA encoder -> (latent [B, latent_dim], global feature
    [B, 512]) (pppe_pcd_ae.py:637-686): MSG(512; K16 / K32) -> SS(128, K32)
    -> SS(32, K32), max over points, global_conv."""

    def __init__(self, latent_dim: int = 256, bf16: bool = False):
        super().__init__()
        self.bf16 = bf16
        self.sa_modules = nn.ModuleList([
            PointNetSetAbstractionMSG(512, ({"K": 16, "mlp": (32, 32, 64)},
                                            {"K": 32, "mlp": (64, 64, 128)}), bf16=bf16),
            PointNetSetAbstractionKNN(128, 32, 3 + 64 + 128, (128, 128, 256), bf16),
            PointNetSetAbstractionKNN(32, 32, 3 + 256, (256, 256, 512), bf16),
        ])
        self.global_conv = nn.Sequential(
            PointConv(512, 512, conv_dims=1, bias=False), nn.BatchNorm1d(512), nn.ReLU(),
            PointConv(512, latent_dim, conv_dims=1))

    def forward(self, x: torch.Tensor):
        xyz, feat = x, None
        for sa in self.sa_modules:
            xyz, feat = sa(xyz, feat)
        if self.bf16:
            global_feat = max_bf16(feat, 1)                     # [B, 512]
            h = dense(self.global_conv[0], global_feat, True, to_float32=True)
            h = torch.relu(bn(h, self, self.global_conv[1], bf16=True))
            return dense(self.global_conv[3], h, True, to_float32=True), global_feat
        global_feat = feat.amax(dim=1)                          # [B, 512]
        h = torch.relu(bn(self.global_conv[0](global_feat), self, self.global_conv[1]))
        return self.global_conv[3](h), global_feat


class PCNDecoderSmall(nn.Module):
    """latent [B, d] -> (coarse [B, 512, 3], fine [B, N, 3])
    (pppe_pcd_ae.py:691-714)."""

    def __init__(self, latent_dim: int = 256, coarse_points: int = 512,
                 final_points: int = 8192, bf16: bool = False):
        super().__init__()
        self.coarse_points, self.final_points, self.bf16 = coarse_points, final_points, bf16
        self.fc_coarse = nn.Sequential(nn.Linear(latent_dim, 512), nn.ReLU(),
                                       nn.Linear(512, coarse_points * 3))
        self.expansion_mlp = nn.Sequential(
            nn.Linear(coarse_points * 3 + latent_dim, 1024), nn.ReLU(),
            nn.Linear(1024, final_points * 3))

    def forward(self, latent: torch.Tensor):
        B = latent.shape[0]
        if self.bf16:
            # flax's bf16 Dense; the float32 latent goes straight into fc0 (its
            # cotangent float32), the float32 concat into exp0; fc1's result
            # is reshaped before its cast to float32, and stays rounded
            fc, ex = self.fc_coarse, self.expansion_mlp
            h = torch.relu(dense(fc[0], latent, True, x_bf16=False))
            coarse = dense(fc[2], h, True)
            h = torch.relu(dense(ex[0], torch.cat([coarse, latent], dim=1), True))
            fine = dense(ex[2], h, True, to_float32=True)
        else:
            coarse = self.fc_coarse(latent)
            fine = self.expansion_mlp(torch.cat([coarse, latent], dim=1))
        return coarse.reshape(B, self.coarse_points, 3), fine.reshape(B, self.final_points, 3)


class PPPEConditionalProbabilityModel(nn.Module):
    """Per-point conditional distributions (pppe_pcd_ae.py:740-801):
    y [B, d, N] and conditioning features [B, F] (or [B, H, N]) ->
    (mean [B, d, N], scale [B, d, N], pmf [B, L, N]), channels first as the
    reference's Conv1d contract."""

    def __init__(self, feature_dim: int = 512, hidden_channels: int = 128,
                 latent_bins: int = 16, latent_channels: int = 3):
        super().__init__()
        H = hidden_channels
        self.cond_proj = nn.Sequential(nn.Linear(feature_dim, H), nn.ReLU(), nn.Linear(H, H))
        self.combine = nn.Sequential(PointConv(latent_channels + H, H, conv_dims=1), nn.ReLU(),
                                     PointConv(H, H, conv_dims=1))
        self.mean_head = PointConv(H, latent_channels, conv_dims=1)
        self.scale_head = PointConv(H, latent_channels, conv_dims=1)
        self.pmf_head = PointConv(H, latent_bins, conv_dims=1)

    def forward(self, y: torch.Tensor, cond_feats: torch.Tensor):
        B, d, N = y.shape
        if cond_feats.dim() == 2:
            cond = self.cond_proj(cond_feats)[:, :, None].expand(-1, -1, N)
        elif cond_feats.dim() == 3:
            cond = cond_feats
        else:
            raise ValueError("cond_feats must be (B,F) or (B,F,N)")
        x = torch.cat([y, cond], dim=1).transpose(1, 2)      # [B, N, d + H]
        h = self.combine(x)
        mean = self.mean_head(h).transpose(1, 2)
        scale = torch.nn.functional.softplus(self.scale_head(h)).transpose(1, 2) + 1e-6
        pmf = torch.softmax(self.pmf_head(h).transpose(1, 2), dim=1).clamp_min(1e-9)
        return mean, scale, pmf


class PointCloudAE(nn.Module):
    """The whole-cloud AE (pppe_pcd_ae.py:843-877): encoder -> the latent
    tiled per point -> quantize_st -> dequantize -> mean over points ->
    decoder. forward returns (coarse, fine, cond_feats, y_q)."""

    def __init__(self, latent_dim: int = 64, latent_bins: int = 16, npoints: int = 8192,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.latent_dim, self.latent_bins, self.npoints = latent_dim, latent_bins, npoints
        self.bf16 = check_compute_dtype(compute_dtype)
        self.encoder = PointNet2EncoderFull(latent_dim, self.bf16)
        self.decoder = PCNDecoderSmall(latent_dim, 512, npoints, self.bf16)
        self.prob = PPPEConditionalProbabilityModel(512, 128, latent_bins, latent_dim)
        self.q_min, self.q_max = 0.0, latent_bins - 1.0

    def forward(self, x: torch.Tensor):
        N = x.shape[1]
        latent, cond_feats = self.encoder(x)
        # every point's copy of the latent is the same, and so is each
        # elementwise result: compute on one copy, expand to [B, d, N]
        y_q = quantize_st(latent, self.q_min, self.q_max, self.latent_bins)
        steps = torch.tensor(self.latent_bins - 1, dtype=y_q.dtype, device=y_q.device)
        y_dequant = (y_q / steps) * (self.q_max - self.q_min) + self.q_min
        y_global = y_dequant[:, :, None].expand(-1, -1, N).mean(dim=2)
        coarse, fine = self.decoder(y_global)
        return coarse, fine, cond_feats, y_q[:, :, None].expand(-1, -1, N)


@torch.no_grad()
def estimate_bits_per_point_conditional(model: PointCloudAE, y_q: torch.Tensor,
                                        cond_feats: torch.Tensor) -> torch.Tensor:
    """The detached rate estimate (pppe_pcd_ae.py:882-917): the prob model's
    pmf [B, L, N] at the channel-0 symbol of y_q [B, d, N], mean -log2 over
    the points. Under no_grad, as the reference's no_grad and .detach(): the
    rate carries no gradient, and PPPE trains on the chamfer alone."""
    _, _, pmf = model.prob(y_q, cond_feats)
    idx0 = torch.clamp(y_q[:, 0, :].long(), 0, pmf.shape[1] - 1)         # [B, N]
    probs = torch.gather(pmf, 1, idx0[:, None, :])                        # [B, 1, N]
    return torch.mean(-torch.log2(torch.clamp_min(probs, 1e-9)))


def init_pppe_weights(model: PointCloudAE, seed: int) -> PointCloudAE:
    """Seeded weights in torch's default Linear / Conv initialization, the
    stages' conv biases 0 (the reference's bias-free conv2d_bn_relu) and
    BatchNorm at its defaults (running mean 0, variance 1, scale 1, bias 0)."""
    torch_dense_init_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".mlp_stack." in name and name.endswith(".0.bias"):
                p.zero_()
    return model


def make_pppe_model(cfg: PPPEConfig, seed: int | None = None,
                    device: str | torch.device = "cpu") -> PointCloudAE:
    """PointCloudAE for `cfg` in eval mode on `device` (pcc_tpu's
    make_pppe_model: latent_bins = L, npoints = N, compute_dtype), with
    seeded weights when `seed` is given."""
    model = PointCloudAE(latent_dim=cfg.latent_dim, latent_bins=cfg.L, npoints=cfg.N,
                         compute_dtype=cfg.compute_dtype)
    if seed is not None:
        init_pppe_weights(model, seed)
    return model.to(device).eval()
