"""IPDAE patch autoencoder + conditional probability model (counterpart of
pcc_tpu/models/ipdae.py; reference AE.py).

Same graph and the reference's state_dict names and shapes (encoder
AE.py:16-17, decoder AE.py:19-27, probability model AE.py:87-123).
`encode` / `decode` run the fused CUDA kernels on the card and their plain
versions on the CPU (ops/sa_cuda.py, ops/decoder_cuda.py). `forward` is the
training pass: the encoder with its backward kernel
(ops/sa_cuda.py::patch_encoder_trainable) and a differentiable decoder of
plain products, as pcc_tpu trains (models/ipdae.py:115-130).

compute_dtype "bfloat16" (pcc_tpu's PatchAE(dtype=bfloat16) with its fused
kernels; parameters stay float32): `encode` runs the bf16 encoder kernel on
the rounded weights `encoder_weights` keeps, then sigmoid_spread in float32
(pcc_tpu/models/ipdae.py:80-82); `decoder_inputs` and `decode` the bf16
decoder path (decoder_pallas.py:113-123: h1 rounded before layer 2, h2
handed to the kernel in float32). `forward` in bf16 is pcc_tpu's bf16 train
pass with fused_sa: the encoder through the bf16 instances of both encoder
kernels (ops/sa_cuda.py::patch_encoder_trainable), the spread in float32,
and the decoder on flax's bf16 Dense rule with its gradient rules
(ops/bf16.py), since pcc_tpu trains without its fused decoder
(models/ipdae.py:99-123). The probability model in bf16 is flax's too.
"""

from __future__ import annotations

import torch
from torch import nn

from pcc_tpu_torch.models.layers import (
    PointConv,
    PointNetFeat,
    PointwiseMLP,
    SetAbstraction,
    dense,
    mlp_bf16,
    sigmoid_spread,
    ste_round,
    weights_key,
)
from pcc_tpu_torch.ops.bf16 import check_compute_dtype, grad_round, round_bf16, tile_bf16
from pcc_tpu_torch.ops.decoder_cuda import (expansion_kmajor, pack_decoder, patch_decoder,
                                            permute_expansion)
from pcc_tpu_torch.ops.sa_cuda import (PLAIN_CHUNK, bf16_wb, patch_encoder,
                                       patch_encoder_trainable)


class PatchAE(nn.Module):
    """[B, K, 3] patches -> d-dim quantized latent -> [B, k, 3] points
    (reference AE.AE(K, k, d, L), AE.py:12-32)."""

    def __init__(self, K: int = 256, k: int = 128, d: int = 16, L: int = 7,
                 sa_knn: int = 16, compute_dtype: str = "float32"):
        super().__init__()
        self.K, self.k, self.d, self.L, self.sa_knn = K, k, d, L, sa_knn
        self.bf16 = check_compute_dtype(compute_dtype)
        self.sa = SetAbstraction(knn=sa_knn, mlp=(32, 64, 128), compute_dtype=compute_dtype)
        self.pn = PointNetFeat(3 + 128, (128, 256, 512, d),
                               relu=(True, True, True, False))
        self.inv_pool = nn.Sequential(
            nn.Linear(d, 256), nn.ReLU(),
            nn.Linear(256, 1024), nn.ReLU(),
            nn.Linear(1024, k * 128), nn.ReLU(),
        )
        self.inv_mlp = PointwiseMLP(128 + d, (128, 64, 32, 3),
                                    relu=(True, True, True, False))
        # the decoder's weights in the fused decoder's layouts and the bf16
        # encoder's rounded weights, made once per weights in eval mode
        # (decoder_weights, encoder_weights)
        self._decoder_cache = self._encoder_cache = None
        self.register_load_state_dict_post_hook(PatchAE._drop_caches)

    def _drop_caches(self, *_) -> None:
        self._decoder_cache = self._encoder_cache = None

    def train(self, mode: bool = True):
        self._drop_caches()
        return super().train(mode)

    def encoder_weights(self):
        """(sa_wb, pn_wb): the encoder's ([in, out] weight, bias) pairs; in
        bf16 rounded to bf16 (ops/sa_cuda.py::bf16_wb, the bf16 kernel's
        operands), in eval mode once per weights."""
        sa_wb, pn_wb = self.sa.layers(), self.pn.layers()
        if not self.bf16:
            return sa_wb, pn_wb
        key = weights_key([*self.sa.parameters(), *self.pn.parameters()])
        if self._encoder_cache is not None and self._encoder_cache[0] == key:
            return self._encoder_cache[1]
        with torch.no_grad():
            weights = (bf16_wb(sa_wb), bf16_wb(pn_wb))
        if not self.training:
            self._encoder_cache = (key, weights)
        return weights

    def encode(self, patches: torch.Tensor) -> torch.Tensor:
        """[B, K, 3] -> latent [B, d], already spread into the quantizer
        range (AE.py:36-44)."""
        latent = patch_encoder(patches, *self.encoder_weights(), self.sa_knn, bf16=self.bf16)
        # the quantizer's arithmetic stays float32 under bf16 compute
        return sigmoid_spread(latent, self.L)

    def encode_unfused(self, patches: torch.Tensor) -> torch.Tensor:
        """encode as pcc_tpu's PatchAE computes it with fused_sa off (its
        AttrCodec's geometry, pcc_tpu/attrib.py:116): in bf16 the
        SetAbstraction(fused=False) in bf16 (flax's bf16 Dense rule on the
        float32 centred neighbours) and the PointNet MLP on flax's rule (the
        concat a float32 value, the max over bf16 values), plain products,
        PLAIN_CHUNK patches at a time; in float32 `encode`, the same
        function."""
        if not self.bf16:
            return self.encode(patches)
        outs = []
        for p in torch.split(patches, PLAIN_CHUNK):
            x = torch.cat([p, self.sa(p)], dim=-1)
            outs.append(mlp_bf16(self.pn, x, x_bf16=False).amax(dim=-2))
        return sigmoid_spread(torch.cat(outs), self.L)

    def decode_unfused(self, latent_q: torch.Tensor) -> torch.Tensor:
        """decode as pcc_tpu's PatchAE computes it with fused_decode off (its
        AttrCodec's geometry): `decode_train`'s plain products, flax's rule
        in bf16; in float32 `decode`, the same function."""
        return self.decode_train(latent_q) if self.bf16 else self.decode(latent_q)

    def decoder_weights(self):
        """(w3r, b3r, mlp_wb, packed): the point-major expansion weight and
        bias, the inv_mlp ([in, out] weight, bias) pairs and, for weights on
        the card, the fused decoder's layout of them
        (ops/decoder_cuda.py::pack_decoder, for the model's compute dtype).
        Made on every call in train mode; in eval mode once per weights and
        compute dtype (a 64 MB permutation and its TF32 split, or bf16
        rounding, at full width), dropped by train() and load_state_dict."""
        l3 = self.inv_pool[4]
        key = (self.bf16,) + weights_key((l3.weight, l3.bias, *self.inv_mlp.parameters()))
        if self._decoder_cache is not None and self._decoder_cache[0] == key:
            return self._decoder_cache[1]
        with torch.no_grad():
            w3r, b3r = permute_expansion(l3.weight.t(), l3.bias, self.k)
            mlp_wb = self.inv_mlp.layers()
            packed = None
            if l3.weight.is_cuda:
                packed = pack_decoder(expansion_kmajor(l3.weight, self.k), b3r, mlp_wb,
                                      bf16=self.bf16)
        weights = (w3r, b3r, mlp_wb, packed)
        if not self.training:
            self._decoder_cache = (key, weights)
        return weights

    def decoder_inputs(self, latent_q: torch.Tensor):
        """The fused decoder's arguments for [B, d] latents: inv_pool layers
        1-2 as plain products (h2 [B, 1024]), then decoder_weights(). In
        bf16 as pcc_tpu's patch_decoder_fused computes them: the operands
        rounded to bf16, float32 products and biases, h1 rounded before layer
        2 and h2 float32."""
        l1, l2 = self.inv_pool[0], self.inv_pool[2]
        if self.bf16:
            h1 = torch.relu(round_bf16(latent_q) @ round_bf16(l1.weight.t()) + l1.bias)
            h2 = torch.relu(round_bf16(h1) @ round_bf16(l2.weight.t()) + l2.bias)
        else:
            h1 = torch.relu(latent_q @ l1.weight.t() + l1.bias)
            h2 = torch.relu(h1 @ l2.weight.t() + l2.bias)
        return (h2.contiguous(), *self.decoder_weights())

    def decode(self, latent_q: torch.Tensor) -> torch.Tensor:
        """[B, d] quantized latent -> [B, k, 3] patch points (AE.py:47-53):
        the expansion, fold, tile and inv_mlp are the fused decoder."""
        h2, w3r, b3r, mlp_wb, packed = self.decoder_inputs(latent_q)
        return patch_decoder(h2, latent_q.contiguous(), w3r, b3r, mlp_wb, self.k, packed=packed,
                             bf16=self.bf16)

    def decode_train(self, latent_q: torch.Tensor) -> torch.Tensor:
        """The differentiable decoder (AE.py:47-53): inv_pool, the fold of
        [B, k*128] viewed as [B, 128, k] and moved point-major, the latent
        tiled onto every point, inv_mlp -> [B, k, 3]. In bf16 every layer on
        flax's bf16 rule, the output cast to float32 at once; the latent is a
        float32 value that goes straight into the first layer, whose input
        gradient stays float32 (ops/bf16.py)."""
        B = latent_q.shape[0]
        if self.bf16:
            h = latent_q
            for i in (0, 2, 4):
                h = torch.relu(dense(self.inv_pool[i], h, True, x_bf16=i > 0))
            fold = h.reshape(B, 128, self.k).transpose(1, 2)
        else:
            fold = self.inv_pool(latent_q).reshape(B, 128, self.k).transpose(1, 2)
        tiled = latent_q[:, None, :].expand(B, self.k, latent_q.shape[-1])
        x = torch.cat([fold, tiled], dim=-1)
        if self.bf16:
            return mlp_bf16(self.inv_mlp, x, to_float32=True)
        return self.inv_mlp(x)

    def forward(self, patches: torch.Tensor):
        """Training pass (AE.py:34-55): [B, K, 3] patches -> (reconstructed
        [B, k, 3], latent [B, d], straight-through quantized latent [B, d]).
        In bf16 the encoder's kernels take the float32 weights and round them
        as pcc_tpu's do; the latent is spread in float32."""
        latent = sigmoid_spread(
            patch_encoder_trainable(patches, self.sa.layers(), self.pn.layers(),
                                    self.sa_knn, bf16=self.bf16), self.L)
        latent_q = ste_round(latent)
        return self.decode_train(latent_q), latent, latent_q


class ConditionalProbabilityModel(nn.Module):
    """Latent PMFs conditioned only on the decoded skeleton (AE.py:87-123):
    [B, S, 3] -> [B, S, d, L]. The codec codes with its integer twin
    (coding/iprob.py); this float model holds the weights that twin is
    converted from, and trains. compute_dtype "bfloat16": pcc_tpu's
    ConditionalProbabilityModel(dtype=bfloat16), every layer on flax's bf16
    rule, the max over points and the tiled feature bf16 values, the xyz
    rounded into the concat, the logits cast to float32 for the softmax."""

    def __init__(self, d: int = 16, L: int = 7, compute_dtype: str = "float32"):
        super().__init__()
        self.d, self.L = d, L
        self.bf16 = check_compute_dtype(compute_dtype)
        self.model_pn = PointNetFeat(3, (64, 128, 256))
        self.model_mlp = nn.Sequential(
            PointConv(3 + 256, 512), nn.ReLU(),
            PointConv(512, 512), nn.ReLU(),
            PointConv(512, d * L),
        )

    def forward(self, sampled_xyz: torch.Tensor) -> torch.Tensor:
        B, S, _ = sampled_xyz.shape
        if self.bf16:
            feature = grad_round(mlp_bf16(self.model_pn, sampled_xyz, x_bf16=False)
                                 .amax(dim=-2))
            x = torch.cat([round_bf16(sampled_xyz), tile_bf16(feature, S)], dim=-1)
            for i in (0, 2, 4):
                x = dense(self.model_mlp[i], x, True, to_float32=i == 4)
                if i < 4:
                    x = torch.relu(x)
            return torch.softmax(x.reshape(B, S, self.d, self.L), dim=-1)
        feature = self.model_pn(sampled_xyz)                    # [B, 256]
        tiled = feature[:, None, :].expand(B, S, feature.shape[-1])
        out = self.model_mlp(torch.cat([sampled_xyz, tiled], dim=-1))
        return torch.softmax(out.reshape(B, S, self.d, self.L), dim=-1)
