"""XYZ + RGB attribute extension of the IPDAE patch codec (counterpart of
pcc_tpu/attrib.py; the reference codes geometry only).

A per-patch colour autoencoder beside the geometry one: its encoder sees
each scaled patch's points with their colours, its decoder paints the
decoded patch in its scaled frame, so the colours decode from the
transmitted skeleton and geometry alone. The attribute latent is spread,
rounded and range-coded under a skeleton-conditioned probability model of
the IPDAE architecture at d = d_a, whose integer twin (coding/iprob.py)
makes the CDFs byte-identical on any device, as for the geometry stream.

On disk a fourth stream beside .p/.s/.c.bin: {name}.a.bin.

Kernels: encoding runs the FPS kernel and the patch encoder kernel (the
geometry symbols); decoding the patch decoder kernel; the train step the
FPS kernel, the patch encoder with its backward kernel and the chamfer
kernels. The colour encoder and decoder are plain products, as in
pcc_tpu. In bf16 (compress / decompress --attributes --bf16) the geometry
is pcc_tpu's AttrCodec's, which builds PatchAE without its fused kernels
(pcc_tpu/attrib.py:116, 222) and so rounds by flax's bf16 Dense rule, not
the kernels': PatchAE.encode_unfused and decode_unfused, plain products
(the FPS kernel still runs).

Module names: no reference state_dict exists for this extension, so
PatchAttrAE's names mirror pcc_tpu's flax tree, `enc` and `dec`, with the
port's PointwiseMLP layers inside (`enc.mlp_Modules.{i}.0`,
`dec.mlp_Modules.{i}.0`); weights.py::attr_to_jax / attr_from_jax carry
them to and from pcc_tpu's attr.pkl, and the attribute probability model
is the IPDAE ConditionalProbabilityModel with its names.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from pcc_tpu_torch.codec import (Codec, encode_geometry, init_params, make_models,
                                 pack_encode_upload, unpack_encode_upload)
from pcc_tpu_torch.coding import rangecoder
from pcc_tpu_torch.coding.iprob import (bundle_to_device, convert_prob_params,
                                        iprob_pmf_weights, weights_to_cdf_rows)
from pcc_tpu_torch.coding.pmf import estimate_bits_from_pmf
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.device import resolve_device
from pcc_tpu_torch.models.ipdae import ConditionalProbabilityModel
from pcc_tpu_torch.models.layers import (PointNetFeat, PointwiseMLP, sigmoid_spread,
                                         ste_round, torch_dense_init_)
from pcc_tpu_torch.models.losses import rate_distortion_loss
from pcc_tpu_torch.ops.chamfer import nearest_neighbor
from pcc_tpu_torch.ops.knn import knn_gather
from pcc_tpu_torch.ops.normalize import denormalize
from pcc_tpu_torch.train.state import AdamSchedule, TrainState
from pcc_tpu_torch.weights import to_jax_params

# u8 / 255.0 as XLA compiles it in pcc_tpu: a product with the float32
# reciprocal
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


class PatchAttrAE(nn.Module):
    """Per-patch colour autoencoder (pcc_tpu/attrib.py::PatchAttrAE).

    encode: scaled patch xyz [P, K, 3] + colours in [0, 1] -> spread latent
    [P, d_a] (PointNet 6 -> 64-128-256-d_a, no relu on the last layer, max
    over the points). decode: quantized latent + decoded patch xyz [P, k, 3]
    -> colours [P, k, 3] in [0, 1] (pointwise 3 + d_a -> 128-64-3, then a
    sigmoid)."""

    def __init__(self, d_a: int = 16, L: int = 7):
        super().__init__()
        self.d_a, self.L = d_a, L
        self.enc = PointNetFeat(6, (64, 128, 256, d_a), relu=(True, True, True, False))
        self.dec = PointwiseMLP(3 + d_a, (128, 64, 3), relu=(True, True, False))

    def encode(self, patch_xyz: torch.Tensor, rgb01: torch.Tensor) -> torch.Tensor:
        return sigmoid_spread(self.enc(torch.cat([patch_xyz, rgb01], dim=-1)), self.L)

    def decode(self, latent_q: torch.Tensor, patch_xyz: torch.Tensor) -> torch.Tensor:
        tiled = latent_q[:, None, :].expand(-1, patch_xyz.shape[1], -1)
        return torch.sigmoid(self.dec(torch.cat([patch_xyz, tiled], dim=-1)))

    def forward(self, patch_xyz, rgb01, dec_xyz):
        """(colours of dec_xyz, latent, straight-through quantized latent)."""
        z = self.encode(patch_xyz, rgb01)
        z_q = ste_round(z)
        return self.decode(z_q, dec_xyz), z, z_q


def make_attr_models(cfg: CodecConfig, d_a: int = 16):
    """(colour autoencoder, attribute probability model) for cfg."""
    return PatchAttrAE(d_a=d_a, L=cfg.L), ConditionalProbabilityModel(d=d_a, L=cfg.L)


def init_attr_params(seed: int, cfg: CodecConfig, d_a: int = 16):
    """Random (PatchAttrAE, attribute probability model) state_dicts from a
    seeded torch.Generator, torch's Linear/Conv default init."""
    g = torch.Generator().manual_seed(seed)
    attr, attr_prob = make_attr_models(cfg, d_a)
    torch_dense_init_(attr, g)
    torch_dense_init_(attr_prob, g)
    return attr.state_dict(), attr_prob.state_dict()


def to_rgb_u8(rgb01: np.ndarray) -> np.ndarray:
    """Colours in [0, 1] -> uint8 by floor(x * 255 + 0.5), clipped, in
    float32 (pcc_tpu's rounding; torch.round would round half to even)."""
    x = np.asarray(rgb01, np.float32)
    return np.clip(np.floor(x * np.float32(255.0) + np.float32(0.5)), 0, 255).astype(np.uint8)


class AttrEncodeResult(NamedTuple):
    sym: torch.Tensor           # [B, S, d] int8 geometry symbols
    asym: torch.Tensor          # [B, S, d_a] int8 attribute symbols
    weights: torch.Tensor       # [B, S, d, L] int32 Q16 coding weights of sym
    aweights: torch.Tensor      # [B, S, d_a, L] of asym
    sorted_codes: torch.Tensor
    depth: torch.Tensor
    center: torch.Tensor
    longest: torch.Tensor


def _symbols(latent: torch.Tensor, cfg: CodecConfig, B: int) -> torch.Tensor:
    sym = torch.clamp(torch.round(latent) + cfg.L // 2, 0, cfg.L - 1)
    return sym.to(torch.int8).reshape(B, cfg.S, -1)


def encode_clouds_attr(ae, attr, bundle, abundle, pcs: torch.Tensor, rgb01: torch.Tensor,
                       fps_starts: torch.Tensor, cfg: CodecConfig) -> AttrEncodeResult:
    """Clouds [B, N, 3] and colours [B, N, 3] in [0, 1] -> symbols of both
    streams and their integer coding weights: normalize -> FPS -> octree ->
    KNN patches -> the patch encoder (geometry) and the colour encoder on
    [patch xyz | colours] (attributes)."""
    geo = encode_geometry(pcs, fps_starts, cfg)
    B = pcs.shape[0]
    patch_rgb = knn_gather(rgb01, geo.knn_idx).reshape(B * cfg.S, cfg.K, 3)
    rec = geo.octree.rec_xyz
    return AttrEncodeResult(
        sym=_symbols(ae.encode_unfused(geo.patches), cfg, B),
        asym=_symbols(attr.encode(geo.patches, patch_rgb), cfg, B),
        weights=iprob_pmf_weights(bundle, rec), aweights=iprob_pmf_weights(abundle, rec),
        sorted_codes=geo.octree.sorted_codes, depth=geo.octree.depth,
        center=geo.center, longest=geo.longest)


def decode_clouds_attr(ae, attr, sym: torch.Tensor, asym: torch.Tensor, recs: torch.Tensor,
                       center: torch.Tensor, longest: torch.Tensor, cfg: CodecConfig):
    """Symbols [B, S, d] and [B, S, d_a], skeletons [B, S, 3], headers ->
    (clouds [B, S*k, 3], colours [B, S*k, 3] in [0, 1]): the patch decoder,
    then the colour decoder paints each decoded patch in its scaled frame."""
    B, S = sym.shape[:2]
    patches = ae.decode_unfused((sym.to(torch.float32) - cfg.L // 2).reshape(B * S, -1))
    rgb01 = attr.decode((asym.to(torch.float32) - cfg.L // 2).reshape(B * S, -1), patches)
    # / patch_scale as XLA compiles it: a product with the f32 reciprocal
    inv_scale = float(np.float32(1.0) / np.float32(cfg.patch_scale))
    pc01 = (patches.reshape(B, S, -1, 3) * inv_scale + recs[:, :, None, :]).reshape(B, -1, 3)
    pc = denormalize(pc01, center[:, None, :], longest[:, None, None], cfg.margin)
    return pc, rgb01.reshape(B, -1, 3)


class AttrCodec(Codec):
    """Geometry + attribute codec on one device: clouds with colours <->
    (.p, .s, .c, .a) byte streams, batch_size clouds of equal size per
    device batch. `params` holds the port's state_dicts under "ae",
    "prob", "attr" and "attr_prob". Integer CDF mode only. Codec batches
    the clouds and writes and parses the .p/.s/.c streams; this class adds
    the colours and the .a stream. The geometry computes in
    cfg.compute_dtype (make_models); the colour nets stay float32, as
    pcc_tpu's attrib.py gives them no dtype."""

    def __init__(self, cfg: CodecConfig, params: dict, batch_size: int = 16, d_a: int = 16,
                 device: str | torch.device = "cuda", cdf_mode: str = "integer"):
        if cdf_mode != "integer":
            raise NotImplementedError(
                f"cdf_mode={cdf_mode!r}: pcc_tpu_torch codes in the integer CDF mode only "
                "(the float mode and its crc32 trailer are not ported)")
        super().__init__(cfg, params["ae"], params["prob"], batch_size, device)
        self.d_a = d_a
        attr, attr_prob = make_attr_models(cfg, d_a)
        attr.load_state_dict(params["attr"])
        self.attr = attr.to(self.device).eval()
        # the attribute probability model -> its integer bundle, once, on the host
        _, aprob_tree = to_jax_params(None, params["attr_prob"])
        self.abundle = bundle_to_device(convert_prob_params(aprob_tree, d_a, cfg.L), self.device)

    @torch.inference_mode()
    def encode_batch(self, pcs: np.ndarray, rgbs: np.ndarray, starts: np.ndarray):
        """One device batch: clouds [B, N, 3] f32, colours [B, N, 3] u8, FPS
        starts [B] -> AttrEncodeResult on the device."""
        N = pcs.shape[1]
        packed = pack_encode_upload(np.asarray(pcs, np.float32), starts)
        dev = torch.from_numpy(packed.view(np.int32)).to(self.device)
        clouds, fps_starts = unpack_encode_upload(dev, N)
        rgb01 = torch.from_numpy(np.ascontiguousarray(rgbs, np.uint8)).to(self.device)
        rgb01 = rgb01.to(torch.float32) * _INV_255
        return encode_clouds_attr(self.ae, self.attr, self.bundle, self.abundle, clouds,
                                  rgb01, fps_starts, self.cfg.with_n(N))

    def serialize(self, res: AttrEncodeResult):
        """AttrEncodeResult of a batch -> list of (p, s, c, a) bytes: Codec's
        three streams and the range-coded attribute symbols."""
        asym = res.asym.cpu().numpy()
        acdfs = weights_to_cdf_rows(res.aweights.cpu().numpy())
        return [(*blobs, rangecoder.encode_quantized_cdf(acdfs[j], asym[j].astype(np.int16)))
                for j, blobs in enumerate(super().serialize(res))]

    def compress_many(self, clouds, rgbs, fps_starts=None):
        """Lists of [N, 3] f32 clouds and [N, 3] u8 colours -> list of (p, s,
        c, a) bytes."""
        return self._compress_many(clouds, (rgbs,), fps_starts)

    @torch.inference_mode()
    def decode_symbols(self, recs: np.ndarray, p_streams, a_streams):
        """Skeletons [B, S, 3] + .p.bin and .a.bin streams -> symbols
        ([B, S, d], [B, S, d_a]) int8: integer weights of both models on the
        device, CDF rows and the range decoder on the host."""
        rec_t = torch.from_numpy(np.ascontiguousarray(recs, np.float32)).to(self.device)
        acdfs = weights_to_cdf_rows(iprob_pmf_weights(self.abundle, rec_t).cpu().numpy())
        asym = np.stack([rangecoder.decode_quantized_cdf(acdfs[j], a)
                         for j, a in enumerate(a_streams)]).astype(np.int8)
        return super().decode_symbols(recs, p_streams), asym

    @torch.inference_mode()
    def decode_batch(self, syms: np.ndarray, asyms: np.ndarray, recs: np.ndarray,
                     headers: np.ndarray):
        """Symbols of both streams, skeletons [B, S, 3] and .c.bin headers
        [B, 4] -> (clouds [B, S*k, 3] f32, colours [B, S*k, 3] u8)."""
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        cfg = self.cfg.with_n(syms.shape[1] * self.cfg.k)   # decode side: N = S * k
        pc, rgb01 = decode_clouds_attr(self.ae, self.attr, t(syms), t(asyms),
                                       t(recs.astype(np.float32)), t(headers[:, :3]),
                                       t(headers[:, 3]), cfg)
        return pc.cpu().numpy(), to_rgb_u8(rgb01.cpu().numpy())

    def decode_streams(self, recs: np.ndarray, headers: np.ndarray, streams):
        """One batch of (p, s, c, a) tuples -> (cloud [M, 3] f32, colours
        [M, 3] u8) per tuple; decompress_many returns these."""
        syms, asyms = self.decode_symbols(recs, [s[0] for s in streams],
                                          [s[3] for s in streams])
        return list(zip(*self.decode_batch(syms, asyms, recs, headers)))


# ---------------------------------------------------------------- training --

def attr_rd_forward(state, batch: torch.Tensor, rgb_batch: torch.Tensor,
                    starts: torch.Tensor, lam: float, cfg: CodecConfig):
    """Joint geometry + attribute loss of clouds [B, N, 3] with colours
    [B, N, 3] in [0, 1] and FPS starts [B] (pcc_tpu/attrib.py::
    attr_rd_forward): chamfer + colour MSE + lam * rate of both streams. Each decoded point's colour is held to the colour of its
    nearest input point (exact 1-NN on detached points). Returns (loss,
    aux) with aux keys chamfer, fbpp, color_mse, bpp."""
    B, N, _ = batch.shape
    with torch.no_grad():
        geo = encode_geometry(batch, starts, cfg)
    rec = geo.octree.rec_xyz
    patch_rgb = knn_gather(rgb_batch, geo.knn_idx).reshape(B * cfg.S, cfg.K, 3)

    patches_pred, _, latent_q = state.ae(geo.patches)
    rgb_pred, _, alat_q = state.attr(geo.patches, patch_rgb, patches_pred)
    # / patch_scale as XLA compiles it: a product with the f32 reciprocal
    patches_pred = patches_pred * float(np.float32(1.0) / np.float32(cfg.patch_scale))

    pmf, apmf = state.prob(rec), state.attr_prob(rec)
    sym = torch.clamp(latent_q.detach().reshape(B, cfg.S, cfg.d) + cfg.L // 2, 0, cfg.L - 1)
    asym = torch.clamp(alat_q.detach().reshape(B, cfg.S, -1) + cfg.L // 2, 0, cfg.L - 1)
    bits = estimate_bits_from_pmf(pmf, sym.long()) + estimate_bits_from_pmf(apmf, asym.long())
    fbpp = bits / (B * N)

    pc_pred = (patches_pred.reshape(B, cfg.S, cfg.k, 3)
               + rec[:, :, None, :]).reshape(B, cfg.S * cfg.k, 3)
    loss_geo, aux = rate_distortion_loss(pc_pred, geo.pc01, fbpp, lam)

    with torch.no_grad():
        _, nn_idx = nearest_neighbor(pc_pred.detach(), geo.pc01)
    target = torch.gather(rgb_batch, 1, nn_idx[..., None].expand(-1, -1, 3))
    color = torch.mean(torch.mean((rgb_pred.reshape(B, -1, 3) - target) ** 2, dim=(1, 2)))
    aux["color_mse"] = color
    aux["bpp"] = (geo.octree.total_bits.sum() + bits) / (B * N)
    return loss_geo + color, aux


@dataclasses.dataclass
class AttrTrainState(TrainState):
    """TrainState with the colour autoencoder and the attribute probability
    model beside the geometry models, all four under one Adam."""

    attr: nn.Module = None
    attr_prob: nn.Module = None

    def named_parameters(self):
        return (super().named_parameters()
                + [(f"attr.{n}", p) for n, p in self.attr.named_parameters()]
                + [(f"attr_prob.{n}", p) for n, p in self.attr_prob.named_parameters()])


def create_attr_train_state(seed: int, cfg: CodecConfig, tx: AdamSchedule, d_a: int = 16,
                            device: str | torch.device = "cuda") -> AttrTrainState:
    """The IPDAE models with seeded weights (seed) and the attribute models
    (seed + 1), as pcc_tpu's train_attributes seeds them, in train mode on
    `device`, and a fresh Adam over all four."""
    dev = resolve_device(device)
    mods = []
    for (a, b), (sa, sb) in ((make_models(cfg), init_params(seed, cfg)),
                             (make_attr_models(cfg, d_a), init_attr_params(seed + 1, cfg, d_a))):
        a.load_state_dict(sa)
        b.load_state_dict(sb)
        mods += [a.to(dev).train(), b.to(dev).train()]
    ae, prob, attr, attr_prob = mods
    optimizer = tx.build([p for m in mods for p in m.parameters()])
    return AttrTrainState(ae=ae, prob=prob, optimizer=optimizer, attr=attr, attr_prob=attr_prob)


def build_attr_train_step(cfg: CodecConfig, tx: AdamSchedule):
    """Returns train_step(state, batch, rgb_batch, starts, lam) -> (state,
    aux): one forward, backward and Adam update of `state` in place at the
    learning rate of the schedule `tx`; aux holds loss, chamfer, fbpp,
    color_mse, bpp as 0-d tensors on the device."""

    def train_step(state: AttrTrainState, batch, rgb_batch, starts, lam: float):
        state.optimizer.zero_grad(set_to_none=False)
        loss, aux = attr_rd_forward(state, batch, rgb_batch, starts, lam, cfg)
        loss.backward()
        state.apply_gradients(tx)
        aux["loss"] = loss
        return state, {k: v.detach() for k, v in aux.items()}

    return train_step
