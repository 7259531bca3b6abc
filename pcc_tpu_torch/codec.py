"""Patch codec: clouds <-> (.p.bin, .s.bin, .c.bin) streams (counterpart of
pcc_tpu/codec.py, integer CDF mode), for both model families of
CodecConfig.model, in either CodecConfig.compute_dtype (bf16 changes the
networks' arithmetic, so the latents and .p.bin, and not the skeleton, the
.s.bin / .c.bin or the integer CDFs).

Encode, per batch of clouds on the device: the 10-bit packed upload ->
normalize -> FPS (CUDA kernel, ops/fps.py) -> octree analysis -> KNN
patches -> the family's encoder -> int8 symbols, and the integer
probability model's weights. The host turns the weights into CDF rows with
integer ops and range-codes the symbols. "AE" (IPDAE): the patch encoder
kernel (ops/sa_cuda.py) and coding/iprob.py. "PPPF-AE": three PN++
set-abstraction stages, each the fused stage kernel (ops/pppf_sa_cuda.py)
with the FPS kernel inside the second and third, and coding/iprob_pppf.py.

Decode: the host parses the skeleton bits; the device computes the integer
weights from the skeleton alone; the host range-decodes the symbols; the
device runs the family's decoder (IPDAE: the patch decoder kernel,
ops/decoder_cuda.py, k points per patch; PPPF-AE: FoldingNet, plain
products, d * d points per patch) and returns int8 offsets around each
skeleton point, which the host adds and denormalizes.

In a process group (parallel/mesh.py; the CLIs' --devices N) each rank
codes its contiguous shard of every dispatch batch, the batches keeping the
boundaries one device gives, and every rank gets every cloud's result in
input order (pcc_tpu's mesh Codec). Streams are byte-identical whatever the
number of ranks: the integer coding weights are bit-exact, and each cloud's
symbols do not depend on the other clouds of its batch.

On-disk contract (reference compress.py:139-152, same bytes as pcc_tpu):
  {name}.p.bin  — range-coded latents
  {name}.s.bin  — packed octree occupancy bits
  {name}.c.bin  — float32[4]: center xyz + longest extent
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pcc_tpu_torch.coding import rangecoder
from pcc_tpu_torch.coding.iprob import (bundle_to_device, convert_prob_params,
                                        iprob_pmf_weights, weights_to_cdf_rows)
from pcc_tpu_torch.coding.iprob_pppf import convert_pppf_prob_params, pppf_pmf_weights
from pcc_tpu_torch.coding.octree import OctreeResult, octree_analyze
from pcc_tpu_torch.coding.octree_host import (codes_to_points, emit_octree_bits,
                                              pack_bits, parse_octree_bits,
                                              unpack_bits)
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.device import resolve_device
from pcc_tpu_torch.models.ipdae import ConditionalProbabilityModel, PatchAE
from pcc_tpu_torch.models.layers import torch_dense_init_
from pcc_tpu_torch.models.pppf import PPPF_AE, PPPFConditionalProbabilityModel
from pcc_tpu_torch.ops.fps import fps_batch
from pcc_tpu_torch.ops.knn import knn_points
from pcc_tpu_torch.ops.normalize import normalize
from pcc_tpu_torch.parallel.mesh import merge_shards, shard_batch
from pcc_tpu_torch.weights import to_jax_params

# scale / 1023.0 as XLA compiles it in pcc_tpu: a product with the float32
# reciprocal of the constant
_INV_1023 = float(np.float32(1.0) / np.float32(1023.0))


def make_models(cfg: CodecConfig):
    """The (autoencoder, float probability model) modules of cfg.model, the
    autoencoder computing in cfg.compute_dtype, and so does the IPDAE
    probability model where it trains (in the codec it only holds the
    weights the integer model is converted from)."""
    if cfg.model == "PPPF-AE":
        return (PPPF_AE(K=cfg.K, k=cfg.k, d=cfg.d, L=cfg.L, compute_dtype=cfg.compute_dtype),
                PPPFConditionalProbabilityModel(d=cfg.d, L=cfg.L))
    return (PatchAE(K=cfg.K, k=cfg.k, d=cfg.d, L=cfg.L, sa_knn=cfg.sa_knn,
                    compute_dtype=cfg.compute_dtype),
            ConditionalProbabilityModel(d=cfg.d, L=cfg.L, compute_dtype=cfg.compute_dtype))


def init_params(seed: int, cfg: CodecConfig):
    """Random (autoencoder, probability model) state_dicts from a seeded
    torch.Generator, with torch's Linear/Conv default init (BatchNorm at its
    defaults)."""
    g = torch.Generator().manual_seed(seed)
    ae, prob = make_models(cfg)
    torch_dense_init_(ae, g)
    torch_dense_init_(prob, g)
    return ae.state_dict(), prob.state_dict()


class EncodeResult(NamedTuple):
    sym: torch.Tensor           # [B, S, d] int8 symbols in [0, L)
    weights: torch.Tensor       # [B, S, d, L] int32 Q16 coding weights
    sorted_codes: torch.Tensor  # [B, S] int32 max-depth Morton codes, descending
    depth: torch.Tensor         # [B] int32
    center: torch.Tensor        # [B, 3]
    longest: torch.Tensor       # [B]


def pack_clouds_u10(pcs: np.ndarray):
    """[B, N, 3] f32 -> (uint32 [B, N] with x | y<<10 | z<<20, lo [B, 3],
    scale [B, 3]): 10-bit fixed point against each cloud's bounding box."""
    lo = pcs.min(axis=1)
    scale = np.maximum(pcs.max(axis=1) - lo, 1e-12).astype(np.float32)
    q = np.rint((pcs - lo[:, None, :])
                * (1023.0 / scale)[:, None, :]).astype(np.uint32)
    return (q[..., 0] | (q[..., 1] << 10) | (q[..., 2] << 20),
            lo.astype(np.float32), scale)


def pack_encode_upload(pcs: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """[B, N, 3] f32 + FPS starts [B] -> one uint32 [B, N+7] row per cloud
    (q u10x3 | lo bits x3 | scale bits x3 | fps start). The quantization is
    part of what gets coded: the streams depend on it."""
    q, lo, scale = pack_clouds_u10(pcs)
    B = q.shape[0]
    return np.concatenate([
        q, lo.view(np.uint32), scale.view(np.uint32),
        np.ascontiguousarray(np.asarray(starts, np.int32).reshape(B, 1))
        .view(np.uint32),
    ], axis=1)


def unpack_encode_upload(packed: torch.Tensor, N: int):
    """Device inverse of pack_encode_upload on its int32 view [B, N+7] ->
    clouds [B, N, 3] f32 and starts [B] int32.

    The coordinates are v * step + lo with step = scale * f32(1/1023), as
    pcc_tpu's XLA program computes them: x and y as one fused multiply-add,
    z as a rounded product and then a rounded sum (XLA's CPU program
    contracts the first two and not the third). The fused form is the
    float64 sum of the exact float64 product (10 x 24 bits) rounded to
    float32; the unfused one is two float32 operations, two PyTorch kernels
    on the card, so neither device contracts them. These are the values
    pcc_tpu's normalization takes its bounding box (the .c.bin header) from;
    its normalized coordinates it computes from upload_values."""
    v, step, lo = _upload_terms(packed, N)
    fused = (v[..., :2].to(torch.float64) * step[:, None, :2].to(torch.float64)
             + lo[:, None, :2].to(torch.float64)).to(torch.float32)
    unfused = v[..., 2:].to(torch.float32) * step[:, None, 2:] + lo[:, None, 2:]
    return torch.cat([fused, unfused], dim=-1), packed[:, N + 6]


def upload_values(packed: torch.Tensor, N: int) -> torch.Tensor:
    """The clouds [B, N, 3] of an upload as pcc_tpu's encode program feeds
    them to the normalization's elementwise pass: there XLA's CPU program
    contracts v * step + lo into a fused multiply-add for all three
    coordinates, z too (its max / min reductions read unpack_encode_upload's
    values). Found from pcc_tpu's streams: on eval/gen_rooms.py's
    100,000-point room only this pair reproduces its .s.bin
    (tests/test_torch_port_codec.py)."""
    v, step, lo = _upload_terms(packed, N)
    return (v.to(torch.float64) * step[:, None, :].to(torch.float64)
            + lo[:, None, :].to(torch.float64)).to(torch.float32)


def _upload_terms(packed: torch.Tensor, N: int):
    """(v [B, N, 3] int, step [B, 3], lo [B, 3]) of an upload's int32 view."""
    q = packed[:, :N]
    lo = packed[:, N:N + 3].contiguous().view(torch.float32)
    scale = packed[:, N + 3:N + 6].contiguous().view(torch.float32)
    v = torch.stack([q & 1023, (q >> 10) & 1023, (q >> 20) & 1023], dim=-1)
    return v, scale * _INV_1023, lo


class Geometry(NamedTuple):
    pc01: torch.Tensor          # [B, N, 3] normalized clouds (the FPS input)
    center: torch.Tensor        # [B, 3]
    longest: torch.Tensor       # [B]
    octree: OctreeResult        # octree analysis of the FPS skeletons
    patches: torch.Tensor       # [B*S, K, 3] scaled patches (the encoder input)
    knn_idx: torch.Tensor       # [B, S, K] each patch's points in pc01 (attrib.py's colours)


def encode_geometry(pcs: torch.Tensor, fps_starts: torch.Tensor,
                    cfg: CodecConfig, values: torch.Tensor | None = None) -> Geometry:
    """The model-independent half of the encoder (train.py:175-192):
    normalize -> FPS -> octree analysis -> KNN patches around the *decoded*
    skeleton (train.py:185-189), for [B, N, 3] clouds. values: the clouds
    the normalized coordinates are computed from, where they differ from
    those its bounding box is taken on (an upload: upload_values)."""
    pc01, center, longest = normalize(pcs, cfg.margin, values)
    pc01 = pc01.contiguous()
    idx = fps_batch(pc01, cfg.S, fps_starts)                        # [B, S]
    sampled = torch.gather(pc01, 1, idx.long()[..., None].expand(-1, -1, 3))
    octree = octree_analyze(sampled, cfg.N, cfg.min_bpp, cfg.max_depth)
    rec = octree.rec_xyz
    _, knn_idx, grouped = knn_points(rec, pc01, K=cfg.K, return_nn=True)
    patches = (grouped - rec[:, :, None, :]) * cfg.patch_scale      # [B, S, K, 3]
    B, S = patches.shape[:2]
    return Geometry(pc01, center, longest, octree,
                    patches.reshape(B * S, cfg.K, 3).contiguous(), knn_idx)


def integer_pmf_weights(bundle, rec_xyz: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """Family dispatch of the integer probability model: [B, S, 3] skeletons
    -> [B, S, d, L] int32 Q16 weights, bit-equal on any device."""
    if cfg.model == "PPPF-AE":
        return pppf_pmf_weights(bundle, rec_xyz)
    return iprob_pmf_weights(bundle, rec_xyz)


def encode_clouds(ae, bundle, pcs: torch.Tensor, fps_starts: torch.Tensor,
                  cfg: CodecConfig, values: torch.Tensor | None = None) -> EncodeResult:
    """Batched analysis transform [B, N, 3] -> EncodeResult
    (reference compress.py:78-136 for all clouds and patches at once);
    values as for encode_geometry."""
    geo = encode_geometry(pcs, fps_starts, cfg, values)
    B = pcs.shape[0]
    latent = ae.encode(geo.patches)                                 # [B*S, d]
    sym = torch.clamp(torch.round(latent) + cfg.L // 2, 0, cfg.L - 1)
    return EncodeResult(
        sym=sym.to(torch.int8).reshape(B, -1, cfg.d),
        weights=integer_pmf_weights(bundle, geo.octree.rec_xyz, cfg),
        sorted_codes=geo.octree.sorted_codes,
        depth=geo.octree.depth,
        center=geo.center,
        longest=geo.longest,
    )


def decode_clouds_packed(ae, sym: torch.Tensor, cfg: CodecConfig):
    """Batched synthesis transform: [B, S, d] symbols -> (int8 patch offsets
    [B, S, k, 3], per-patch scale [B, S, 3]) around each skeleton point (d * d
    points per patch instead of k for PPPF-AE); the host adds the skeleton it
    parsed and denormalizes."""
    B, S = sym.shape[:2]
    latent_q = (sym.to(torch.float32) - cfg.L // 2).reshape(B * S, cfg.d)
    patches = ae.decode(latent_q)                                  # [B*S, k | d*d, 3]
    # / patch_scale as XLA compiles it: a product with the f32 reciprocal
    inv_scale = float(np.float32(1.0) / np.float32(cfg.patch_scale))
    off = patches.reshape(B, S, -1, 3) * inv_scale
    scale = torch.clamp_min(off.abs().amax(dim=2), 1e-12)          # [B, S, 3]
    q = torch.round(off / scale[:, :, None, :] * 127.0).to(torch.int8)
    return q, scale


class Codec:
    """Batched compress / decompress of point clouds on one device, or on
    this rank's device in a process group (module docstring).

    Clouds of equal size share one device batch of up to `batch_size`
    clouds; the host serializes each batch's streams after the device
    computed it."""

    def __init__(self, cfg: CodecConfig, ae_state, prob_state,
                 batch_size: int = 64, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = batch_size
        ae, prob = make_models(cfg)
        ae.load_state_dict(ae_state)
        prob.load_state_dict(prob_state)
        self.ae = ae.to(self.device).eval()
        # the float probability model is converted once, on the host, into
        # the integer bundle whose CDFs are byte-identical on any device
        _, prob_tree = to_jax_params(None, prob.state_dict())
        if cfg.model == "PPPF-AE":
            raw = convert_pppf_prob_params(prob_tree, cfg.d, cfg.L, S=cfg.S)
        else:
            raw = convert_prob_params(prob_tree, cfg.d, cfg.L)
        self.bundle = bundle_to_device(raw, self.device)

    # ------------------------------------------------------------- encode --

    @torch.inference_mode()
    def encode_batch(self, pcs: np.ndarray, starts: np.ndarray) -> EncodeResult:
        """One device batch: [B, N, 3] clouds + FPS starts -> EncodeResult on
        the device."""
        N = pcs.shape[1]
        packed = pack_encode_upload(np.asarray(pcs, np.float32), starts)
        dev = torch.from_numpy(packed.view(np.int32)).to(self.device)
        clouds, fps_starts = unpack_encode_upload(dev, N)
        return encode_clouds(self.ae, self.bundle, clouds, fps_starts,
                             self.cfg.with_n(N), upload_values(dev, N))

    def serialize(self, res: EncodeResult):
        """EncodeResult of a batch -> list of (p, s, c) bytes per cloud."""
        sym, w, codes, depths, centers, longests = (
            t.cpu().numpy() for t in (res.sym, res.weights, res.sorted_codes,
                                      res.depth, res.center, res.longest))
        cdfs = weights_to_cdf_rows(w)
        codes = codes.astype(np.int64)
        out = []
        for j in range(sym.shape[0]):
            depth = int(depths[j])
            p_bytes = rangecoder.encode_quantized_cdf(cdfs[j], sym[j].astype(np.int16))
            cj = codes[j] >> (3 * (self.cfg.max_depth - depth))
            if len(np.unique(cj)) != cj.shape[0]:
                raise ValueError(
                    f"cloud {j} of the batch: octree at depth {depth} maps "
                    f"{cj.shape[0]} skeleton points to {len(np.unique(cj))} "
                    "distinct voxels (coincident FPS points, no lossless "
                    "depth); the stream would be undecodable")
            s_bytes = pack_bits(emit_octree_bits(cj, depth))
            header = np.zeros(4, dtype=np.float32)
            header[:3] = centers[j]
            header[3] = longests[j]
            out.append((p_bytes, s_bytes, header.tobytes()))
        return out

    def compress_many(self, clouds, fps_starts=None):
        """Compress a list of [N, 3] clouds -> list of (p, s, c) bytes."""
        return self._compress_many(clouds, (), fps_starts)

    def _compress_many(self, clouds, extras, fps_starts):
        """Clouds of equal size in batches of up to batch_size through
        encode_batch(clouds, *extras, starts) and serialize, in input order.
        `extras`: per-cloud lists beside the clouds that encode_batch takes
        stacked (AttrCodec's colours). In a process group this rank codes
        its shard of each batch."""
        if fps_starts is None:
            fps_starts = [0] * len(clouds)
        results: list = [None] * len(clouds)
        by_n: dict[int, list[int]] = {}
        for i, pc in enumerate(clouds):
            by_n.setdefault(int(pc.shape[0]), []).append(i)
        for idxs in by_n.values():
            for lo in range(0, len(idxs), self.batch_size):
                batch = shard_batch(idxs[lo:lo + self.batch_size])
                if not batch:
                    continue
                res = self.encode_batch(
                    *(np.stack([col[i] for i in batch]) for col in (clouds, *extras)),
                    np.asarray([fps_starts[i] for i in batch], np.int32))
                for i, blob in zip(batch, self.serialize(res)):
                    results[i] = blob
        return merge_shards(results)

    # ------------------------------------------------------------- decode --

    @torch.inference_mode()
    def decode_symbols(self, recs: np.ndarray, p_streams) -> np.ndarray:
        """Skeletons [B, S, 3] + .p.bin streams -> symbols [B, S, d] int8:
        integer coding weights on the device, CDF rows and the range
        decoder on the host."""
        rec_t = torch.from_numpy(np.ascontiguousarray(recs, np.float32)).to(self.device)
        w = integer_pmf_weights(self.bundle, rec_t, self.cfg).cpu().numpy()
        cdfs = weights_to_cdf_rows(w)
        return np.stack([rangecoder.decode_quantized_cdf(cdfs[j], p)
                         for j, p in enumerate(p_streams)]).astype(np.int8)

    @torch.inference_mode()
    def decode_batch(self, syms: np.ndarray, recs: np.ndarray, headers: np.ndarray):
        """Symbols [B, S, d] + skeletons [B, S, 3] + .c.bin headers [B, 4]
        -> decoded clouds [B, S*k, 3] f32 ([B, S*d*d, 3] for PPPF-AE)."""
        B, S = syms.shape[:2]
        cfg = self.cfg.with_n(S * self.cfg.k)   # decode side: N = S * k
        q, scale = decode_clouds_packed(
            self.ae, torch.from_numpy(syms).to(self.device), cfg)
        q, scale = q.cpu().numpy(), scale.cpu().numpy()
        pc01 = (q.astype(np.float32) * (scale / 127.0)[:, :, None, :]
                + recs[:, :, None, :]).reshape(B, -1, 3)
        margin = self.cfg.margin
        return (pc01 - 0.5) * (headers[:, None, 3:4] / (1.0 - margin)) \
            + headers[:, None, :3]

    def decode_streams(self, recs: np.ndarray, headers: np.ndarray, streams):
        """One batch: skeletons [B, S, 3], .c.bin headers [B, 4] and the
        clouds' stream tuples -> one decoded cloud per tuple."""
        syms = self.decode_symbols(recs, [s[0] for s in streams])
        return self.decode_batch(syms, recs, headers)

    def decompress_many(self, streams):
        """Decompress a list of (p, s, c) byte triples -> list of [M, 3],
        one decode_streams output per triple. In a process group this rank
        decodes its shard of each batch."""
        results: list = [None] * len(streams)
        parsed = []
        for st in streams:
            codes, depth = parse_octree_bits(unpack_bits(st[1]))
            parsed.append((codes_to_points(codes, depth),
                           np.frombuffer(st[2], dtype=np.float32)))
        by_s: dict[int, list[int]] = {}
        for i, (rec, _) in enumerate(parsed):
            by_s.setdefault(rec.shape[0], []).append(i)
        for idxs in by_s.values():
            for lo in range(0, len(idxs), self.batch_size):
                batch = shard_batch(idxs[lo:lo + self.batch_size])
                if not batch:
                    continue
                recs = np.stack([parsed[i][0] for i in batch])
                headers = np.stack([parsed[i][1] for i in batch])
                decoded = self.decode_streams(recs, headers, [streams[i] for i in batch])
                for i, out in zip(batch, decoded):
                    results[i] = out
        return merge_shards(results)
