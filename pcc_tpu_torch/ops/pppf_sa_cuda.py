"""The fused PointNet++ set-abstraction stage and its backward (counterpart
of pcc_tpu/ops/pppf_sa_pallas.py: TPU kernels _stage_kernel, entry
pppf_sa_fused, and _stage_bwd_kernel, entry pppf_sa_trainable).

`pppf_sa_fused` launches the CUDA kernels of csrc/pppf_sa_stage.cu on CUDA
tensors and runs `pppf_sa_plain`, the same function in plain PyTorch, on
CPU tensors: per patch and query point, the nsample nearest of the patch's
N points, their rows gathered ("pppf": [feat | xyz] uncentred, slots beyond
the radius read point 0; "pppe": [xyz - query | feat], no mask), the
Conv + BatchNorm(eval) + ReLU stack and the max over samples ->
[P, S, C_out]. Selection and mask are bit-equal between the two (the same
float32 operations in the same order); the products sum in another order,
so outputs agree to float32 rounding. `pppf_sa_points` and
`pppe_sa_points` are the per-point forms the kernels compute, each equal to
the per-slot plain version up to the order of its sums. With bf16=True
the bf16 instance of the kernel runs (`pppf_sa_plain(..., bf16=True)` on
the CPU), rounding where pcc_tpu's bf16 stage rounds
(pppf_sa_pallas.py:60-120): W (`bf16_layers`), each layer's input rows
(in "pppe" the xyz part after its centring on the query) and each relu
output; b and the BatchNorm terms stay float32; in its store mode
("pppf") it keeps the rounded inputs for the bf16 backward.

`pppf_sa_bwd` is the stage's gradient against a cotangent [P, S, C_out],
layout "pppf", BatchNorm in its eval-affine form (frozen running
statistics): the CUDA kernel csrc/pppf_sa_stage_bwd.cu on CUDA tensors,
`pppf_sa_bwd_plain` on CPU tensors; with bf16=True its bf16 instance
(`pppf_sa_bwd_plain_bf16`: the cotangent per slot below the max routing,
as pcc_tpu's bf16 backward rounds it). `pppf_sa_trainable` is the
differentiable stage that training calls: forward `pppf_sa_fused`, backward
`pppf_sa_bwd`. The kernels' design notes (what bounds them on an H100, what
they do about that) are at the top of their sources.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops.bf16 import round_bf16
from pcc_tpu_torch.ops.certified import cached_frags
from pcc_tpu_torch.ops.knn import ball_query, knn_gather, select_nearest, sq_dists
from pcc_tpu_torch.ops.sa_cuda import fma_matmul
from pcc_tpu_torch.ops.tf32_mma import wgrad_part_floats

_ARGTYPES = ([cuda_lib.PTR] * 4 + [cuda_lib.INT] * 5 + [ctypes.c_float]
             + [cuda_lib.INT] * 2 + [cuda_lib.PTR] * 8)
_BF16_ARGTYPES = ([cuda_lib.PTR] * 4 + [cuda_lib.INT] * 5 + [ctypes.c_float] + [cuda_lib.INT]
                  + [cuda_lib.PTR] * 3)
_BWD_ARGTYPES = ([cuda_lib.PTR] * 4 + [cuda_lib.INT] * 5 + [ctypes.c_float] + [cuda_lib.INT]
                 + [cuda_lib.PTR] * 10 + [ctypes.c_longlong, cuda_lib.INT, cuda_lib.PTR])
_BF16_SAVE_ARGTYPES = _BF16_ARGTYPES[:-1] + [cuda_lib.PTR] * 5
_BF16_SERVE_ARGTYPES = _BF16_ARGTYPES[:-1] + [cuda_lib.PTR] * 2   # + the packed weights
_PPPE_BF16_ARGTYPES = ([cuda_lib.PTR] * 4 + [cuda_lib.INT] * 6 + [cuda_lib.PTR] * 4)
_BWD_BF16_ARGTYPES = _BWD_ARGTYPES[:-1] + [cuda_lib.PTR] * 4 + [cuda_lib.INT, cuda_lib.PTR]
LAYOUTS = ("pppf", "pppe")
MAX_SLOTS = 254        # csrc/pppf_sa_stage_bwd.cu: kMaxSlots, the bf16 backward's nsample
CHAIN_BYTES = 1 << 29  # the bf16 backward's per-slot buffers, at most (one patch at least)
MAX_POINTS = 1024      # csrc/pppf_sa_stage.cu: kMaxN
MAX_LAYERS = 6         # kMaxLayers
MIN_TILE_ROWS = 8      # kTM
# the kernel's smallest tile (MIN_TILE_ROWS rows of both activation buffers,
# one query's maxima, indices and distances) must fit in a block's shared memory
SMEM_WORDS = 227 * 1024 // 4
PLAIN_ELEMS = 1 << 27  # elements of the widest grouped activation per pass of the plain version
# "pppe": the slot kernel's tiles (warps of 32 rows down, n8 tiles a warp),
# in the order csrc/pppf_sa_stage.cu::launch_pppe tries them
PPPE_PLANS = ((4, 8), (4, 16), (2, 16), (1, 16))
# activations within NEAR_TIE of a relu's 0 or of a maximum (relative to the
# largest of their channel) are recomputed in the kernels' arithmetic
NEAR_TIE = 1e-4


def fold_bn(bn, eps: float = 1e-5):
    """A BatchNorm's (weight, bias, running_mean, running_var) -> (mean, mul,
    bias) with mul = rsqrt(var + eps) * weight: the float32 expression of
    pcc_tpu's fold_bn, so the eval-mode affine is (h - mean) * mul + bias on
    both sides."""
    mul = torch.rsqrt(bn.running_var.float() + eps) * bn.weight.float()
    return bn.running_mean.float(), mul, bn.bias.float()


def _radius2(radius: float) -> float:
    """radius * radius as the float32 the comparison sees."""
    return float(np.float32(radius * radius))


def bf16_layers(layers) -> list:
    """layers with each W rounded to bf16 (b and the BatchNorm terms
    float32): the layers the bf16 stage takes."""
    return [(round_bf16(w), *rest) for w, *rest in layers]


def pppf_sa_plain(new_xyz: torch.Tensor, xyz: torch.Tensor, feat, layers, *,
                  nsample: int, radius: float, layout: str = "pppf",
                  bf16: bool = False) -> torch.Tensor:
    """new_xyz [P, S, 3], xyz [P, N, 3], feat [P, N, C] or None, layers a
    list of (W [cin, cout], b, mean, mul, bias) -> [P, S, C_out] f32. Runs
    a chunk of patches at a time to bound the memory of the grouped
    activations [chunk, S, nsample, C]. bf16 (pcc_tpu's
    pppf_sa_pallas.py:90-102): W a bf16 value (`bf16_layers`), each layer's
    input rows rounded to bf16 ("pppe": the xyz part after its centring),
    a float32 product + b, the BatchNorm affine and relu in float32, the
    output rounded to bf16."""
    if layout not in LAYOUTS:
        raise ValueError(f"pppf_sa: unknown layout {layout!r}")
    P, S, _ = new_xyz.shape
    widest = max([xyz.shape[-1] + (0 if feat is None else feat.shape[-1])]
                 + [w.shape[1] for w, *_ in layers])
    chunk = max(1, PLAIN_ELEMS // (S * nsample * widest))
    outs = []
    for s in range(0, P, chunk):
        q, pts = new_xyz[s:s + chunk], xyz[s:s + chunk]
        f = None if feat is None else feat[s:s + chunk]
        if layout == "pppe":
            idx = select_nearest(sq_dists(q, pts), nsample)        # [c, S, ns]
            x = knn_gather(pts, idx) - q[:, :, None, :]
            if f is not None:
                x = torch.cat([x, knn_gather(f, idx)], dim=-1)
        else:
            # out-of-radius slots read point 0, on exactly recomputed distances
            idx = ball_query(q, pts, nsample, radius)
            x = knn_gather(pts if f is None else torch.cat([f, pts], dim=-1), idx)
        for w, b, mean, mul, bias in layers:
            if bf16:
                x = round_bf16(x)
            x = torch.relu(((x @ w + b) - mean) * mul + bias)
        outs.append((round_bf16(x) if bf16 else x).amax(dim=2))
    return torch.cat(outs)


def stage_flops(P: int, S: int, N: int, nsample: int, widths, layout: str = "pppf") -> float:
    """Operations the stage needs: the stack on its rows (2 per multiply-add,
    5 per output of a layer: bias, the BatchNorm affine, relu), 9 per
    (query, point) distance pair where a selection is made (nsample < N;
    otherwise every point is taken), and one comparison per (query, slot,
    output channel) for the max. "pppf" as the kernel computes it per
    point: a slot's activations are its point's, so the stack runs on the
    P * N point rows. "pppe": a slot's row [x_j - c | f_j] is centred on
    its query, but the first layer is linear, W1 [x_j - c | f_j] =
    W1 [x_j | f_j] - W1[:3] c, so its products need only the P * N point
    rows and a 3 x C1 term per query, then one subtraction per (slot, C1
    channel); its bias, BatchNorm and relu, and every later layer, run on
    the P * S * nsample slot rows."""
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    dist = 9.0 * N if nsample < N else 0.0
    if layout == "pppe":
        c1 = widths[1]
        per_slot = 2.0 * (macs - widths[0] * c1) + 5.0 * sum(widths[1:]) + c1
        rows = P * N * 2.0 * widths[0] * c1 + P * S * (2.0 * 3 * c1 + nsample * per_slot)
    else:
        rows = P * N * (2.0 * macs + 5.0 * sum(widths[1:]))
    return rows + P * S * (dist + nsample * widths[-1])


def pppe_work(P: int, S: int, N: int, nsample: int, widths):
    """(float32 operations, operations of the products) of the "pppe" stage
    as `stage_flops` counts them, split as csrc/pppf_sa_stage.cu runs them:
    the first layer's product per point and layers 2 .. L per slot as
    3xTF32 products on the tensor cores (three TF32 products each), the
    rest (the query term of the first layer, the BatchNorm affines and relu,
    the selection, the max) in float32 on the CUDA cores."""
    first = widths[0] * widths[1]
    later = sum(a * b for a, b in zip(widths[1:-1], widths[2:]))
    products = 2.0 * (P * N * first + P * S * nsample * later)
    return stage_flops(P, S, N, nsample, widths, layout="pppe") - products, products


def pppe_sa_points(new_xyz: torch.Tensor, xyz: torch.Tensor, feat, layers, *,
                   nsample: int) -> torch.Tensor:
    """The "pppe" stage as csrc/pppf_sa_stage.cu computes it: the first
    layer's feature block once per point, Y = feat W1[3:], then per slot
    (query c, point j) Y[j] + (x_j - c) W1[:3] from the centred coordinates,
    the first layer's bias, BatchNorm and relu, the later layers and the max
    over each query's nsample nearest (slots beyond N read point 0) ->
    [P, S, C_out], in the inputs' dtype. Equal to `pppf_sa_plain(...,
    layout="pppe")`, which takes the first layer's product on the gathered
    rows [x_j - c | f_j], up to the order of its sums."""
    w1, b1, mean1, mul1, bias1 = layers[0]
    y = None if feat is None else feat @ w1[3:]                      # [P, N, C1]
    S, widest = new_xyz.shape[1], max(w.shape[1] for w, *_ in layers)
    chunk = max(1, PLAIN_ELEMS // (S * nsample * widest))
    outs = []
    for s in range(0, new_xyz.shape[0], chunk):
        q, pts = new_xyz[s:s + chunk], xyz[s:s + chunk]
        idx = select_nearest(sq_dists(q, pts), nsample)              # [c, S, ns]
        x = (knn_gather(pts, idx) - q[:, :, None, :]) @ w1[:3]
        if y is not None:
            x = knn_gather(y[s:s + chunk], idx) + x
        x = torch.relu(((x + b1) - mean1) * mul1 + bias1)
        for w, b, mean, mul, bias in layers[1:]:
            x = torch.relu(((x @ w + b) - mean) * mul + bias)
        outs.append(x.amax(dim=2))
    return torch.cat(outs)


def pppf_sa_points(new_xyz: torch.Tensor, xyz: torch.Tensor, feat, layers, *, nsample: int,
                   radius: float, replay: bool = False, bf16: bool = False) -> torch.Tensor:
    """The "pppf" stage per point, as csrc/pppf_sa_stage.cu computes it: the
    layer stack once on each point's row [feat | xyz], then each query's max
    over the points its slots read (`ball_query`: masked slots and slots
    beyond N read point 0) -> [P, S, C_out]. With `replay` the stack is
    `stack_replay`, the kernels' float32 arithmetic (with bf16 the bf16
    kernels', bit for bit their outputs); otherwise plain products in the
    inputs' dtype. Equal to `pppf_sa_plain`, which evaluates the stack per
    slot, up to the order of the products' sums."""
    rows = xyz if feat is None else torch.cat([feat, xyz], dim=-1)
    if bf16 and not replay:
        raise ValueError("pppf_sa_points: bf16 is the replay's")
    if replay:
        act = stack_replay(rows, layers, bf16)[-1]
    else:
        act = rows
        for w, b, mean, mul, bias in layers:
            act = torch.relu(((act @ w + b) - mean) * mul + bias)
    S, cout = new_xyz.shape[1], act.shape[-1]
    chunk = max(1, PLAIN_ELEMS // (S * nsample * cout))
    return torch.cat([
        knn_gather(act[s:s + chunk], ball_query(new_xyz[s:s + chunk], xyz[s:s + chunk],
                                                 nsample, radius)).amax(dim=2)
        for s in range(0, xyz.shape[0], chunk)])


def _round4(v: int) -> int:
    return (v + 3) & ~3


def pppe_plan(widths, N: int, S: int, nsample: int):
    """The tile the "pppe" slot kernel takes for these layer widths, as
    csrc/pppf_sa_stage.cu::launch_pppe picks it: the first of PPPE_PLANS
    whose pass of columns is as wide as every layer between the first and
    the last, with the largest k-slab (32, 16, 8 rows) and then the most
    queries that fit in shared memory (two blocks an SM for (4, 8), else
    one) -> dict(wm, nt, ks, qb, smem_bytes), or None where none fits."""
    def pad8(v):
        return (v + 7) & ~7

    L, cout = len(widths) - 1, widths[-1]
    mid, widest = max(widths[2:-1], default=0), max(widths[1:-1], default=0)
    lda = pad8(widest) + 4 if L > 1 else 0
    limit = SMEM_WORDS * 4
    two = (limit + 1024) // 2 - 1024
    for wm, nt in PPPE_PLANS:
        rows, cw = 32 * wm, 8 * nt * (8 // wm)
        if mid > cw:
            continue
        for budget in ((two, limit) if nt == 8 else (limit,)):
            for ks in (32, 16, 8):
                def words(qb):
                    dist = qb * (N + min(N, nsample)) if nsample < N else 0
                    tiles = rows * lda + 2 * ks * (((cw + 15) & ~15) + 8) if L > 1 else 0
                    return (_round4(max(dist, tiles)) + 4 * rows + qb * nsample + 4 * qb
                            + qb * cout)
                qb = min(rows // nsample if nsample <= rows else 1, S)
                while qb > 1 and 4 * words(qb) > budget:
                    qb -= 1
                if 4 * words(qb) <= budget:
                    return dict(wm=wm, nt=nt, ks=ks, qb=qb, smem_bytes=4 * words(qb))
    return None


def pppe_kernel(widths, N: int, S: int, nsample: int):
    """Which kernel the "pppe" layout takes at these widths: "slots" (the
    slot kernel, where `pppe_plan` finds a tile), "per_slot" (the per-slot
    kernel, where only its smallest tile fits in shared memory) or None (the
    wrapper raises)."""
    if pppe_plan(widths, N, S, nsample) is not None:
        return "slots"
    return "per_slot" if _per_slot_words(widths, N, nsample) <= SMEM_WORDS else None


def _per_slot_words(widths, N: int, nsample: int) -> int:
    """Shared memory (4-byte words) of the per-slot kernel's smallest tile:
    MIN_TILE_ROWS rows of both activation buffers, one query's maxima, slots,
    coordinates and selection scratch (csrc/pppf_sa_stage.cu::smem_words)."""
    pad4 = [_round4(v) for v in widths[:-1]]
    return (MIN_TILE_ROWS * (max(pad4[0::2]) + max(pad4[1::2], default=4)) + widths[-1]
            + nsample + (N + min(N, nsample) if nsample < N else 0) + 4)


def _check(new_xyz, xyz, feat, layers, nsample: int, layout: str, name: str = "pppf_sa_fused"):
    """Raise on what the kernel `name` does not take; return the layer
    widths."""
    if layout not in LAYOUTS:
        raise ValueError(f"{name}: unknown layout {layout!r}")
    cuda_lib.require_cuda(f"{name} new_xyz", new_xyz, torch.float32, 3)
    cuda_lib.require_cuda(f"{name} xyz", xyz, torch.float32, 3)
    P, S, _ = new_xyz.shape
    N = xyz.shape[1]
    C = 0
    if feat is not None:
        cuda_lib.require_cuda(f"{name} feat", feat, torch.float32, 3)
        C = feat.shape[2]
        if feat.shape[:2] != (P, N) or C == 0:
            raise ValueError(f"{name}: feat {tuple(feat.shape)} does not match "
                             f"xyz {tuple(xyz.shape)}")
    if (new_xyz.shape[2] != 3 or xyz.shape[2] != 3 or xyz.shape[0] != P or P == 0
            or S == 0 or not 0 < N <= MAX_POINTS or nsample <= 0
            or not 0 < len(layers) <= MAX_LAYERS):
        raise ValueError(
            f"{name}: unsupported new_xyz {tuple(new_xyz.shape)}, xyz "
            f"{tuple(xyz.shape)}, nsample={nsample}, {len(layers)} layers (N <= "
            f"{MAX_POINTS}, at most {MAX_LAYERS} layers)")
    widths = [C + 3]
    for lay in layers:
        w = lay[0]
        cuda_lib.require_cuda(f"{name} weight", w, torch.float32, 2)
        if w.shape[0] != widths[-1]:
            raise ValueError(f"{name}: weight {tuple(w.shape)} after width "
                             f"{widths[-1]}")
        for t in lay[1:]:
            cuda_lib.require_cuda(f"{name} bias/mean/mul", t, torch.float32, 1)
            if t.shape[0] != w.shape[1]:
                raise ValueError(f"{name}: vector {tuple(t.shape)} for weight "
                                 f"{tuple(w.shape)}")
        if any(t.data_ptr() % 16 for t in lay):
            raise ValueError(f"{name}: layer tensors must be 16-byte aligned")
        widths.append(w.shape[1])
    if layout == "pppe" and pppe_plan(widths, N, S, nsample) is not None:
        return widths
    words = _per_slot_words(widths, N, nsample)
    if words > SMEM_WORDS:
        raise ValueError(f"{name}: widths {widths} with nsample={nsample}, N={N} "
                         f"need {4 * words} bytes of shared memory for the smallest tile "
                         f"(limit {4 * SMEM_WORDS})")
    return widths


def pppf_sa_fused(new_xyz: torch.Tensor, xyz: torch.Tensor, feat, layers, *,
                  nsample: int, radius: float, layout: str = "pppf", save: bool = False,
                  bf16: bool = False):
    """One fused PN++ SA stage over a flat patch batch (pcc_tpu's
    pppf_sa_fused): new_xyz [P, S, 3] query centroids, xyz [P, N, 3], feat
    [P, N, C] or None, layers a list of (W [cin, cout], b, mean, mul, bias)
    with the BatchNorm folded by `fold_bn` -> [P, S, C_out] f32. The CUDA
    kernel on CUDA tensors, the plain version on CPU tensors. The "pppe"
    layout computes as `pppe_sa_points` does: the first layer's feature
    block once per point, into a scratch [P, N, C1] allocated here (none
    without features), then the slots, in the one launch; at widths where
    that kernel has no tile (`pppe_kernel`), the per-slot kernel.

    bf16: the bf16 instance, on layers whose W are bf16 values
    (`bf16_layers`): layout "pppf" (launch counter "pppf_sa_stage_bf16",
    and "pppf_sa_stage_bf16_save" in its store mode, which writes the
    rounded layer inputs that the bf16 backward's weight gradients read)
    and "pppe" (launch counter "pppe_sa_stage_bf16": the slot kernel or the
    per-slot kernel, as in float32).

    With `save` (layout "pppf"; the train step's forward), (out, saved):
    the kernel's store mode also writes what its backward would otherwise
    recompute, the ranked slots and every layer's activations, for
    `pppf_sa_bwd(..., saved=saved)`; the output is the same bit for bit.
    saved is None on CPU tensors and where the store mode does not apply
    (the per-slot kernel runs where the queries' masks do not fit)."""
    if save and layout != "pppf":
        raise ValueError("pppf_sa_fused: save applies to the \"pppf\" layout")
    if new_xyz.device.type == "cpu":
        out = pppf_sa_plain(new_xyz, xyz, feat, layers, nsample=nsample, radius=radius,
                            layout=layout, bf16=bf16)
        return (out, None) if save else out
    widths = _check(new_xyz, xyz, feat, layers, nsample, layout)
    P, S, _ = new_xyz.shape
    N = xyz.shape[1]
    dev = new_xyz.device
    out = torch.empty((P, S, widths[-1]), dtype=torch.float32, device=dev)
    bufs, done = None, ctypes.c_int(0)
    if save:
        ws = _bwd_workspace(P, S, N, nsample, widths)
        bufs = (torch.empty(ws["sel"], dtype=torch.int32, device=dev),
                torch.empty(ws["act"], dtype=torch.float32, device=dev),
                torch.empty(ws["t"], dtype=torch.float32, device=dev))
    # "pppe": the first layer's feature block, once per point, where the
    # slot kernel runs
    y = (torch.empty((P, N, widths[1]), dtype=torch.float32, device=dev)
         if layout == "pppe" and feat is not None
         and pppe_plan(widths, N, S, nsample) is not None else None)
    ptrs = (ctypes.c_void_p * (5 * len(layers)))(
        *[t.data_ptr() for lay in layers for t in lay])
    if bf16 and layout == "pppe":
        cuda_lib.launch("pppe_sa_stage_bf16", _PPPE_BF16_ARGTYPES, new_xyz.data_ptr(),
                        xyz.data_ptr(), None if feat is None else feat.data_ptr(),
                        out.data_ptr(), P, S, N, 0 if feat is None else feat.shape[2], nsample,
                        len(layers), ptrs, (ctypes.c_int * len(widths))(*widths),
                        None if y is None else y.data_ptr(), cuda_lib.stream_ptr(new_xyz))
        return out
    if bf16:
        args = [new_xyz.data_ptr(), xyz.data_ptr(), None if feat is None else feat.data_ptr(),
                out.data_ptr(), P, S, N, 0 if feat is None else feat.shape[2], nsample,
                _radius2(radius), len(layers), ptrs, (ctypes.c_int * len(widths))(*widths)]
        if not save:
            # each layer at least 16 deep packed for the tensor cores (its
            # columns to a multiple of 64: the kernel's widest warp item),
            # once per weights
            frags = cached_frags([lay[0] for lay in layers], n_align=64)
            fptrs = (ctypes.c_void_p * len(layers))(
                *[None if f is None else f.data_ptr() for f in frags])
            cuda_lib.launch("pppf_sa_stage_bf16", _BF16_SERVE_ARGTYPES, *args, fptrs,
                            cuda_lib.stream_ptr(new_xyz))
            return out
        cuda_lib.launch("pppf_sa_stage_bf16_save", _BF16_SAVE_ARGTYPES, *args,
                        *[b.data_ptr() for b in bufs], ctypes.addressof(done),
                        cuda_lib.stream_ptr(new_xyz))
        return out, (bufs if done.value else None)
    cuda_lib.launch(
        "pppf_sa_stage", _ARGTYPES, new_xyz.data_ptr(), xyz.data_ptr(),
        None if feat is None else feat.data_ptr(), out.data_ptr(), P, S, N,
        0 if feat is None else feat.shape[2], nsample, _radius2(radius),
        LAYOUTS.index(layout), len(layers), ptrs, (ctypes.c_int * len(widths))(*widths),
        *([b.data_ptr() for b in bufs] if save else [None] * 3),
        ctypes.addressof(done) if save else None, None if y is None else y.data_ptr(),
        cuda_lib.stream_ptr(new_xyz))
    if save:
        return out, (bufs if done.value else None)
    return out


def stack_replay(rows: torch.Tensor, layers, bf16: bool = False) -> list:
    """The layer stack on rows [..., cin] in the kernels' float32 arithmetic
    (csrc/pppf_sa_common.cuh): the product as fma_matmul, t = (z + b) - mean
    rounded twice, relu(fma(t, mul, beta)) with the fused multiply-add taken
    in float64 and rounded once to float32. bf16: the bf16 kernels' (rows
    rounded to bf16, each layer's output too; W bf16 values, `bf16_layers`).
    Returns every layer's output."""
    x, outs = (round_bf16(rows) if bf16 else rows), []
    for w, b, mean, mul, beta in layers:
        t = (fma_matmul(x, w) + b) - mean
        x = torch.relu((t.double() * mul.double() + beta.double()).to(torch.float32))
        if bf16:
            x = round_bf16(x)
        outs.append(x)
    return outs


def _kernel_choices(rows: torch.Tensor, idx: torch.Tensor, layers):
    """The choices the backward kernel makes for the points rows [c, N, cin]
    and slots idx [c, S, ns]: every layer's relu mask [c, N, width] and the
    last activations [c, N, C_out] that route each max. Computed in plain
    float32, except for the distinct rows whose choices depend on their last
    bits, which `stack_replay` recomputes in the kernels' arithmetic: a
    pre-activation within NEAR_TIE of 0, or a last activation within
    NEAR_TIE of a live maximum that another distinct row comes as close to.
    (Equal rows, such as the points FPS picks twice, tie exactly in any
    arithmetic.)"""
    uniq, inv = torch.unique(rows.flatten(0, 1), dim=0, return_inverse=True)
    rid = inv.view(rows.shape[:2])                                        # [c, N]
    x, outs, doubt = uniq, [], torch.zeros(len(uniq), dtype=torch.bool, device=rows.device)
    for w, b, mean, mul, beta in layers:
        a = ((x @ w + b) - mean) * mul + beta
        doubt |= (a.abs() <= NEAR_TIE * a.abs().amax(dim=0)).any(dim=-1)
        x = torch.relu(a)
        outs.append(x)
    ids = torch.gather(rid, 1, idx.flatten(1)).view(idx.shape)            # [c, S, ns]
    vals = x[ids]                                                         # [c, S, ns, C_out]
    top = vals.amax(dim=2, keepdim=True)
    near = (vals >= top - NEAR_TIE * x.amax(dim=0)) & (top > 0)
    rows_near = ids[..., None].expand_as(vals)
    tied = (torch.where(near, rows_near, len(uniq)).amin(dim=2)
            != torch.where(near, rows_near, -1).amax(dim=2))              # [c, S, C_out]
    slots = (near & tied[:, :, None, :]).any(dim=-1).to(torch.int32)      # [c, S, ns]
    doubt |= torch.zeros(len(uniq), dtype=torch.int32, device=rows.device).scatter_reduce_(
        0, ids.flatten(), slots.flatten(), reduce="amax").bool()
    if doubt.any():
        for out, exact in zip(outs, stack_replay(uniq[doubt], layers)):
            out[doubt] = exact
    return [o[rid] > 0 for o in outs], outs[-1][rid]


def pppf_sa_bwd_plain(new_xyz: torch.Tensor, xyz: torch.Tensor, feat, gout: torch.Tensor,
                      layers, *, nsample: int, radius: float):
    """The "pppf" stage's gradient against the cotangent gout [P, S, C_out],
    with BatchNorm's eval affine: (dxyz [P, N, 3], dfeat [P, N, C] or None,
    [(dW, db, dmul, dbeta)] per layer, summed over the patches). mean and
    new_xyz get no gradient.

    A slot's row is its point's [feat | xyz], uncentred, so the stack is
    evaluated once per point. The max over slots routes each (patch, query,
    channel) to the first slot, in selection order, that reaches the
    maximum, and only where it is > 0, as the kernel does. Float32 near-ties
    between distinct points can resolve differently in another summation
    order, and exact ties (every masked slot is a copy of point 0) are
    common, so the choices (the max routing and every relu mask) are the
    kernel's own (`_kernel_choices`); the gradients are then autograd
    through plain products with those masks, per point, against the summed
    cotangents each point wins. Runs a chunk of
    patches at a time to bound the memory of the gathered maxima."""
    leaves = [t.detach().requires_grad_(True) for lay in layers
              for t in (lay[0], lay[1], lay[3], lay[4])]
    P, S, _ = new_xyz.shape
    cout = layers[-1][0].shape[1]
    chunk = max(1, PLAIN_ELEMS // (S * nsample * cout))
    dxyz, dfeat, grads = [], [], None
    for s in range(0, P, chunk):
        pts = xyz[s:s + chunk].detach()
        f = None if feat is None else feat[s:s + chunk].detach()
        rows = pts if f is None else torch.cat([f, pts], dim=-1)          # [c, N, C+3]
        with torch.no_grad():
            idx = ball_query(new_xyz[s:s + chunk], pts, nsample, radius)  # [c, S, ns]
            masks, act = _kernel_choices(rows, idx, layers)
            vals = knn_gather(act, idx)                                   # [c, S, ns, C_out]
            top = vals.amax(dim=2, keepdim=True)
            slot = (vals == top).to(torch.int32).argmax(dim=2)            # first winner
            point = torch.gather(idx, 2, slot)                            # [c, S, C_out]
            g = torch.where(top.squeeze(2) > 0, gout[s:s + chunk], 0.0)
            G = torch.zeros(rows.shape[:2] + (cout,), dtype=torch.float32,
                            device=rows.device).scatter_add_(1, point, g)
        with torch.enable_grad():
            x = rows.requires_grad_(True)
            h = x
            for i, (lay, m) in enumerate(zip(layers, masks)):
                w, b, mul, beta = leaves[4 * i:4 * i + 4]
                h = (((h @ w + b) - lay[2]) * mul + beta) * m
            got = torch.autograd.grad(h, [x] + leaves, grad_outputs=G)
        dx = got[0]
        dxyz.append(dx[..., -3:])
        if f is not None:
            dfeat.append(dx[..., :-3])
        grads = list(got[1:]) if grads is None else [a + b for a, b in zip(grads, got[1:])]
    dlayers = [tuple(grads[4 * i:4 * i + 4]) for i in range(len(layers))]
    return torch.cat(dxyz), (torch.cat(dfeat) if feat is not None else None), dlayers


def saved_views(saved, P: int, S: int, N: int, nsample: int, widths):
    """The store mode's buffers (sel, act, t) as (sel [P, S, nsample], [x_l
    [P, N, widths[l]]] for l = 0 .. L, [t_l [P, N, widths[l + 1]]] for l =
    0 .. L - 1): views, in pppf_sa_common.cuh::act_layout's layout."""
    sel, act, t = saved
    pad = [_round4(w) for w in widths]
    xs, ts, off, toff = [], [], 0, 0
    for l, w in enumerate(widths):
        xs.append(act[off:off + P * N * pad[l]].view(P, N, pad[l])[..., :w])
        off += P * N * pad[l]
        if l > 0:
            ts.append(t[toff:toff + P * N * pad[l]].view(P, N, pad[l])[..., :w])
            toff += P * N * pad[l]
    return sel.view(P, S, nsample), xs, ts


def _scatter_points(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g [c, S, ns, w] per slot summed into its point, idx [c, S, ns] ->
    [c, n, w]."""
    c, w = g.shape[0], g.shape[-1]
    return g.new_zeros((c, n, w)).scatter_add_(
        1, idx.reshape(c, -1, 1).expand(-1, -1, w), g.reshape(c, -1, w))


def bf16_points_forward(xyz: torch.Tensor, feat, layers):
    """The bf16 "pppf" stack per point, as the bf16 kernels compute it: x_0
    the rows [feat | xyz] rounded to bf16, t_l = (x_l W_l + b_l) - mean_l,
    x_{l+1} = round(relu(t_l mul_l + beta_l)) -> ([x_0 .. x_L], [t_0 ..
    t_{L-1}])."""
    x = round_bf16(xyz if feat is None else torch.cat([feat, xyz], dim=-1))
    xs, ts = [x], []
    for w, b, mean, mul, beta in layers:
        t = (x @ w + b) - mean
        x = round_bf16(torch.relu(t * mul + beta))
        xs.append(x)
        ts.append(t)
    return xs, ts


def first_winners(vals: torch.Tensor):
    """The max routing of vals [..., nsample, C]: (the first slot in
    selection order that reaches each maximum [..., C], whether the maximum
    is > 0)."""
    top = vals.amax(dim=-2, keepdim=True)
    return (vals == top).to(torch.int32).argmax(dim=-2), top.squeeze(-2) > 0


def pppf_sa_bwd_plain_bf16(new_xyz: torch.Tensor, xyz: torch.Tensor, feat, gout: torch.Tensor,
                           layers, *, nsample: int, radius: float, saved=None):
    """The bf16 "pppf" stage's gradient (pcc_tpu's _stage_bwd_kernel with
    compute_dtype bfloat16, pppf_sa_pallas.py:258-456) against gout [P, S,
    C_out]; layers with W bf16 values (`bf16_layers`). Returns what
    `pppf_sa_bwd_plain` returns. The forward, per point: the rows rounded
    to bf16, each layer's t = (x W + b) - mean and its relu output rounded,
    or, with `saved`, the store mode's selection, rounded inputs x_l and t_l
    (`saved_views`; on the card the kernel's own, so that no rounding of a
    forward in another order enters a comparison). Each (patch, query,
    channel) max routes to the first slot in selection order that reaches
    it, where it is > 0. Below it the cotangent is carried per slot, as the
    TPU kernel carries it: at layer l, dh (masked by the slot's point's x_{l+1}
    > 0 below the last layer), dz = dh mul_l, and the row cotangent
    round(dz) @ W_l^T, float32. dW, db, dmul and dbeta are sums with no
    rounding between them, taken per point on the slots' dh summed per
    point: dW = mul x^T da, db = mul sum da, dmul = sum da t, dbeta = sum da;
    the row gradient sums into each slot's point (masked slots read point
    0)."""
    P, S, _ = new_xyz.shape
    N = xyz.shape[1]
    widths = [3 + (0 if feat is None else feat.shape[-1])] + [w.shape[1] for w, *_ in layers]
    L = len(layers)
    if saved is None:
        idx = ball_query(new_xyz, xyz, nsample, radius)
        xs, ts = bf16_points_forward(xyz, feat, layers)
    else:
        idx, xs, ts = saved_views(saved, P, S, N, nsample, widths)
    idx = idx.long()
    das = [gout.new_zeros((P, N, w)) for w in widths[1:]]
    dx = gout.new_zeros((P, N, widths[0]))
    chunk = max(1, PLAIN_ELEMS // (S * nsample * max(widths)))
    for s0 in range(0, P, chunk):
        sl, ids = slice(s0, s0 + chunk), idx[s0:s0 + chunk]
        vals = knn_gather(xs[L][sl], ids)                                 # [c, S, ns, C_out]
        first, live = first_winners(vals)
        g = torch.zeros_like(vals).scatter_(
            2, first[:, :, None], torch.where(live, gout[sl], 0.0)[:, :, None])
        for l in range(L - 1, -1, -1):
            w, _, _, mul, _ = layers[l]
            if l < L - 1:
                g = g * (knn_gather(xs[l + 1][sl], ids) > 0)
            das[l][sl] = _scatter_points(g, ids, N)
            g = round_bf16(g * mul) @ w.t()
        dx[sl] = _scatter_points(g, ids, N)
    dlayers = []
    for (w, b, mean, mul, beta), x, t, da in zip(layers, xs, ts, das):
        x2, da2 = x.reshape(-1, x.shape[-1]), da.reshape(-1, da.shape[-1])
        dlayers.append(((x2.t() @ da2) * mul, da2.sum(0) * mul,
                        (da2 * t.reshape(da2.shape)).sum(0), da2.sum(0)))
    C = widths[0] - 3
    return dx[..., C:].contiguous(), (dx[..., :C].contiguous() if feat is not None else None), \
        dlayers


def stage_bwd_flops(P: int, S: int, N: int, nsample: int, widths) -> float:
    """Operations of one stage's backward as the kernel computes it, per
    point: the replay (2 per multiply-add of the stack, 5 per output of a
    layer), the input and weight gradients (4 per multiply-add) and their
    elementwise parts (5 per output: mask, scale, three sums); per query: 9
    per (query, point) distance pair where a selection is made and one
    comparison per slot and output channel for the max routing. All of it
    counted as float32 work (stage_bwd_work splits it by unit)."""
    fp32, products = stage_bwd_work(P, S, N, nsample, widths)
    return fp32 + products


def stage_bwd_bf16_work(P: int, S: int, N: int, nsample: int, widths):
    """(float32 operations, bf16 products' operations) of the bf16 backward
    on the forward's stored activations: the routing (a comparison per
    slot and output channel), per slot and layer the mask, the scale and
    the rounding of dz (3 per output) and its input-gradient product
    round(dz) @ W^T (2 per multiply-add, on P * S * nsample slot rows: the
    products that run on the bf16 tensor cores), the per-point sums (1 per
    slot output), and per point the weight gradients x^T da (2 per
    multiply-add) with their column sums (3 per output)."""
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    slots = P * S * nsample
    fp32 = (slots * (widths[-1] + 4.0 * sum(widths[1:]) + widths[0])
            + P * N * (2.0 * macs + 3.0 * sum(widths[1:])))
    return fp32, slots * 2.0 * macs


def stage_bwd_work(P: int, S: int, N: int, nsample: int, widths, replay: bool = True):
    """(float32 operations on CUDA cores, float32 operations of the input and
    weight-gradient products) of one stage's backward; the kernel runs the
    products in 3xTF32 on the tensor cores, three TF32 products each. Without
    `replay` (the forward's store mode handed the activations over), neither
    the selection nor the replay of the stack is counted."""
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    outs = sum(widths[1:])
    dist = 9.0 * N if nsample < N and replay else 0.0
    fp32 = (P * N * ((2.0 * macs + 5.0 * outs if replay else 0.0) + 5.0 * outs)
            + P * S * (dist + nsample * widths[-1]))
    return fp32, P * N * 4.0 * macs


def _bwd_workspace(P: int, S: int, N: int, nsample: int, widths, bf16: bool = False) -> dict:
    """Element counts of the backward kernel's scratch buffers (see the
    launcher's comments in csrc/pppf_sa_stage_bwd.cu); with bf16 also the
    per-slot chain's: win, the patches per pass (chunk, as many as keep a0,
    a1 and d within CHAIN_BYTES) and a0, a1 and d for that many."""
    pad = [_round4(w) for w in widths]
    pairs = list(zip(widths[:-1], widths[1:]))
    ws = dict(sel=P * S * nsample, act=P * N * sum(pad),
              t=P * N * sum(pad[1:]), da=P * N * sum(pad[1:]),
              part=wgrad_part_floats([(P * N, a, b) for a, b in pairs]))
    if bf16:
        wa, wd = _pad16(max(widths[1:])), _pad16(max(widths[:-1]))
        chunk = max(1, min(P, CHAIN_BYTES // (S * nsample * (4 * wa + 4 * wd))))
        ws.update(win=P * S * widths[-1], chunk=chunk, a=chunk * S * nsample * wa,
                  d=chunk * S * nsample * wd)
    return ws


def _pad16(v: int) -> int:
    return (v + 15) & ~15


def bf16_weights(w: torch.Tensor) -> torch.Tensor:
    """W [cin, cout] (bf16 values) as the bf16 backward's operand: bf16
    [pad16(cin), pad16(cout)], zero-padded."""
    return F.pad(w, (0, _pad16(w.shape[1]) - w.shape[1],
                     0, _pad16(w.shape[0]) - w.shape[0])).to(torch.bfloat16).contiguous()


def pppf_sa_bwd(new_xyz: torch.Tensor, xyz: torch.Tensor, feat, gout: torch.Tensor, layers,
                *, nsample: int, radius: float, saved=None, bf16: bool = False):
    """(dxyz, dfeat | None, [(dW, db, dmul, dbeta)] per layer) of the "pppf"
    stage against the cotangent gout [P, S, C_out]: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. saved: what
    `pppf_sa_fused(..., save=True)` stored for these inputs and layers (the
    kernel then starts at the routing); None to select and replay the stack
    here. The results are the same bit for bit either way.

    bf16: the bf16 instance (launch counter "pppf_sa_stage_bwd_bf16"; the
    plain version `pppf_sa_bwd_plain_bf16`), on layers whose W are bf16
    values and, where given, what the bf16 store mode saved."""
    if new_xyz.device.type == "cpu":
        if bf16:
            return pppf_sa_bwd_plain_bf16(new_xyz, xyz, feat, gout, layers, nsample=nsample,
                                          radius=radius, saved=saved)
        return pppf_sa_bwd_plain(new_xyz, xyz, feat, gout, layers, nsample=nsample,
                                 radius=radius)
    widths = _check(new_xyz, xyz, feat, layers, nsample, "pppf", name="pppf_sa_bwd")
    P, S, _ = new_xyz.shape
    N = xyz.shape[1]
    cuda_lib.require_cuda("pppf_sa_bwd gout", gout, torch.float32, 3)
    if tuple(gout.shape) != (P, S, widths[-1]):
        raise ValueError(f"pppf_sa_bwd: cotangent {tuple(gout.shape)} != "
                         f"{(P, S, widths[-1])}")
    # the routing's smallest block: 4 channels of one patch's points and
    # queries
    if 4 * (4 * N + 6 * S) > 4 * SMEM_WORDS:
        raise ValueError(f"pppf_sa_bwd: N={N}, S={S} need more than {4 * SMEM_WORDS} bytes "
                         "of shared memory for the routing of 4 channels")
    if bf16 and nsample > MAX_SLOTS:
        raise ValueError(f"pppf_sa_bwd: the bf16 instance takes nsample <= {MAX_SLOTS}")
    dev = new_xyz.device
    ws = _bwd_workspace(P, S, N, nsample, widths, bf16)
    if saved is None:
        sel = torch.empty(ws["sel"], dtype=torch.int32, device=dev)
        act, t = (torch.empty(ws[k], dtype=torch.float32, device=dev) for k in ("act", "t"))
    else:
        sel, act, t = saved
        if (sel.numel(), act.numel(), t.numel()) != (ws["sel"], ws["act"], ws["t"]):
            raise ValueError("pppf_sa_bwd: saved buffers of another stage's shapes")
    da, part = (torch.empty(ws[k], dtype=torch.float32, device=dev) for k in ("da", "part"))
    if bf16:
        # bf16(W) [pad16(cin), pad16(cout)]: the per-slot products' weights
        wts = [bf16_weights(lay[0]) for lay in layers]
    else:
        # (W mul)^T [round4(cout), round4(cin)], zero-padded: dx's weights
        wts = [F.pad((lay[0] * lay[3]).t(), (0, _round4(lay[0].shape[0]) - lay[0].shape[0],
                                             0, _round4(lay[0].shape[1]) - lay[0].shape[1]))
               .contiguous() for lay in layers]
    ptrs = (ctypes.c_void_p * (6 * len(layers)))(*[
        p.data_ptr() for lay, wt in zip(layers, wts) for p in (lay[0], wt, *lay[1:])])
    dxyz = torch.empty_like(xyz)
    dfeat = None if feat is None else torch.empty_like(feat)
    pairs = list(zip(widths[:-1], widths[1:]))
    grads = torch.empty(sum(a * b + 3 * b for a, b in pairs), dtype=torch.float32, device=dev)
    args = [new_xyz.data_ptr(), xyz.data_ptr(), None if feat is None else feat.data_ptr(),
            gout.data_ptr(), P, S, N, 0 if feat is None else feat.shape[2], nsample,
            _radius2(radius), len(layers), ptrs, (ctypes.c_int * len(widths))(*widths),
            dxyz.data_ptr(), None if dfeat is None else dfeat.data_ptr(), grads.data_ptr(),
            sel.data_ptr(), act.data_ptr(), t.data_ptr(), da.data_ptr(), part.data_ptr(),
            part.numel(), int(saved is None)]
    if bf16:
        win = torch.empty(ws["win"], dtype=torch.uint8, device=dev)
        a0, a1 = (torch.empty(ws["a"], dtype=torch.bfloat16, device=dev) for _ in range(2))
        d = torch.empty(ws["d"], dtype=torch.float32, device=dev)
        cuda_lib.launch("pppf_sa_stage_bwd_bf16", _BWD_BF16_ARGTYPES, *args, win.data_ptr(),
                        a0.data_ptr(), a1.data_ptr(), d.data_ptr(), ws["chunk"],
                        cuda_lib.stream_ptr(xyz))
    else:
        cuda_lib.launch("pppf_sa_stage_bwd", _BWD_ARGTYPES, *args, cuda_lib.stream_ptr(xyz))
    parts = torch.split(grads, [n for a, b in pairs for n in (a * b, b, b, b)])
    dlayers = [(parts[4 * i].view(a, b), *parts[4 * i + 1:4 * i + 4])
               for i, (a, b) in enumerate(pairs)]
    return dxyz, dfeat, dlayers


class PPPFStageFn(torch.autograd.Function):
    """The stage with its backward kernel: forward `pppf_sa_fused`, with
    `save` in its store mode, backward `pppf_sa_bwd` on what it stored
    (pcc_tpu's custom VJP, pppf_sa_pallas.py::_make_trainable_stage).
    Arguments: nsample, radius, save, bf16, new_xyz, xyz, feat (or None),
    then W, b, mean, mul, beta of each layer. With bf16 both run their bf16
    instances on W rounded here, per call (the weights train), and W's
    gradient is the kernel's float32 dW, unrounded (the custom VJP's). new_xyz
    and mean get no gradient; at a first stage new_xyz may be xyz itself,
    whose gradient is then dxyz alone. ctx.saved_tensors holds new_xyz, xyz,
    feat, the layers' tensors (W rounded with bf16), then the stored buffers
    (none without `save`, or on the CPU)."""

    @staticmethod
    def forward(ctx, nsample, radius, save, bf16, new_xyz, xyz, feat, *flat):
        ctx.nsample, ctx.radius, ctx.bf16, ctx.n_flat = nsample, radius, bf16, len(flat)
        layers = [flat[i:i + 5] for i in range(0, len(flat), 5)]
        if bf16:
            layers = bf16_layers(layers)
        kw = dict(nsample=nsample, radius=radius, bf16=bf16)
        if save:
            out, saved = pppf_sa_fused(new_xyz, xyz, feat, layers, save=True, **kw)
        else:
            out, saved = pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), None
        ctx.save_for_backward(new_xyz, xyz, feat, *[t for lay in layers for t in lay],
                              *(saved or ()))
        return out

    @staticmethod
    def backward(ctx, gout):
        new_xyz, xyz, feat, *rest = ctx.saved_tensors
        flat, saved = rest[:ctx.n_flat], rest[ctx.n_flat:]
        layers = [flat[i:i + 5] for i in range(0, len(flat), 5)]
        dxyz, dfeat, dl = pppf_sa_bwd(new_xyz, xyz, feat, gout.contiguous(), layers,
                                      nsample=ctx.nsample, radius=ctx.radius,
                                      saved=tuple(saved) or None, bf16=ctx.bf16)
        return (None, None, None, None, None, dxyz, dfeat,
                *[g for dw, db, dmul, dbeta in dl for g in (dw, db, None, dmul, dbeta)])


def pppf_sa_trainable(new_xyz: torch.Tensor, xyz: torch.Tensor, feat, layers, *,
                      nsample: int, radius: float, bf16: bool = False) -> torch.Tensor:
    """Differentiable "pppf" stage [P, S, C_out] (pcc_tpu's
    pppf_sa_trainable): the same output as `pppf_sa_fused`, gradients by
    `pppf_sa_bwd` to xyz, feat and every layer's W, b, mul and beta
    (BatchNorm frozen at the running statistics folded into mean and mul).
    Where a gradient will be taken, the forward stores its activations for
    the backward (about 1.9 GB for the three stages of an 8-cloud step);
    under no_grad, as in serving, it does not. bf16: pcc_tpu's
    pppf_sa_trainable(compute_dtype=bfloat16), on W as it trains (float32;
    rounded inside, `PPPFStageFn`): the output bf16 values, the feature and
    coordinate gradients float32, as the custom VJP leaves them."""
    flat = [t for lay in layers for t in lay]
    save = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in [new_xyz, xyz, feat] + flat)
    return PPPFStageFn.apply(nsample, radius, save, bf16, new_xyz, xyz, feat, *flat)
