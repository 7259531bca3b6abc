"""Farthest point sampling at the shapes of the users' paths, on an NVIDIA GPU.

  python3 -m pcc_tpu_torch.tools.fps_breakdown [--rooms] [--json PATH]   # from the repo root

Times ops/fps.py::fps_batch with CUDA events at every float32 shape at which
a path samples: the skeleton of an IPDAE serving batch [64, 8192 -> 64], of
a PPPF-AE one [16, 8192 -> 64] and of an N = 8192 train step [8, 8192 ->
64]; the PPPF-AE encoder's sa2 and sa3 on a serving batch (P = 1024) and a
train step (P = 512); the float CPM's three stages in a train step at N =
8192 (8 clouds) and N = 512 (128 clouds). Then the integer CPM's FPS
(coding/iprob_pppf.py::_int_fps) at its three stages on a 16-cloud batch,
by host wall time ending in a device sync and by CUDA events (where no
kernel runs it, it is a host loop of small launches and the two agree).
Where chip_smoke.py has graph_ms, each shape also gets the kernel's device
time from a CUDA graph's replays (CUDA events around back-to-back calls of
a short kernel also count the wrapper's host time). Each time comes with
ns per step (ms / npoint) and the bound: 9 operations
per point and step, float32 at 67 TFLOP/s, int32 at half that. The inputs
are chip_smoke.py's seeded clouds, their octree skeletons, and the stages'
own samples of them.

Where ops/fps.py has launch plans (candidate_plans), every plan the kernel
takes at a shape is also timed there and held bit for bit to the
launcher's own choice, and so is the kernel with its warp argmax as a
__shfl_xor_sync butterfly instead of two redux.sync (`butterfly`:
csrc/fps.cu with BUTTERFLY's text in place of the reduction, built by
tools/variants.py). Last, one PPPF-AE encode and one decode of
chip_smoke.py's 16-cloud batch (seeded weights and BatchNorm statistics):
their walls (median of 3), torch.profiler's busy share (chip_smoke.profile)
and the share of each wall that _int_fps takes, timed with a device sync on
each side of every call.

--rooms times only the large-scene shapes (eval/gen_rooms.py's rooms at
--batch_size 4: [4, 65536 -> 512] and [1, 100000 -> 781], chip_smoke.py's
seeded rooms, normalized as the codec does) beside the IPDAE serving
skeleton [64, 8192 -> 64], every plan at each, and nothing else.

Prints the card's name and power limit, then one line per measurement.
Runs on older trees too (copy it and tools/variants.py into a `git
archive` of one): what a tree lacks is skipped.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from pcc_tpu_torch.codec import (Codec, encode_geometry, init_params, pack_encode_upload,
                                 unpack_encode_upload)
from pcc_tpu_torch.coding import iprob_pppf as ipppf
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops import fps as fps_ops
from pcc_tpu_torch.ops.normalize import normalize
from pcc_tpu_torch.tools.variants import build_variants, entry

REPS = 20
# the warp argmax of csrc/fps.cu as a __shfl_xor_sync butterfly over (key,
# index) instead of two redux.sync: (old, new) in the source
BUTTERFLY = ("""  const unsigned m = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == m ? idx : kNoPoint);
  key = m;
""", """#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned k2 = __shfl_xor_sync(kFull, key, off);
    const unsigned i2 = __shfl_xor_sync(kFull, idx, off);
    if (k2 > key || (k2 == key && i2 < idx)) {
      key = k2;
      idx = i2;
    }
  }
""")
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12   # CUDA cores' int32 rate: half the float32 rate


def log(msg: str) -> None:
    print(msg, flush=True)


def gather(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3))


def zeros(B: int, dev) -> torch.Tensor:
    return torch.zeros(B, dtype=torch.int32, device=dev)


def geometry(dev, n: int, N: int):
    """(pc01 [n, N, 3], patches [n * S, K, 3], octree skeletons [n, S, 3])
    of n of chip_smoke.py's clouds at N points."""
    cfg = CodecConfig(N=N)
    clouds = np.stack(cs.synthetic_clouds(n, N, cs.SEED))
    packed = pack_encode_upload(clouds, np.zeros(n, np.int32))
    pcs, st = unpack_encode_upload(torch.from_numpy(packed.view(np.int32)).to(dev), N)
    geo = encode_geometry(pcs, st, cfg)
    return geo.pc01.contiguous(), geo.patches.contiguous(), geo.octree.rec_xyz.contiguous()


def cpm_chain(rec: torch.Tensor, label: str):
    """The float CPM's three FPS calls on skeletons rec: [(label, xyz, npoint)]."""
    out, cur = [], rec
    for j, st in enumerate(ipppf._STAGES, start=1):
        npoint = st["npoint"]
        out.append((f"{label} sa{j}", cur, npoint))
        cur = gather(cur, fps_ops.fps_batch(cur, npoint, zeros(cur.shape[0], cur.device)))
        cur = cur.contiguous()
    return out


def float_cases(dev):
    """[(label, xyz [B, N, 3], npoint)] at the float shapes of the paths."""
    pc01, patches, rec = geometry(dev, cs.N_CLOUDS, 8192)
    _, _, rec512 = geometry(dev, cs.SMALL_CLOUDS, 512)
    cases = [("IPDAE serving skeleton", pc01, 64),
             ("PPPF-AE serving skeleton", pc01[:cs.PPPF_CLOUDS].contiguous(), 64),
             ("N=8192 step skeleton", pc01[:cs.TRAIN_CLOUDS].contiguous(), 64)]
    for label, P in (("PPPF-AE serving", 1024), ("PPPF-AE step", 512)):
        x = patches[:P].contiguous()
        x3 = gather(x, fps_ops.fps_batch(x, 128, zeros(P, dev))).contiguous()
        cases += [(f"{label} sa2", x, 128), (f"{label} sa3", x3, 32)]
    cases += cpm_chain(rec[:cs.PPPF_TRAIN_CLOUDS].contiguous(), "CPM N=8192 step")
    cases += cpm_chain(rec512, "CPM N=512 step")
    return cases, rec[:cs.PPPF_CLOUDS].contiguous()


def room_cases(dev):
    """[(label, xyz [B, N, 3], npoint)]: the large-scene rooms' skeleton
    FPS (S = N * ALPHA / K), on chip_smoke.py's seeded rooms normalized as
    the codec normalizes them, and the IPDAE serving skeleton beside them."""
    pc01 = geometry(dev, cs.N_CLOUDS, 8192)[0]
    out = [("IPDAE serving skeleton", pc01, 64)]
    for B, N in ((4, 65536), (1, 100000)):
        rooms = torch.from_numpy(np.stack(cs.rooms([N] * B, cs.SEED))).to(dev)
        x = normalize(rooms, CodecConfig().margin)[0].contiguous()
        out.append(("room skeleton", x, CodecConfig(N=N).S))
    return out


def int_cases(rec: torch.Tensor):
    """[(label, xs [B, n, 3] int32, npoint, inf)]: the integer CPM's three
    FPS calls as coding/iprob_pppf.py::pppf_pmf_weights makes them."""
    cur = torch.round(rec * float(1 << ipppf.Q_IN)).to(torch.int32)
    out = []
    for j, st in enumerate(ipppf._STAGES, start=1):
        n_src = cur.shape[1]
        q = ipppf._qsel(n_src)
        xs = (cur >> (ipppf.Q_IN - q)).contiguous()
        inf = 3 * (4 ** q) + 1
        out.append((f"int CPM sa{j}", xs, st["npoint"], inf))
        idx = ipppf._int_fps(xs, st["npoint"], inf)
        cur = torch.gather(cur, 1, idx.long()[..., None].expand(-1, -1, 3))
    return out


def wall_ms(fn, reps: int) -> float:
    """Median host wall time of fn() ending in a device sync."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def record(label, B, N, npoint, ms, ops_per_s, **extra) -> dict:
    bound_ms = 9.0 * B * N * npoint / ops_per_s * 1e3
    rec = dict(label=label, shape=[B, N, npoint], ms=ms, ns_per_step=ms * 1e6 / npoint,
               bound_ms=bound_ms, **extra)
    log(f"{label} [{B}, {N} -> {npoint}]: {ms:.4f} ms, {rec['ns_per_step']:.1f} ns per step, "
        f"bound {bound_ms:.5f} ms" + "".join(
            f", {k} {v:.4f} ms" if isinstance(v, float) else f", {k} {v}"
            for k, v in extra.items() if k != "plans"))
    return rec


def plan_times(launch, N: int, ref: torch.Tensor) -> dict:
    """{plan: ms} of every plan the kernel takes at N, each held bit for bit
    to the launcher's own output ref."""
    out = {}
    for plan in fps_ops.candidate_plans(N):
        got = launch(plan)
        if not torch.equal(got, ref):
            raise RuntimeError(f"plan {plan} differs from the launcher's output at N = {N}")
        out[str(plan)] = cs.cuda_ms(lambda: launch(plan), REPS)
    return out


def butterfly_functions(tmp: str):
    """{kernel name: entry point} of csrc/fps.cu built with the butterfly
    argmax, or None where the source lacks the reduction it replaces."""
    lib = build_variants(tmp, {"butterfly": ("fps", [[BUTTERFLY]])}).get("butterfly")
    if lib is None:
        return None
    return {name: entry(lib, name, argtypes)
            for name, argtypes in (("fps", fps_ops._ARGTYPES), ("fps_int", fps_ops._INT_ARGTYPES))}


def variant_ms(fns, name: str, fn, ref: torch.Tensor) -> float:
    """CUDA-event ms of fn() with kernel `name`'s entry point from fns,
    held bit for bit to ref."""
    own = cuda_lib._functions[name]
    cuda_lib._functions[name] = fns[name]
    try:
        if not torch.equal(fn(), ref):
            raise RuntimeError(f"the butterfly variant of {name} differs from the kernel")
        return cs.cuda_ms(fn, REPS)
    finally:
        cuda_lib._functions[name] = own


def time_float(cases, bfly) -> list:
    recs = []
    plans = hasattr(fps_ops, "candidate_plans")
    for label, xyz, npoint in cases:
        B, N, _ = xyz.shape
        z = zeros(B, xyz.device)
        ref = fps_ops.fps_batch(xyz, npoint, z)
        extra = {}
        if bfly:
            extra["butterfly_ms"] = variant_ms(
                bfly, "fps", lambda: fps_ops.fps_batch(xyz, npoint, z), ref)
        if plans:
            extra["plan"] = str(fps_ops.plan(B, N))
            extra["plans"] = plan_times(
                lambda p: fps_ops._launch(xyz, npoint, z, None, p), N, ref)
        if hasattr(cs, "graph_ms"):
            extra["device_ms"] = cs.graph_ms(lambda: fps_ops.fps_batch(xyz, npoint, z))
        recs.append(record(label, B, N, npoint,
                           cs.cuda_ms(lambda: fps_ops.fps_batch(xyz, npoint, z), REPS),
                           FP32_OPS_PER_S, **extra))
        if plans:
            log("  plans: " + ", ".join(f"{p} {t:.4f}" for p, t in extra["plans"].items()))
    return recs


def time_int(cases, bfly) -> list:
    recs = []
    kernel = hasattr(fps_ops, "fps_int_batch")
    for label, xs, npoint, inf in cases:
        B, N, _ = xs.shape
        fn = lambda: ipppf._int_fps(xs, npoint, inf)  # noqa: E731
        extra = dict(wall_ms=wall_ms(fn, 5))
        if kernel:
            ref = fps_ops.fps_int_batch(xs, npoint, inf)
            if bfly:
                extra["butterfly_ms"] = variant_ms(
                    bfly, "fps_int", lambda: fps_ops.fps_int_batch(xs, npoint, inf), ref)
            extra["device_ms"] = cs.graph_ms(lambda: fps_ops.fps_int_batch(xs, npoint, inf))
            extra["plan"] = str(fps_ops.plan(B, N))
            extra["plans"] = plan_times(
                lambda p: fps_ops._launch(xs, npoint, None, inf, p), N, ref)
        recs.append(record(label, B, N, npoint, cs.cuda_ms(fn, REPS if kernel else 3),
                           INT32_OPS_PER_S, **extra))
        if kernel:
            log("  plans: " + ", ".join(f"{p} {t:.4f}" for p, t in extra["plans"].items()))
    return recs


def pppf_serving() -> dict:
    """PPPF-AE encode and decode walls, busy shares (printed by
    chip_smoke.profile) and _int_fps's share of each wall."""
    cfg = CodecConfig(model="PPPF-AE")
    clouds = cs.synthetic_clouds(cs.PPPF_CLOUDS, cfg.N, cs.SEED)
    ae_state, prob_state = init_params(cs.SEED, cfg)
    card = Codec(cfg, cs.randomize_batchnorm(ae_state, cs.SEED + 2),
                 cs.randomize_batchnorm(prob_state, cs.SEED + 3),
                 batch_size=cs.PPPF_CLOUDS, device="cuda")
    streams = card.compress_many(clouds)
    card.decompress_many(streams)
    out = dict(encode_ms=wall_ms(lambda: card.compress_many(clouds), 3),
               decode_ms=wall_ms(lambda: card.decompress_many(streams), 3))
    cs.profile("PPPF-AE encode", lambda: card.compress_many(clouds), top=6)
    cs.profile("PPPF-AE decode", lambda: card.decompress_many(streams), top=6)
    orig = ipppf._int_fps
    spent = {"ms": 0.0, "calls": 0}

    def timed(xs, npoint, inf):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(xs, npoint, inf)
        torch.cuda.synchronize()
        spent["ms"] += (time.perf_counter() - t0) * 1e3
        spent["calls"] += 1
        return res

    ipppf._int_fps = timed
    try:
        for name, fn in (("encode", lambda: card.compress_many(clouds)),
                         ("decode", lambda: card.decompress_many(streams))):
            spent.update(ms=0.0, calls=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            out[f"{name}_int_fps"] = dict(wall_ms=wall, int_fps_ms=spent["ms"],
                                          calls=spent["calls"], share=spent["ms"] / wall)
    finally:
        ipppf._int_fps = orig
    log(f"PPPF-AE {cs.PPPF_CLOUDS} clouds: encode {out['encode_ms']:.1f} ms, decode "
        f"{out['decode_ms']:.1f} ms (median of 3); with _int_fps timed: " + "; ".join(
            f"{k[:6]} wall {v['wall_ms']:.1f} ms, _int_fps {v['int_fps_ms']:.2f} ms in "
            f"{v['calls']} calls, share {v['share']:.3f}"
            for k, v in out.items() if isinstance(v, dict)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the measurements to this file")
    ap.add_argument("--rooms", action="store_true",
                    help="time only the large-scene rooms' shapes (and the serving skeleton)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fps_breakdown needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    names = [n for n in ("fps", "fps_int") if n in cuda_lib.KERNELS]
    cuda_lib.build(names)
    for name in names:
        cuda_lib.function(name, fps_ops._INT_ARGTYPES if name == "fps_int" else fps_ops._ARGTYPES)
        log(f"{name}: " + "; ".join(ln.strip() for ln in cuda_lib.build_log.get(name, "").splitlines()
                                    if "registers" in ln or "spill" in ln))
    if args.rooms:
        with torch.inference_mode():
            result = dict(card=smi, float=time_float(room_cases(dev), None))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(result, f, indent=1)
        return 0
    with torch.inference_mode(), tempfile.TemporaryDirectory() as tmp:
        bfly = butterfly_functions(tmp)
        cases, rec16 = float_cases(dev)
        result = dict(card=smi, float=time_float(cases, bfly),
                      int=time_int(int_cases(rec16), bfly))
    result["pppf_serving"] = pppf_serving()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
