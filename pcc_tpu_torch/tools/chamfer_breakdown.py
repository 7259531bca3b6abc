"""The chamfer kernels at the shapes of the train paths, on an NVIDIA GPU.

  python3 -m pcc_tpu_torch.tools.chamfer_breakdown [--json PATH]   # from the repo root

Times ops/chamfer_cuda.py's chamfer_fwd and chamfer_bwd at every shape at
which a train step runs the chamfer: [128, 512, 3] vs [128, 512, 3] (IPDAE,
N = 512), [128, 1024, 3] vs [128, 512, 3] (the fused PPPF-AE step, N =
512), [8, 8192, 3] vs [8, 8192, 3] (IPDAE, N = 8192), [8, 16384, 3] vs [8,
8192, 3] (the fused PPPF-AE step, N = 8192) and [4, 16384, 3] vs [4, 8192,
3] (its warm-up step). y is chip_smoke.py's seeded clouds; x is y's points
drawn at random and moved by N(0, 0.02) per coordinate, as a decoded cloud
lies near its input (a few points of x gather at each point of y). Then
the same on the chamfer's own clouds and cotangents in one IPDAE and one
fused PPPF-AE train step at N = 8192 (seeded weights, chip_smoke.py's
clouds and BatchNorm statistics), where decoded points crowd together and
many gather at one point: each shape reports its longest segment (the
most points of one side gathering at one point of the other, the
backward's longest sum) and the mean segment a gathering point sits in.

Each shape gets the kernels' CUDA-event times (chip_smoke.cuda_ms, which
also counts the wrapper's host time) and, where chip_smoke.py has graph_ms,
their device times from a CUDA graph's replays; the plain versions' times;
the bounds (chip_smoke.bound on fwd_work / bwd_work: float32 at 67 TFLOP/s,
bytes at 3.35 TB/s) and the forward's instruction floor, 9 instructions per
point pair and direction at one instruction per lane and cycle (33.5 T/s:
the 67 TFLOP/s peak counts a fused multiply-add as two operations, and the
kernel may not contract); and what the step's chamfer costs on this tree:
ops/chamfer.py::chamfer_distance(fast_search=True) forward and backward
("route"), beside the chunked plain search both ways with its gather and
backward ("chunked", _directed_mean_sq, which the N = 8192 steps ran while
the route kept pcc_tpu's gate), each with its peak device memory. Every
kernel result is held to its plain version first: indices bit-equal,
distances and gradients within 1e-4 of the plain version's largest entry.

Where ops/chamfer_cuda.py has launch plans (candidate_plans), the forward
is also timed at every plan it takes at a shape, each held bit for bit to
the launcher's own choice. The backward is also timed with parts cut out
(BWD_VARIANTS: csrc/chamfer_bwd.cu with a text replaced, built by
tools/variants.py; their results are not the function's): without the
sums, without the placing and the sums, and the zeroing and scans alone.
Runs on older trees too (copy it and tools/variants.py into a `git
archive` of one): where the
wrappers still carry pcc_tpu's k * K <= 2^19 gate (KERNEL_LIMIT), it is
lifted for the direct kernel calls, and what a tree lacks is skipped.

Prints the card's name and power limit, then one line per measurement.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from pcc_tpu_torch.ops import chamfer as chamfer_ops
from pcc_tpu_torch.ops import chamfer_cuda as cc
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.train import build_pppf_train_step, build_train_step, create_train_state
from pcc_tpu_torch.train.state import make_optimizer
from pcc_tpu_torch.tools.variants import build_variants, entry

SHAPES = [("N=512 IPDAE", 128, 512, 512), ("N=512 PPPF-AE fused", 128, 1024, 512),
          ("N=8192 IPDAE", 8, 8192, 8192), ("N=8192 PPPF-AE fused", 8, 16384, 8192),
          ("N=8192 PPPF-AE warm-up", 4, 16384, 8192)]
INSTR_PER_S = 33.5e12   # float32 instructions a second: 132 SMs x 128 lanes x 1.98 GHz
TOL = 1e-4
REPS = 20
# (label, [(old, new) text of csrc/chamfer_bwd.cu]): each variant cuts a part
# out, cumulatively
_NO_SUMS = ("q0 < start + count; q0 += kSumBatch", "q0 < start; q0 += kSumBatch")
_NO_PLACING = ("  // 3. place\n  if (w < W) {", "  // 3. place\n  if (false) {")
_NO_COUNTING = ("  // 1. count\n  if (w < W) {", "  // 1. count\n  if (false) {")
BWD_VARIANTS = [("without the sums", [_NO_SUMS]),
                ("without placing and sums", [_NO_SUMS, _NO_PLACING]),
                ("zeroing and scans alone", [_NO_SUMS, _NO_PLACING, _NO_COUNTING])]


def log(msg: str) -> None:
    print(msg, flush=True)


def clouds(dev, P: int, k: int, K: int, seed: int):
    """(x [P, k, 3], y [P, K, 3], gx, gy): y chip_smoke.py's clouds, x y's
    points at random, moved by N(0, 0.02); random cotangents."""
    y = np.stack(cs.synthetic_clouds(P, K, seed))
    rng = np.random.default_rng(seed + 1)
    pick = rng.integers(0, K, (P, k))
    x = np.take_along_axis(y, pick[..., None], 1) + rng.standard_normal((P, k, 3)) * 0.02
    g = torch.Generator().manual_seed(seed + 2)
    return (torch.from_numpy(x.astype(np.float32)).to(dev),
            torch.from_numpy(y.astype(np.float32)).to(dev),
            torch.randn((P, k), generator=g).to(dev), torch.randn((P, K), generator=g).to(dev))


def train_records(dev) -> dict:
    """{label: (x, y, gx, gy)}: the chamfer's clouds and real cotangents of
    one IPDAE and one fused PPPF-AE train step at N = 8192 on 8 clouds,
    recorded as chip_smoke.py records them; empty on a tree without
    chip_smoke.recording_chamfer."""
    records = {}
    if not hasattr(cs, "recording_chamfer"):
        return records
    tx = make_optimizer(5e-4, 0.1, 60000, 80000)
    batch = torch.from_numpy(np.stack(cs.synthetic_clouds(cs.TRAIN_CLOUDS, 8192, cs.SEED))).to(dev)
    starts = torch.zeros(cs.TRAIN_CLOUDS, dtype=torch.int32, device=dev)
    for label, cfg in (("IPDAE step", CodecConfig()),
                       ("fused PPPF-AE step", CodecConfig(model="PPPF-AE"))):
        state = create_train_state(cs.SEED, cfg, tx, device="cuda")
        if cfg.model == "PPPF-AE":
            state.ae.load_state_dict(cs.randomize_batchnorm(state.ae.state_dict(), cs.SEED + 2))
            state.prob.load_state_dict(cs.randomize_batchnorm(state.prob.state_dict(),
                                                              cs.SEED + 3))
            step = build_pppf_train_step(cfg, tx, rate_mode="reference", fused=True)
        else:
            step = build_train_step(cfg, tx, rate_mode="reference")
        with cs.recording_chamfer(records, f"N=8192 {label}, its own clouds"):
            step(state, batch, starts, cs.TRAIN_LAM)
        del state
    return records


def check(x, y, out, gx, gy, grads) -> None:
    """Raise unless the kernels' results agree with the plain versions."""
    want = cc.chamfer_fwd_plain(x, y)
    if not (torch.equal(out[2], want[2]) and torch.equal(out[3], want[3])):
        raise RuntimeError(f"chamfer_fwd indices differ from the plain version at "
                           f"{tuple(x.shape)} vs {tuple(y.shape)}")
    plain_grads = cc.chamfer_bwd_plain(x, y, out[2], out[3], gx, gy)
    for u, v in list(zip(out[:2], want[:2])) + list(zip(grads, plain_grads)):
        err, big = float((u - v).abs().max()), float(v.abs().max())
        if not err <= TOL * big:
            raise RuntimeError(f"a chamfer kernel differs from its plain version at "
                               f"{tuple(x.shape)} vs {tuple(y.shape)}: {err} > {TOL} * {big}")


def device_ms(fn) -> float | None:
    return cs.graph_ms(fn) if hasattr(cs, "graph_ms") else None


def step_chamfer(x, y, fn):
    """(CUDA-event ms, peak MiB above the inputs) of one chamfer loss fn(x, y)
    forward and backward."""
    def run():
        xr, yr = x.detach().requires_grad_(True), y.detach().requires_grad_(True)
        fn(xr, yr).backward()

    run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    return cs.cuda_ms(run, 5), peak


def route_loss(a, b):
    return chamfer_ops.chamfer_distance(a, b, fast_search=True)[0]


def chunked_loss(a, b):
    return torch.mean(chamfer_ops._directed_mean_sq(a, b, True)
                      + chamfer_ops._directed_mean_sq(b, a, True))


def plan_times(x, y, ref) -> dict:
    """{plan: ms} of the forward at every plan it takes here (device ms
    where chip_smoke.py has graph_ms, else CUDA-event ms), each held bit for
    bit to the launcher's own output ref."""
    out = {}
    for plan in cc.candidate_plans(*x.shape[:2], y.shape[1]):
        got = cc.chamfer_fwd(x, y, plan=plan)
        if not all(torch.equal(u, v) for u, v in zip(got, ref)):
            raise RuntimeError(f"plan {plan} differs from the launcher's output at "
                               f"{tuple(x.shape)} vs {tuple(y.shape)}")
        fn = lambda: cc.chamfer_fwd(x, y, plan=plan)  # noqa: E731
        out[str(plan)] = device_ms(fn) or cs.cuda_ms(fn, REPS)
    return out


def bwd_variant_functions(tmp: str) -> dict:
    """{label: entry point} of csrc/chamfer_bwd.cu with each BWD_VARIANTS
    cut, built into tmp; a variant whose text the source lacks is left
    out."""
    libs = build_variants(tmp, {label: ("chamfer_bwd", [cuts]) for label, cuts in BWD_VARIANTS})
    return {label: entry(lib, "chamfer_bwd", cc._BWD_ARGTYPES) for label, lib in libs.items()}


def variant_ms(fns: dict, bwd) -> dict:
    """{label: device ms} of bwd() with each variant's entry point."""
    own = cuda_lib._functions["chamfer_bwd"]
    out = {}
    try:
        for label, fn in fns.items():
            cuda_lib._functions["chamfer_bwd"] = fn
            out[label] = device_ms(bwd) or cs.cuda_ms(bwd, REPS)
    finally:
        cuda_lib._functions["chamfer_bwd"] = own
    return out


@contextlib.contextmanager
def kernels_at_any_shape():
    """Lift an older tree's route gate (KERNEL_LIMIT) while active, so that
    its wrappers take the N = 8192 shapes; the route itself is timed as the
    tree has it."""
    saved = getattr(cc, "KERNEL_LIMIT", None)
    if saved is not None:
        cc.KERNEL_LIMIT = 1 << 62
    try:
        yield
    finally:
        if saved is not None:
            cc.KERNEL_LIMIT = saved


def segments(ixy, iyx, k: int, K: int):
    """(longest, mean) segment of the backward: how many points of one side
    gather at one point of the other, at most, and on average over the
    gathering points."""
    P = ixy.shape[0]
    counts = torch.cat([torch.bincount((i.long() + n * torch.arange(
        P, device=i.device)[:, None]).flatten(), minlength=P * n) for i, n in ((iyx, k), (ixy, K))])
    c = counts.double()
    return int(counts.max()), float((c * c).sum() / c.sum())


def measure(label: str, x, y, gx, gy, variants: dict) -> dict:
    P, k, K = x.shape[0], x.shape[1], y.shape[1]
    with kernels_at_any_shape():
        out = cc.chamfer_fwd(x, y)
        ixy, iyx = out[2], out[3]
        grads = cc.chamfer_bwd(x, y, ixy, iyx, gx, gy)
        again = cc.chamfer_bwd(x, y, ixy, iyx, gx, gy)
        if not all(torch.equal(u, v) for u, v in zip(grads, again)):
            raise RuntimeError(f"two launches of chamfer_bwd differ at {label}")
        check(x, y, out, gx, gy, grads)
        f_bms, f_by = cs.bound(*cc.fwd_work(P, k, K))
        b_bms, b_by = cs.bound(*cc.bwd_work(P, k, K))
        fwd = lambda: cc.chamfer_fwd(x, y)  # noqa: E731
        bwd = lambda: cc.chamfer_bwd(x, y, ixy, iyx, gx, gy)  # noqa: E731
        longest, mean = segments(ixy, iyx, k, K)
        rec = dict(label=label, shape=[P, k, K],
                   fwd_ms=cs.cuda_ms(fwd, REPS), fwd_device_ms=device_ms(fwd),
                   bwd_ms=cs.cuda_ms(bwd, REPS), bwd_device_ms=device_ms(bwd),
                   fwd_plain_ms=cs.cuda_ms(lambda: cc.chamfer_fwd_plain(x, y), 3),
                   bwd_plain_ms=cs.cuda_ms(lambda: cc.chamfer_bwd_plain(x, y, ixy, iyx, gx, gy),
                                           3),
                   fwd_bound_ms=f_bms, fwd_bound_by=f_by,
                   fwd_instr_floor_ms=2 * 9.0 * P * k * K / INSTR_PER_S * 1e3,
                   bwd_bound_ms=b_bms, bwd_bound_by=b_by,
                   longest_segment=longest, mean_segment=mean,
                   bwd_variants_ms=variant_ms(variants, bwd))
        if hasattr(cc, "candidate_plans"):
            rec["plan"] = str(cc.fwd_plan(P, k, K))
            rec["plans"] = plan_times(x, y, out)
    rec["route_ms"], rec["route_peak_mib"] = step_chamfer(x, y, route_loss)
    if K >= 8192:
        rec["chunked_ms"], rec["chunked_peak_mib"] = step_chamfer(x, y, chunked_loss)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    log(f"{label} x [{P}, {k}, 3] y [{P}, {K}, 3]: forward {rec['fwd_ms']:.4f} ms, device "
        f"{fmt(rec['fwd_device_ms'])} (plain {rec['fwd_plain_ms']:.3f} ms, bound "
        f"{f_bms:.4f} ms by {f_by}, instruction floor {rec['fwd_instr_floor_ms']:.4f} ms); "
        f"backward {rec['bwd_ms']:.4f} ms, device {fmt(rec['bwd_device_ms'])} (plain "
        f"{rec['bwd_plain_ms']:.3f} ms, bound {b_bms:.5f} ms by {b_by}; segments: longest "
        f"{longest}, mean {mean:.1f}); route f+b {rec['route_ms']:.3f} ms, peak "
        f"{rec['route_peak_mib']:.1f} MiB" + (
            f"; chunked f+b {rec['chunked_ms']:.3f} ms, peak {rec['chunked_peak_mib']:.1f} MiB"
            if "chunked_ms" in rec else ""))
    if rec["bwd_variants_ms"]:
        log("  backward " + ", ".join(f"{v}: {t:.4f} ms" for v, t in
                                      rec["bwd_variants_ms"].items()))
    if "plans" in rec:
        log(f"  plans (launcher {rec['plan']}): "
            + ", ".join(f"{p} {t:.4f}" for p, t in rec["plans"].items()))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the measurements to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chamfer_breakdown needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    cuda_lib.build()
    for name in ("chamfer_fwd", "chamfer_bwd"):
        log(f"{name}: " + "; ".join(ln.strip() for ln in cuda_lib.build_log.get(name, "")
                                    .splitlines() if "registers" in ln or "spill" in ln))
    with tempfile.TemporaryDirectory() as tmp:
        variants = bwd_variant_functions(tmp)
        recs = [measure(label, *clouds(dev, P, k, K, cs.SEED + j), variants)
                for j, (label, P, k, K) in enumerate(SHAPES)]
        for label, (x, y, gx, gy) in train_records(dev).items():
            recs.append(measure(label, x, y, gx, gy, variants))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, shapes=recs), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
