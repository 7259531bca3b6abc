"""Where the time of the two backward kernels goes, on an NVIDIA GPU.

  python3 -m pcc_tpu_torch.tools.bwd_breakdown [stage] [encoder] [--bf16]

(from the repo root; no part named: both; --bf16: the encoder backward's
bf16 instance, patch_encoder_bwd_bf16, in place of the float32 one.)

The PN++ SA stage backward (csrc/pppf_sa_stage_bwd.cu) is a chain of
launches, so its pieces are its launches: on the stage inputs of
chip_smoke.py's fused PPPF-AE train step (8 synthetic clouds, P = 512
patches, seeded weights and BatchNorm statistics, a seeded normal
cotangent), torch.profiler gives each kernel's device time per call, at
each stage, for the backward that selects and replays the stack and, where
the wrapper takes them, on the activations the forward's store mode stored.

The patch encoder backward (csrc/patch_encoder_bwd.cu) is one kernel, so
its pieces are timed as csrc/pppf_sa_stage.cu's are by stage_breakdown.py:
the source is built as it is and with one part taken out
(tools/variants.py), and each variant is timed
with CUDA events on the IPDAE train step's patches [512, 256, 3] with a
seeded normal cotangent (and, where the wrapper takes them, the forward
kernel's winners; with --bf16 the bf16 forward's, as train --bf16 hands
them over). A variant applies where its texts are in the source (the
list covers the designs of several revisions) and is skipped otherwise; the variants give wrong outputs, and only `full` is checked, bit
for bit against the wrapper. The difference between `full` and a variant is
the time of the part it takes out.

Prints the card's name and power limit, then the stage backward's table and
one line per round and encoder variant.
"""

from __future__ import annotations

import inspect
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from pcc_tpu_torch.codec import (encode_geometry, init_params, make_models, pack_encode_upload,
                                 unpack_encode_upload)
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops import pppf_sa_cuda as sa_ops
from pcc_tpu_torch.ops import sa_cuda
from pcc_tpu_torch.tools.stage_breakdown import stage_inputs
from pcc_tpu_torch.tools.variants import build_variants, entry

# variant -> alternatives of csrc/patch_encoder_bwd.cu (tools/variants.py;
# one design of the kernel runs a pass over all points to find the winners
# and sums the weight gradients into per-block partials; the other takes the
# forward's winners and sums by split-K products over the winners' rows)
ENC_VARIANTS = {
    "full": [[]],
    # a whole forward over every point, to find each channel's winner
    "nopass1": [[("    for (int c0 = 0; c0 < n; c0 += kEncPnQ) {\n      const int nq = min(kEncPnQ, n - c0);\n      encoder_chunk<KNN>(",
                  "    for (int c0 = 0; c0 < 0; c0 += kEncPnQ) {\n      const int nq = min(kEncPnQ, n - c0);\n      encoder_chunk<KNN>(")]],
    # the winners' rows: everything after the winners are known
    "nopass2": [[("    for (int w0 = 0; w0 < U; w0 += kEncQ) {",
                  "    for (int w0 = 0; w0 < 0; w0 += kEncQ) {")],
                [("  for (; w0 < U; w0 += kEncQ) {", "  for (; w0 < 0; w0 += kEncQ) {")]],
    # the SetAbstraction backward of each group of winners
    "nosa_bwd": [[("      for (int g0 = 0; g0 < Wn; g0 += kG) {\n        sa_group_forward<KNN>(",
                   "      for (int g0 = 0; g0 < 0; g0 += kG) {\n        sa_group_forward<KNN>(")],
                 [("    for (; g0 < Wn; g0 += kG) {\n      sa_group_forward<KNN>(",
                   "    for (; g0 < 0; g0 += kG) {\n      sa_group_forward<KNN>(")],
                 [("    for (; g0 < Wn; g0 += kG) {\n      sa_group_forward<KNN, kBf16>(",
                   "    for (; g0 < 0; g0 += kG) {\n      sa_group_forward<KNN, kBf16>(")]],
    # every weight-gradient and bias-gradient sum: in shared memory per group
    # of winners, or the split-K products over the winners' rows
    "nowgrad": [[("  for (int e = threadIdx.x; e < cin * cout; e += blockDim.x) {",
                  "  for (int e = threadIdx.x; e < 0; e += blockDim.x) {"),
                 ("  for (int o = threadIdx.x; o < cout; o += blockDim.x) {\n    float s = 0.0f;\n    for (int r = 0; r < rows; ++r) s += dz[r * ldz + o];",
                  "  for (int o = threadIdx.x; o < 0; o += blockDim.x) {\n    float s = 0.0f;\n    for (int r = 0; r < rows; ++r) s += dz[r * ldz + o];")],
                [("  for (int i = 0; i < 7; ++i) {\n    const Product& pr = prods[i];",
                  "  for (int i = 0; i < 0; ++i) {\n    const Product& pr = prods[i];")],
                [("  wgrad_group_kernel<<<", "  if (0) wgrad_group_kernel<<<"),
                 ("  split_sum_group_kernel<<<", "  if (0) split_sum_group_kernel<<<")]],
    # the winners' rows written to device memory for the products
    "norows": [[("  for (int e = threadIdx.x; e < nrows * ld; e += blockDim.x) {",
                 "  for (int e = threadIdx.x; e < 0; e += blockDim.x) {")]],
    # the input gradients of the PointNet and SetAbstraction layer 2 products
    "nodx": [[("  const int items = (rows / RT) * cin;\n  for (int e = threadIdx.x; e < items; e += blockDim.x) {",
               "  const int items = (rows / RT) * cin;\n  for (int e = threadIdx.x; e < 0; e += blockDim.x) {")]],
    # the sum of the per-block partial gradients
    "noreduce": [[("  reduce_partials<<<", "  if (0) reduce_partials<<<")]],
    # the neighbour selection (a cheap fill in its place, so the indices
    # stay inside the patch)
    "noselect": [[("  select_knn<KNN>(sx, sy, sz, sq, n, nbr);\n",
                   "  for (int e = tid; e < n * KNN; e += blockDim.x)\n"
                   "    nbr[e] = static_cast<unsigned short>((e / KNN + e % KNN) % n);\n"
                   "  __syncthreads();\n")],
                 [("  for (int i = tid; i < U; i += blockDim.x) knn_of<KNN>(winners[i], sx, sy, "
                   "sz, sq, n, nbr);",
                   "  for (int e = tid; e < n * KNN; e += blockDim.x)\n"
                   "    nbr[e] = static_cast<unsigned short>((e / KNN + e % KNN) % n);")]],
    # SetAbstraction layers 1-2 of the winners, before the max
    "nosafwd1": [[("      sa_group_forward<KNN, kBf16>(qs + g0, nbr, sx, sy, sz, sw1, sb1, sw2, sb2, "
                   "a1, a2);\n      sa_group_max<KNN, kBf16>(",
                   "      sa_group_max<KNN, kBf16>(")]],
    # SetAbstraction layer 3 and the max over slots of the winners
    "nosamax": [[("      sa_group_max<KNN, kBf16>(a2, sw3, sb3, bx0 + g0 * kEncX0 + 3, "
                  "best + g0 * kEncC3);",
                  "      if (0) sa_group_max<KNN, kBf16>(a2, sw3, sb3, bx0 + g0 * kEncX0 + 3, "
                  "best + g0 * kEncC3);")],
                [("      sa_group_max<KNN, kBf16>(a2, w3, sb3, bx0 + g0 * kEncX0 + 3, "
                  "best + g0 * kEncC3);",
                  "      if (0) sa_group_max<KNN, kBf16>(a2, w3, sb3, bx0 + g0 * kEncX0 + 3, "
                  "best + g0 * kEncC3);")]],
    # SetAbstraction layers 1-2 again, before each group's backward
    "nosafwd2": [[("      sa_group_forward<KNN, kBf16>(qs + g0, nbr, sx, sy, sz, sw1, sb1, sw2, sb2, "
                   "a1, a2);\n      sa_group_backward<KNN, kBf16>(",
                   "      sa_group_backward<KNN, kBf16>(")]],
    # PointNet layers 1-3 of the winners
    "nopn": [[("    pointnet_123<kBf16>(bx0, pw1, pb1, pw2, pb2, pw3, pb3, bx1, bx2, bx3);",
               "    __syncthreads();")]],
    # PointNet's input gradients (layers 4 to 1)
    "nopnbwd": [[("dense_bwd_x<16, true, true, kBf16>(", "if (0) dense_bwd_x<16, true, true, kBf16>("),
                 ("dense_bwd_x<16, true, false, kBf16>(", "if (0) dense_bwd_x<16, true, false, kBf16>(")]],
    # SetAbstraction layer 3's input gradient, routed through the max
    "noda2": [[("      for (int o = 0; o < kEncC3; ++o)\n        if (best[qi * kEncC3 + o] == slot)",
                "      for (int o = 0; o < 0; ++o)\n        if (best[qi * kEncC3 + o] == slot)")],
              [("      for (int t = st[slot]; t < st[slot + 1]; ++t) {",
                "      for (int t = st[slot]; t < st[slot]; ++t) {")]],
}
# the variants that apply to today's design (tests/test_torch_port_sa_fused.py)
CURRENT = ("full", "nopass2", "nosa_bwd", "nowgrad", "norows", "nodx", "noselect",
           "nosafwd1", "nosamax", "nosafwd2", "nopn", "nopnbwd", "noda2")


def encoder_inputs(dev):
    """(patches [512, 256, 3], cotangent [512, 16], sa_wb, pn_wb, knn): the
    IPDAE train step's patch batch of chip_smoke.py's clouds."""
    cfg = CodecConfig()
    clouds = cs.synthetic_clouds(cs.TRAIN_CLOUDS, cfg.N, cs.SEED)
    ae_state, _ = init_params(cs.SEED, cfg)
    ae, _ = make_models(cfg)
    ae.load_state_dict(ae_state)
    ae = ae.to(dev).eval()
    with torch.inference_mode():
        packed = pack_encode_upload(np.stack(clouds), np.zeros(len(clouds), np.int32))
        pcs, st = unpack_encode_upload(torch.from_numpy(packed.view(np.int32)).to(dev), cfg.N)
        patches = encode_geometry(pcs, st, cfg).patches
    g = torch.Generator().manual_seed(cs.SEED)
    cot = torch.randn((patches.shape[0], cfg.d), generator=g).to(dev)
    sa_wb = [(w.detach(), b.detach()) for w, b in ae.sa.layers()]
    pn_wb = [(w.detach(), b.detach()) for w, b in ae.pn.layers()]
    return patches.clone(), cot, sa_wb, pn_wb, cfg.sa_knn


def stage_table(dev) -> None:
    """Each launch's device time per call of the stage backward, per stage."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(cs.SEED + 1)
    calls = 3
    for name, new_xyz, xyz, feat, layers, nsample, radius in stage_inputs(
            dev, cs.PPPF_TRAIN_CLOUDS):
        gout = torch.randn((new_xyz.shape[0], new_xyz.shape[1], layers[-1][0].shape[1]),
                           generator=g).to(dev)

        kw = dict(nsample=nsample, radius=radius)
        runs = {"replaying": lambda: sa_ops.pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, **kw)}
        if "saved" in inspect.signature(sa_ops.pppf_sa_bwd).parameters:
            # the train step's backward, on what the forward's store mode stored
            saved = sa_ops.pppf_sa_fused(new_xyz, xyz, feat, layers, save=True, **kw)[1]
            runs["on the stored activations"] = lambda: sa_ops.pppf_sa_bwd(
                new_xyz, xyz, feat, gout, layers, saved=saved, **kw)
        for how, run in runs.items():
            run()
            torch.cuda.synchronize()
            ms = cs.cuda_ms(run, 3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    run()
                torch.cuda.synchronize()
            rows = [r for r in prof.key_averages()
                    if r.device_type == torch.autograd.DeviceType.CUDA]
            rows.sort(key=lambda r: r.self_device_time_total, reverse=True)
            total = sum(r.self_device_time_total for r in rows) / 1e3 / calls
            print(f"stage backward {name} P={new_xyz.shape[0]}, {how}: {ms:.3f} ms a call "
                  f"(CUDA events), {total:.3f} ms of kernels (profiler)", flush=True)
            for r in rows:
                print(f"  {r.self_device_time_total / 1e3 / calls:8.3f} ms  "
                      f"x{r.count // calls:<3d} {r.key[:80]}", flush=True)


def encoder_table(dev, bf16: bool = False) -> None:
    """CUDA-event times of the encoder backward's variants (bf16: of its
    bf16 instance, on the bf16 forward's winners)."""
    patches, cot, sa_wb, pn_wb, knn = encoder_inputs(dev)
    kernel = "patch_encoder_bwd_bf16" if bf16 else "patch_encoder_bwd"
    kw = {"bf16": True} if bf16 else {}
    if "winners" in inspect.signature(sa_cuda.patch_encoder_bwd).parameters:
        # the forward's winners, as the train step hands them over
        kw["winners"] = sa_cuda.patch_encoder(patches, sa_wb, pn_wb, knn, return_winners=True,
                                              **({"bf16": True} if bf16 else {}))[1]
    ref = sa_cuda.patch_encoder_bwd(patches, cot, sa_wb, pn_wb, knn, **kw)
    ref_flat = [ref[0]] + [t for wb in list(ref[1]) + list(ref[2]) for t in wb]
    saved = cuda_lib._functions.get(kernel)
    with tempfile.TemporaryDirectory() as tmp:
        fns = {name: entry(lib, kernel, saved.argtypes)
               for name, lib in build_variants(
                   tmp, {name: ("patch_encoder_bwd", alts)
                         for name, alts in ENC_VARIANTS.items()}).items()}
        try:
            for rnd in range(2):
                for variant, fn in fns.items():
                    # the wrapper, with the variant's entry point in its place
                    cuda_lib._functions[kernel] = fn
                    if variant == "full" and rnd == 0:
                        out = sa_cuda.patch_encoder_bwd(patches, cot, sa_wb, pn_wb, knn, **kw)
                        flat = [out[0]] + [t for wb in list(out[1]) + list(out[2]) for t in wb]
                        if not all(torch.equal(a, b) for a, b in zip(flat, ref_flat)):
                            raise RuntimeError("the full variant differs from the wrapper")
                    ms = cs.cuda_ms(
                        lambda: sa_cuda.patch_encoder_bwd(patches, cot, sa_wb, pn_wb, knn, **kw), 5)
                    print(f"round {rnd} encoder backward{' bf16' if bf16 else ''} {variant}: "
                          f"{ms:.3f} ms on {tuple(patches.shape)}", flush=True)
        finally:
            cuda_lib._functions[kernel] = saved


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bwd_breakdown needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    parts = [a for a in sys.argv[1:] if not a.startswith("--")] or ["stage", "encoder"]
    if "stage" in parts:
        stage_table(dev)
    if "encoder" in parts:
        encoder_table(dev, bf16="--bf16" in sys.argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
