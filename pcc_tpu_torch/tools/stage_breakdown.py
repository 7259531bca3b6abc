"""Where the time of the SA stage kernel and of SetAbstraction alone goes,
on an NVIDIA GPU.

  python3 -m pcc_tpu_torch.tools.stage_breakdown [pppf] [pppe] [sa]
  # from the repo root; all three parts where none is named

Builds csrc/pppf_sa_stage.cu and csrc/sa_fused.cu as they are and with one
part taken out or one choice changed (tools/variants.py), then times each
with CUDA events:

- pppf: the "pppf" layout's per-point kernel on the stage inputs of the
  PPPF-AE serving path of chip_smoke.py (16 synthetic clouds, P = 1024
  patches, seeded weights and BatchNorm statistics). `noselect` leaves
  every query's point set empty (no selection and no work in the fold),
  `nostack` skips the stack and the fold, `nofold` skips the fold.
- pppe: the "pppe" layout at PPPE's serving shapes (sa2: 32 x 128 of 512
  points, widths 195-128-128-256; sa3: 32 x 32 of 128, 259-256-256-512;
  nsample 32; seeded inputs and weights). `wide` takes the (4, 16) tile
  (passes of 256 columns, one block an SM) wherever it may, `ks16` caps
  the weights' k-slabs at 16 rows, `splitonce` splits each k-slab of
  weights hi / lo once after it lands, the lo half into a third slab
  buffer (the kernel splits each fragment as a warp reads it; with the
  third buffer the k-slabs hold 16 rows at both stages), `noproducts` skips the slot
  kernel's tensor-core products, `nofeature` the feature block's launch.
- sa: SetAbstraction alone at the IPDAE serving patches [4096, 256, 3],
  knn 16 and 8 (seeded patches and weights). `noselect` gives every query
  itself as its neighbours (no selection), `noproducts` skips the products
  of layers 2 and 3.

The variants that take a part out give wrong outputs. `full` is checked
bit for bit against the wrapper; `wide`, `ks16` and `splitonce` change
only how the same sums are scheduled, and each line says whether they are
bit for bit `full`'s. Prints the card's name and power limit, then one
line per round and variant.
"""

from __future__ import annotations

import ctypes
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
from pcc_tpu_torch.tools.variants import build_variants, entry

PARTS = ("pppf", "pppe", "sa")
# the slot kernel's products, as the source writes them (since the bf16
# instance, and before it)
_CALLS = ("          warp_mma<NT, kBf16>(acc, xs + wm * 32 * ldx + s * ks, ldx,\n"
          "                              slab + (s & 1) * ks * ldw + wn * 8 * NT, ldw,\n"
          "                              min(ks, pad8(K) - s * ks) / 8);",
          "          warp_mma<NT>(acc, xs + wm * 32 * ldx + s * ks, ldx,\n"
          "                       slab + (s & 1) * ks * ldw + wn * 8 * NT, ldw,\n"
          "                       min(ks, pad8(K) - s * ks) / 8);")


# the "pppe" slot kernel with each k-slab of weights split hi / lo once,
# into a third slab buffer, and the products reading both halves (the
# products' text `call`)
def _split_once(call: str) -> list:
    return [
        ("  const size_t tiles = L > 1 ? static_cast<size_t>(kM) * st.lda +\n"
         "                                   2 * static_cast<size_t>(ks)",
         "  const size_t tiles = L > 1 ? static_cast<size_t>(kM) * st.lda +\n"
         "                                   3 * static_cast<size_t>(ks)"),
        ("constexpr int kL1Cols = 4;",
         "template <int NT>\n"
         "__device__ __forceinline__ void warp_mma_split(float (&acc)[2][NT][4], const float* a,\n"
         "                                               int lda, const float* bh, const float* bl,\n"
         "                                               int ldb, int ksteps) {\n"
         "  using namespace pcc_tile;\n"
         "  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;\n"
         "  for (int ks = 0; ks < ksteps; ++ks) {\n"
         "    const int kk = ks * 8;\n"
         "    unsigned ah[2][4], al[2][4];\n"
         "    load_a(a, lda, kk, ah, al);\n"
         "#pragma unroll\n"
         "    for (int nt = 0; nt < NT; ++nt) {\n"
         "      const int o = (kk + t) * ldb + nt * 8 + g;\n"
         "      const unsigned h[2] = {__float_as_uint(bh[o]), __float_as_uint(bh[o + 4 * ldb])};\n"
         "      const unsigned l[2] = {__float_as_uint(bl[o]), __float_as_uint(bl[o + 4 * ldb])};\n"
         "      mma_3xtf32(acc[0][nt], ah[0], al[0], h, l);\n"
         "      mma_3xtf32(acc[1][nt], ah[1], al[1], h, l);\n"
         "    }\n"
         "  }\n"
         "}\n\n"
         "constexpr int kL1Cols = 4;"),
        (call,
         "          {\n"
         "            float* hb = slab + (s & 1) * ks * ldw;\n"
         "            float* lb = slab + 2 * ks * ldw;\n"
         "            for (int e = tid; e < ks * ldw; e += kThreads) {\n"
         "              unsigned h, l;\n"
         "              split_tf32(hb[e], h, l);\n"
         "              hb[e] = __uint_as_float(h);\n"
         "              lb[e] = __uint_as_float(l);\n"
         "            }\n"
         "          }\n"
         "          __syncthreads();\n"
         "          warp_mma_split<NT>(acc, xs + wm * 32 * ldx + s * ks, ldx,\n"
         "                             slab + (s & 1) * ks * ldw + wn * 8 * NT,\n"
         "                             slab + 2 * ks * ldw + wn * 8 * NT, ldw,\n"
         "                             min(ks, pad8(K) - s * ks) / 8);"),
    ]


# "part variant" -> (kernel, alternatives); see tools/variants.py
VARIANTS = {
    "pppf full": ("pppf_sa_stage", [[]]),
    "pppf noselect": ("pppf_sa_stage", [[("  for (int q0 = 0; q0 < s; q0 += st.qb) {",
                                          "  for (int q0 = 0; q0 < 0; q0 += st.qb) {")]]),
    "pppf nostack": ("pppf_sa_stage", [[("  for (int row0 = 0; row0 < n; row0 += st.rows) {",
                                         "  for (int row0 = 0; row0 < 0; row0 += st.rows) {")]]),
    "pppf nofold": ("pppf_sa_stage", [[
        ("        fold_query_max<true>(t, ldt,", "        if (0) fold_query_max<true>(t, ldt,"),
        ("        fold_query_max<false>(t, ldt,", "        if (0) fold_query_max<false>(t, ldt,")]]),
    "pppe full": ("pppf_sa_stage", [[]]),
    "pppe wide": ("pppf_sa_stage", [[("{{4, 8}, {4, 16}, {2, 16}, {1, 16}}",
                                      "{{4, 16}, {4, 8}, {2, 16}, {1, 16}}")]]),
    "pppe ks16": ("pppf_sa_stage", [[("      for (int ks = 32; ks >= 8 && plan < 0; ks /= 2) {",
                                      "      for (int ks = 16; ks >= 8 && plan < 0; ks /= 2) {")]]),
    "pppe splitonce": ("pppf_sa_stage", [_split_once(c) for c in _CALLS]),
    "pppe noproducts": ("pppf_sa_stage", [[(c, c.replace("warp_mma", "if (0) warp_mma", 1))]
                                         for c in _CALLS]),
    "pppe nofeature": ("pppf_sa_stage", [[(f"    pppe_feature_kernel{t}<<<grid",
                                           f"    if (0) pppe_feature_kernel{t}<<<grid")]
                                         for t in ("<kBf16>", "")]),
    "sa full": ("sa_fused", [[]]),
    "sa noselect": ("sa_fused", [[
        ("      knn_of<KNN>(i, q, q + n, q + 2 * n, q + 3 * n, n, tables + b * n * KNN);",
         "      for (int s = 0; s < KNN; ++s) tables[b * n * KNN + i * KNN + s] = i;")]]),
    "sa noproducts": ("sa_fused", [[("          wgmma_m64n", "          if (0) wgmma_m64n")]]),
}
# variants that schedule the same sums as `full`
SAME_SUMS = ("wide", "ks16", "splitonce")


def stage_inputs(dev, n_clouds: int = cs.PPPF_CLOUDS):
    """[(name, new_xyz, xyz, feat, layers, nsample, radius)] of the three
    stages on n_clouds of chip_smoke.py's clouds (default: its PPPF-AE
    serving batch)."""
    cfg = CodecConfig(model="PPPF-AE")
    clouds = cs.synthetic_clouds(n_clouds, cfg.N, cs.SEED)
    ae_state, _ = init_params(cs.SEED, cfg)
    ae, _ = make_models(cfg)
    ae.load_state_dict(cs.randomize_batchnorm(ae_state, cs.SEED + 2))
    ae = ae.to(dev).eval()
    with torch.inference_mode():
        packed = pack_encode_upload(np.stack(clouds), np.zeros(len(clouds), np.int32))
        pcs, st = unpack_encode_upload(torch.from_numpy(packed.view(np.int32)).to(dev), cfg.N)
        xyz, feat, cases = encode_geometry(pcs, st, cfg).patches, None, []
        for name in ("sa1", "sa2", "sa3"):
            sa = getattr(ae.encoder, name)
            new_xyz = sa.queries(xyz).contiguous()
            cases.append((name, new_xyz, xyz, feat, sa.layers(), sa.nsample, sa.radius))
            feat = sa_ops.pppf_sa_fused(new_xyz, xyz, feat, sa.layers(), nsample=sa.nsample,
                                        radius=sa.radius)
            xyz = new_xyz
    return cases


def pppe_inputs(dev):
    """[(name, new_xyz, xyz, feat, layers, nsample, radius)] at PPPE's sa2
    and sa3 serving shapes, seeded."""
    g = torch.Generator().manual_seed(0)
    cases = []
    for name, P, S, N, C, widths in (("sa2", 32, 128, 512, 192, (128, 128, 256)),
                                     ("sa3", 32, 32, 128, 256, (256, 256, 512))):
        xyz = torch.rand((P, N, 3), generator=g).to(dev)
        new_xyz = xyz[:, torch.randperm(N, generator=g)[:S]].contiguous()
        feat = torch.randn((P, N, C), generator=g).to(dev)
        layers, cin = [], C + 3
        for cout in widths:
            bound = cin ** -0.5
            layers.append(tuple(t.to(dev) for t in (
                (torch.rand((cin, cout), generator=g) * 2 - 1) * bound,
                (torch.rand(cout, generator=g) * 2 - 1) * bound,
                (torch.rand(cout, generator=g) - 0.5) * 0.2, torch.rand(cout, generator=g) + 0.5,
                (torch.rand(cout, generator=g) - 0.3) * 0.5)))
            cin = cout
        cases.append((name, new_xyz, xyz, feat, layers, 32, 0.0))
    return cases


def stage_launch(fn, layout, new_xyz, xyz, feat, layers, nsample, radius) -> torch.Tensor:
    """One stage through a variant's entry point, as pppf_sa_fused calls it."""
    widths = [layers[0][0].shape[0]] + [lay[0].shape[1] for lay in layers]
    P, S, _ = new_xyz.shape
    N = xyz.shape[1]
    out = torch.empty((P, S, widths[-1]), device=new_xyz.device)
    y = (torch.empty((P, N, widths[1]), device=new_xyz.device)
         if layout == "pppe" and feat is not None else None)
    ptrs = (ctypes.c_void_p * (5 * len(layers)))(*[t.data_ptr() for lay in layers for t in lay])
    err = fn(new_xyz.data_ptr(), xyz.data_ptr(), None if feat is None else feat.data_ptr(),
             out.data_ptr(), P, S, N, 0 if feat is None else feat.shape[2], nsample,
             sa_ops._radius2(radius), sa_ops.LAYOUTS.index(layout), len(layers), ptrs,
             (ctypes.c_int * len(widths))(*widths), None, None, None, None,
             None if y is None else y.data_ptr(), cuda_lib.stream_ptr(new_xyz))
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")
    return out


def sa_launch(fn, pts, sa, knn) -> torch.Tensor:
    """SetAbstraction alone through a variant's entry point."""
    out = torch.empty(pts.shape[:2] + (128,), device=pts.device)
    err = fn(pts.data_ptr(), pts.shape[0], pts.shape[1], knn,
             *[t.data_ptr() for wb in sa for t in wb], out.data_ptr(), cuda_lib.stream_ptr(pts))
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")
    return out


def main(argv=None) -> int:
    parts = list(sys.argv[1:] if argv is None else argv) or list(PARTS)
    if not set(parts) <= set(PARTS):
        raise SystemExit(f"stage_breakdown: parts are {PARTS}, not {parts}")
    if not torch.cuda.is_available():
        raise SystemExit("stage_breakdown needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    # part -> (cases, run(fn, case), reps)
    runs = {}
    if "pppf" in parts:
        runs["pppf"] = (stage_inputs(dev), lambda fn, c: stage_launch(fn, "pppf", *c[1:]), 10)
    if "pppe" in parts:
        runs["pppe"] = (pppe_inputs(dev), lambda fn, c: stage_launch(fn, "pppe", *c[1:]), 20)
    if "sa" in parts:
        g = torch.Generator().manual_seed(1)
        pts = ((torch.rand((4096, 256, 3), generator=g) * 2 - 1) * 0.4).to(dev)
        sa = [(((torch.rand((a, b), generator=g) * 2 - 1) * a ** -0.5).to(dev),
               ((torch.rand(b, generator=g) * 2 - 1) * a ** -0.5).to(dev))
              for a, b in zip(sa_cuda.SA_WIDTHS[:-1], sa_cuda.SA_WIDTHS[1:])]
        runs["sa"] = ([(f"knn {k}", k) for k in (16, 8)],
                      lambda fn, c: sa_launch(fn, pts, sa, c[1]), 5)
    wrapper = {
        "pppf": lambda c: sa_ops.pppf_sa_fused(*c[1:5], nsample=c[5], radius=c[6]),
        "pppe": lambda c: sa_ops.pppf_sa_fused(*c[1:5], nsample=c[5], radius=c[6],
                                               layout="pppe"),
        "sa": lambda c: sa_cuda.sa_fused(pts, sa, c[1]),
    }
    chosen = {label: spec for label, spec in VARIANTS.items() if label.split()[0] in runs}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, chosen)
        fns = {}
        for label, lib in libs.items():
            kernel = VARIANTS[label][0]
            fns[label] = entry(lib, kernel, sa_ops._ARGTYPES if kernel == "pppf_sa_stage"
                               else sa_cuda._SA_ARGTYPES)
        same = {}
        for part, (cases, run, _) in runs.items():
            full = [run(fns[f"{part} full"], c) for c in cases]
            for c, out in zip(cases, full):
                if not torch.equal(out, wrapper[part](c)):
                    raise RuntimeError(f"{part} {c[0]}: the full variant differs from the wrapper")
            for label, fn in fns.items():
                if label.split()[0] == part and label.split()[1] in SAME_SUMS:
                    same[label] = all(torch.equal(run(fn, c), out) for c, out in zip(cases, full))
        for rnd in range(2):
            for label, fn in fns.items():
                cases, run, reps = runs[label.split()[0]]
                ms = [(c[0], cs.cuda_ms(lambda: run(fn, c), reps)) for c in cases]
                note = f" (bit for bit full's: {same[label]})" if label in same else ""
                print(f"round {rnd} {label}: " + ", ".join(f"{k} {t:.4f} ms" for k, t in ms)
                      + note, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
