"""Where the time of the bf16 encoder and the bf16 "pppf" stage goes, and
how many entries their certified rounding (csrc/certified.cuh) flags, on
an NVIDIA GPU.

  python3 -m pcc_tpu_torch.tools.cert_breakdown [encoder] [stage] [--json PATH]
  # from the repo root; both parts where none is named

Builds csrc/patch_encoder.cu and csrc/pppf_sa_stage.cu as they are and as
variants (tools/variants.py), drives each through its public wrapper
(ops/sa_cuda.py::patch_encoder, ops/pppf_sa_cuda.py::pppf_sa_fused, with
the variant's entry point in place of the kernel's) and times it with CUDA
events:

- `count`: the counting build (PCC_CERT_COUNT): the flagged entries and the
  entries of every certified layer, printed as shares beside its time;
- `nofix`: the fix-ups skipped; `noabs`: the second product (|a| |w|)
  skipped; `noselect` (encoder): every query's neighbours its own index
  and the next ones, no selection. These give wrong outputs.

encoder: [4096, 256, 3] patches (the IPDAE serving batch's shape), knn 16,
D 16, seeded weights (torch's default initialisation, rounded to bf16), and
the same with the last layer calibrated as chip_smoke.py's spread_symbols
does (scaled to a spread of 0.4 and shifted by its mean; that layer runs
in k-order on the CUDA cores, so only the latents change); its winners
launch at [512, 256, 3]. stage: the three PPPF-AE stages at the serving
batch's shapes (P = 1024) on seeded inputs and BatchNorm terms, a fifth of
the multipliers negative. `as_is` is checked bit for bit against the
wrapper's output. Prints the card's name and power limit, then one line
per case and variant.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time

import torch

from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops import pppf_sa_cuda as st_ops
from pcc_tpu_torch.ops import sa_cuda
from pcc_tpu_torch.tools.variants import build_variants, entry

PARTS = ("encoder", "stage")
INCLUDE = '#include "certified.cuh"\n'
MACROS = {"count": "PCC_CERT_COUNT", "nofix": "PCC_CERT_NOFIX", "noabs": "PCC_CERT_NOABS"}
ENC_TAGS = ("sa2", "sa3+max", "pn1", "pn2", "pn3")
REPS = 10


def _variants(kernel: str, extra: dict) -> dict:
    out = {"as_is": (kernel, [[]])}
    for name, macro in MACROS.items():
        out[name] = (kernel, [[(INCLUDE, f"#define {macro} 1\n{INCLUDE}")]])
    for name, edits in extra.items():
        out[name] = (kernel, [edits])
    return out


def _ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def _counts(lib, kernel: str, tags: int) -> list:
    fn = getattr(lib, f"{kernel}_cert_counts")
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]
    host = (ctypes.c_ulonglong * (2 * tags))()
    if fn(ctypes.addressof(host), tags) != 0:
        raise RuntimeError(f"{kernel}_cert_counts failed")
    return [host[2 * i] / max(host[2 * i + 1], 1) for i in range(tags)]


def _drive(libs: dict, kernel: str, argtypes, call, tags, labels, log) -> dict:
    """Time call() with each variant's entry in the wrapper's place; the
    counting build's shares per tag."""
    res = {}
    ref = None
    for label, lib in libs.items():
        cuda_lib._functions[kernel] = entry(lib, kernel, argtypes)
        if label == "count":
            _counts(lib, kernel, tags)            # zero
            call()
            torch.cuda.synchronize()
            shares = _counts(lib, kernel, tags)
        out = call()
        if label == "as_is":
            ref = out
        t = _ms(call)
        rec = dict(ms=t)
        line = f"  {label}: {t:.4f} ms"
        if label == "count":
            rec["flagged"] = dict(zip(labels, shares))
            line += "; flagged " + ", ".join(f"{k} {v:.5f}" for k, v in rec["flagged"].items())
        if label == "as_is":
            cuda_lib._functions.pop(kernel)
            line += f"; bit for bit the wrapper's: {torch.equal(call(), ref)}"
        log(line)
        res[label] = rec
    cuda_lib._functions.pop(kernel, None)
    return res


def _wb(g, widths, dev):
    out = []
    for a, b in zip(widths[:-1], widths[1:]):
        w = (torch.rand((a, b), generator=g) * 2 - 1) * a ** -0.5
        out.append((w.to(dev), ((torch.rand(b, generator=g) * 2 - 1) * a ** -0.5).to(dev)))
    return out


# the encoder without its selection: query q's neighbours q, q + 1, ...
NOSELECT = [("  select_knn<KNN>(sx, sy, sz, sq, n, nbr);\n\n  const bool vec",
             "  for (int e = threadIdx.x; e < n * KNN; e += kThreads)\n"
             "    nbr[e] = static_cast<unsigned short>((e / KNN + e % KNN) % n);\n"
             "  __syncthreads();\n\n  const bool vec")]


# the encoder without SetAbstraction (x0's feature columns left as they
# are) and without the last layer's products
NOSA = [("      sa_tile<KNN>(row0, c0, nbr, sx, sy, sz, w1, b1, wsa + kF2, wsa + kF3, e2, e3, h1, "
         "h2, x0,\n                   queues + warp * kQueue);", "      ;")]
NOLAST = [("        last_step<true>(x3, pw4, cs, dout, acc);", "        ;")]


def encoder_part(tmp: str, log) -> dict:
    t0 = time.perf_counter()
    libs = build_variants(tmp, _variants("patch_encoder_bf16", {
        "noselect": NOSELECT, "nosa": NOSA, "nolast": NOLAST}))
    log(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    dev = "cuda"
    g = torch.Generator().manual_seed(31)
    pts = ((torch.rand((4096, 256, 3), generator=g) * 2 - 1) * 0.4).to(dev)
    sa, pn = _wb(g, [3, 32, 64, 128], dev), _wb(g, [131, 128, 256, 512, 16], dev)
    z = sa_cuda.patch_encoder(pts, sa, pn, 16)
    w4, b4 = pn[-1]
    scale = 0.4 / z.std(dim=0)
    cal = pn[:-1] + [(w4 * scale, (b4 - z.mean(dim=0)) * scale)]
    res = {}
    for name, weights in (("seeded", (sa, pn)), ("calibrated", (sa, cal))):
        sa16, pn16 = sa_cuda.bf16_wb(weights[0]), sa_cuda.bf16_wb(weights[1])
        log(f"encoder {name} [4096, 256, 3], knn 16, D 16:")
        res[name] = _drive(libs, "patch_encoder_bf16", sa_cuda._BF16_ARGTYPES,
                           lambda: sa_cuda.patch_encoder(pts, sa16, pn16, 16, bf16=True),
                           len(ENC_TAGS), ENC_TAGS, log)
    p5 = pts[:512].contiguous()
    log("encoder with winners [512, 256, 3], knn 16, D 16:")
    res["winners"] = _drive(
        libs, "patch_encoder_bf16", sa_cuda._BF16_ARGTYPES,
        lambda: sa_cuda.patch_encoder(p5, sa, pn, 16, return_winners=True, bf16=True)[1],
        len(ENC_TAGS), ENC_TAGS, log)
    return res


# the PPPF-AE stages at the serving batch: (S, N, C, nsample, radius, widths)
STAGES = (("sa1", 256, 256, 0, 32, 0.2, (3, 64, 64, 128)),
          ("sa2", 128, 256, 128, 64, 0.4, (128, 128, 256)),
          ("sa3", 32, 128, 256, 128, 0.8, (256, 512, 1024)))


def stage_layers(g, widths, dev):
    layers = []
    for a, b in zip(widths[:-1], widths[1:]):
        w = (torch.rand((a, b), generator=g) * 2 - 1) * a ** -0.5
        mul = torch.rand(b, generator=g) * 1.5 + 0.25
        mul[::5] *= -1
        rest = [(torch.rand(b, generator=g) * 2 - 1) * 0.1 for _ in range(3)]
        layers.append(tuple(t.to(dev) for t in (w, rest[0], rest[1], mul, rest[2])))
    return st_ops.bf16_layers(layers)


def stage_part(tmp: str, log) -> dict:
    t0 = time.perf_counter()
    libs = build_variants(tmp, _variants("pppf_sa_stage_bf16", {}))
    log(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    dev = "cuda"
    g = torch.Generator().manual_seed(32)
    res = {}
    for name, S, N, C, ns, radius, widths in STAGES:
        xyz = torch.rand((1024, N, 3), generator=g).to(dev)
        new_xyz = xyz if S == N else xyz[:, torch.randint(0, N, (S,), generator=g)].contiguous()
        feat = (torch.rand((1024, N, C), generator=g).to(torch.bfloat16).float().to(dev)
                if C else None)
        layers = stage_layers(g, (C + 3,) + widths, dev)
        log(f"stage {name} [1024, {S}, {N}] widths {(C + 3,) + widths} nsample {ns}:")
        res[name] = _drive(
            libs, "pppf_sa_stage_bf16", st_ops._BF16_SERVE_ARGTYPES,
            lambda: st_ops.pppf_sa_fused(new_xyz, xyz, feat, layers, nsample=ns, radius=radius,
                                         bf16=True),
            len(widths), [f"layer{i}" for i in range(len(widths))], log)
    return res


def main(argv) -> None:
    path = None
    if "--json" in argv:
        i = argv.index("--json")
        path = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    parts = [a for a in argv if a in PARTS] or list(PARTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out = dict(device=smi)

    def log(line):
        print(line, flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        if "encoder" in parts:
            out["encoder"] = encoder_part(tmp + "/e", log)
        if "stage" in parts:
            out["stage"] = stage_part(tmp + "/s", log)
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
