"""Where the time of the SA stage kernel goes, on an NVIDIA GPU.

  python3 -m pcc_tpu_torch.tools.stage_breakdown      # from the repo root

Builds csrc/pppf_sa_stage.cu as it is and with one phase of its per-point
kernel taken out (nvcc, all variants in parallel, into a temporary
directory), then times each with CUDA events on the stage inputs of the
PPPF-AE serving path of chip_smoke.py (16 synthetic clouds, P = 1024
patches, seeded weights and BatchNorm statistics): `noselect` leaves every
query's point set empty (no selection and no work in the fold), `nostack`
skips the stack and the fold, `nofold` skips the fold. The variants give
wrong outputs; only `full` is checked, bit for bit against the wrapper.
Prints the card's name and power limit, then one line per round and
variant: the three stages' milliseconds.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from pcc_tpu_torch.codec import (encode_geometry, init_params, make_models, pack_encode_upload,
                                 unpack_encode_upload)
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops import pppf_sa_cuda as sa_ops

SRC = "pppf_sa_stage.cu"
# variant -> (old, new) replacements in SRC
VARIANTS = {
    "full": [],
    "noselect": [("  for (int q0 = 0; q0 < s; q0 += st.qb) {",
                  "  for (int q0 = 0; q0 < 0; q0 += st.qb) {")],
    "nostack": [("  for (int row0 = 0; row0 < n; row0 += st.rows) {",
                 "  for (int row0 = 0; row0 < 0; row0 += st.rows) {")],
    "nofold": [("        fold_query_max<true>(t, ldt,", "        if (0) fold_query_max<true>(t, ldt,"),
               ("        fold_query_max<false>(t, ldt,",
                "        if (0) fold_query_max<false>(t, ldt,")],
}


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


def build_variants(tmp: str) -> dict:
    """variant -> its launch function, each built by its own nvcc process."""
    procs = {}
    for name, edits in VARIANTS.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in os.listdir(cuda_lib.CSRC_DIR):
            with open(os.path.join(cuda_lib.CSRC_DIR, f)) as fh:
                text = fh.read()
            if f == SRC:
                for old, new in edits:
                    if old not in text:
                        raise RuntimeError(f"variant {name}: {old!r} not in {SRC}")
                    text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        so = os.path.join(d, "stage.so")
        cmd = [cuda_lib._nvcc(), *cuda_lib._NVCC_FLAGS, "-o", so, os.path.join(d, SRC)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        fn = ctypes.CDLL(so).pppf_sa_stage_launch
        fn.restype, fn.argtypes = ctypes.c_int, sa_ops._ARGTYPES
        fns[name] = fn
    return fns


def launch(fn, new_xyz, xyz, feat, layers, nsample, radius) -> torch.Tensor:
    widths = [layers[0][0].shape[0]] + [lay[0].shape[1] for lay in layers]
    P, S, _ = new_xyz.shape
    out = torch.empty((P, S, widths[-1]), device=new_xyz.device)
    ptrs = (ctypes.c_void_p * (5 * len(layers)))(*[t.data_ptr() for lay in layers for t in lay])
    err = fn(new_xyz.data_ptr(), xyz.data_ptr(), None if feat is None else feat.data_ptr(),
             out.data_ptr(), P, S, xyz.shape[1], 0 if feat is None else feat.shape[2], nsample,
             sa_ops._radius2(radius), 0, len(layers), ptrs,
             (ctypes.c_int * len(widths))(*widths), None, None, None, None,
             cuda_lib.stream_ptr(new_xyz))
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stage_breakdown needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cases = stage_inputs(dev)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(tmp)
        for name, *args in cases:
            ref = sa_ops.pppf_sa_fused(*args[:4], nsample=args[4], radius=args[5])
            if not torch.equal(launch(fns["full"], *args), ref):
                raise RuntimeError(f"{name}: the full variant differs from the wrapper")
        for rnd in range(2):
            for variant, fn in fns.items():
                ms = [cs.cuda_ms(lambda: launch(fn, *args), 10) for _, *args in cases]
                print(f"round {rnd} {variant}: " + ", ".join(
                    f"{name} {t:.3f} ms" for (name, *_), t in zip(cases, ms)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
