"""Where the time of the IPDAE patch decoder kernel goes, on an NVIDIA GPU.

  python3 -m pcc_tpu_torch.tools.decoder_breakdown [--bf16]   # from the repo root

Builds csrc/patch_decoder.cu as it is and with one part taken out
(tools/variants.py), then times each with
CUDA events at the IPDAE serving batch's shapes (chip_smoke.py's default
CodecConfig and seeded weights, 64 clouds: P = 4096 patches of k = 128
points, h2 [4096, 1024], seeded quantized latents): `noexp` leaves out the
1024 -> k*128 expansion (the fold is relu of the bias alone), `nomlp` leaves
out the 144 -> 128 -> 64 -> 32 point MLP. A variant applies where its texts
are in the source (the list covers the designs of several revisions: run
the tool and tools/variants.py from a copy of an older tree to time that
tree's kernel); the
variants give wrong outputs, and only `full` is checked, bit for bit
against the wrapper. Beside them: torch.matmul(h2, w3r) in float32 with
TF32 off (the expansion product alone, as cuBLAS computes it), the plain
version, and the preparation of the kernel's weights that the decode path
makes where it holds none (permute_expansion, and pack_decoder where the
kernel takes its own layout).

With --bf16 the same for the bf16 instance (patch_decoder_bf16, on its own
weight layout): `nomlp` leaves out the point MLP, `noexpmma` the
expansion's products (the loads stay); beside them torch.matmul(h2, w3r)
in bf16 (the expansion alone, cuBLAS), h2's conversion to bf16 that the
wrapper makes, the plain version, and the bytes from L2 by the tile plan
(ops/decoder_cuda.py::bf16_tma_bytes).

Prints the card's name and power limit, then one line per round.
"""

from __future__ import annotations

import inspect
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from pcc_tpu_torch.codec import init_params, make_models
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops import decoder_cuda
from pcc_tpu_torch.tools.variants import build_variants, entry

# variant -> alternatives of csrc/patch_decoder.cu (tools/variants.py)
VARIANTS = {
    "full": [[]],
    "noexp": [
        # CUDA-core design: the staged K loop
        [("  for (int k0 = 0; k0 < C; k0 += kBK) {", "  for (int k0 = 0; k0 < 0; k0 += kBK) {")],
        # wgmma design: the mainloop's stages
        [("constexpr bool kRunExpansion = true;", "constexpr bool kRunExpansion = false;")],
    ],
    "nomlp": [
        [("  pcc::dense_rows<8, true, true>(", "  if (0) pcc::dense_rows<8, true, true>(")],
        [("constexpr bool kRunMlp = true;", "constexpr bool kRunMlp = false;")],
    ],
}
# variant -> alternatives of csrc/patch_decoder.cu's bf16 instance
BF16_VARIANTS = {
    "full": [[]],
    "nomlp": [[("      pair_mlp(p, f, la,", "      if (false) pair_mlp(p, f, la,"),
               ("      point_mlp(p, f[0], la,", "      if (false) point_mlp(p, f[0], la,")]],
    "noexpmma": [[("      for (int q = 0; q < 4; ++q) wgmma_bf16_ss_m64n256k16(",
                   "      for (int q = 0; q < 0; ++q) wgmma_bf16_ss_m64n256k16(")]],
}
REPS = 10


def decoder_case(dev):
    """(h2, lat, w3r, b3r, mlp_wb, k, model) at the IPDAE serving batch's
    shapes, from chip_smoke.py's seed."""
    cfg = CodecConfig()
    ae_state, _ = init_params(cs.SEED, cfg)
    ae, _ = make_models(cfg)
    ae.load_state_dict(ae_state)
    ae = ae.to(dev).eval()
    rng = np.random.default_rng(cs.SEED)
    P = cs.N_CLOUDS * cfg.S
    lat = torch.from_numpy(rng.integers(-(cfg.L // 2), cfg.L // 2 + 1, (P, cfg.d))
                           .astype(np.float32)).to(dev)
    l1, l2, l3 = ae.inv_pool[0], ae.inv_pool[2], ae.inv_pool[4]
    h2 = torch.relu(torch.relu(lat @ l1.weight.t() + l1.bias) @ l2.weight.t() + l2.bias)
    w3r, b3r = decoder_cuda.permute_expansion(l3.weight.t(), l3.bias, cfg.k)
    return h2.contiguous(), lat, w3r, b3r, ae.inv_mlp.layers(), cfg.k, ae


def main_bf16(dev) -> int:
    """The bf16 instance's variants at the serving batch's shapes."""
    with torch.inference_mode():
        h2, lat, w3r, b3r, mlp, k, ae = decoder_case(dev)
        packed = decoder_cuda.pack_decoder(decoder_cuda.expansion_kmajor(ae.inv_pool[4].weight, k),
                                           b3r, mlp, bf16=True)
        call = lambda: decoder_cuda.patch_decoder(h2, lat, w3r, b3r, mlp, k,  # noqa: E731
                                                  packed=packed, bf16=True)
        ref = call()
        P, C = h2.shape
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        print(f"bytes from L2 by the tile plan: "
              f"{decoder_cuda.bf16_tma_bytes(P, C, k, sms) / 1e9:.3f} GB", flush=True)
        h2b, w3b = h2.to(torch.bfloat16), w3r.to(torch.bfloat16)
        name = "patch_decoder_bf16"
        with tempfile.TemporaryDirectory() as tmp:
            fns = {v: entry(lib, name, decoder_cuda._BF16_ARGTYPES)
                   for v, lib in build_variants(
                       tmp, {v: (name, alts) for v, alts in BF16_VARIANTS.items()}).items()}
            own = cuda_lib.function(name, decoder_cuda._BF16_ARGTYPES)
            try:
                cuda_lib._functions[name] = fns["full"]
                if not torch.equal(call(), ref):
                    raise RuntimeError("the full variant differs from the wrapper")
                for rnd in range(2):
                    times = {}
                    for variant, fn in fns.items():
                        cuda_lib._functions[name] = fn
                        times[variant] = cs.cuda_ms(call, REPS)
                        times[f"{variant} device"] = cs.graph_ms(call, REPS)
                    cuda_lib._functions[name] = own
                    times["matmul(h2, w3r) bf16"] = cs.cuda_ms(lambda: torch.matmul(h2b, w3b),
                                                               REPS)
                    times["h2 to bf16"] = cs.cuda_ms(lambda: h2.to(torch.bfloat16), REPS)
                    times["plain"] = cs.cuda_ms(lambda: decoder_cuda.patch_decoder_plain(
                        h2, lat, w3r, b3r, mlp, k, bf16=True), 3)
                    print(f"round {rnd} bf16 (P = {P}, k = {k}): " + ", ".join(
                        f"{v} {t:.4f} ms" for v, t in times.items()), flush=True)
            finally:
                cuda_lib._functions[name] = own
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("decoder_breakdown needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if "--bf16" in sys.argv[1:]:
        return main_bf16(dev)
    with torch.inference_mode():
        h2, lat, w3r, b3r, mlp, k, ae = decoder_case(dev)
        l3 = ae.inv_pool[4]
        pack = getattr(decoder_cuda, "pack_decoder", None)
        extra = {}
        if pack is not None and "packed" in inspect.signature(decoder_cuda.patch_decoder).parameters:
            prepare = lambda: pack(decoder_cuda.expansion_kmajor(l3.weight, k), b3r, mlp)  # noqa: E731
            extra = {"packed": prepare()}
        call = lambda: decoder_cuda.patch_decoder(h2, lat, w3r, b3r, mlp, k, **extra)  # noqa: E731
        ref = call()
        with tempfile.TemporaryDirectory() as tmp:
            fns = {name: entry(lib, "patch_decoder", decoder_cuda._ARGTYPES)
                   for name, lib in build_variants(
                       tmp, {name: ("patch_decoder", alts)
                             for name, alts in VARIANTS.items()}).items()}
            own = cuda_lib.function("patch_decoder", decoder_cuda._ARGTYPES)
            try:
                cuda_lib._functions["patch_decoder"] = fns["full"]
                if not torch.equal(call(), ref):
                    raise RuntimeError("the full variant differs from the wrapper")
                for rnd in range(2):
                    times = {}
                    for variant, fn in fns.items():
                        cuda_lib._functions["patch_decoder"] = fn
                        times[variant] = cs.cuda_ms(call, REPS)
                    cuda_lib._functions["patch_decoder"] = own
                    times["matmul(h2, w3r) fp32"] = cs.cuda_ms(lambda: h2 @ w3r, REPS)
                    times["plain"] = cs.cuda_ms(
                        lambda: decoder_cuda.patch_decoder_plain(h2, lat, w3r, b3r, mlp, k), 3)
                    times["permute_expansion"] = cs.cuda_ms(
                        lambda: decoder_cuda.permute_expansion(l3.weight.t(), l3.bias, k), REPS)
                    if extra:
                        times["pack_decoder"] = cs.cuda_ms(prepare, REPS)
                    print(f"round {rnd} (P = {h2.shape[0]}, k = {k}): " + ", ".join(
                        f"{name} {t:.4f} ms" for name, t in times.items()), flush=True)
            finally:
                cuda_lib._functions["patch_decoder"] = own
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
