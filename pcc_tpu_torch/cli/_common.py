"""Shared CLI pieces: the reference's codec flags and codec loading (the
geometry codec, and with --attributes the geometry + RGB one), and
--devices (pcc_tpu's add_devices_flag / maybe_mesh): one process per
device, parallel/mesh.py."""

from __future__ import annotations

import sys

import torch

from pcc_tpu_torch.codec import Codec, init_params
from pcc_tpu_torch.config import DEFAULT_SEED, MODELS, CodecConfig
from pcc_tpu_torch.parallel.mesh import is_distributed, launch, rank
from pcc_tpu_torch.weights import load_attr_params, load_inference_params


def add_codec_flags(p) -> None:
    """Flags shared by compress and decompress (reference names/defaults)."""
    p.add_argument("--N0", type=int, default=1024, help="Scale Transformation constant.")
    p.add_argument("--ALPHA", type=int, default=2, help="The factor of patch coverage ratio.")
    p.add_argument("--K", type=int, default=256, help="Number of points in each patch.")
    p.add_argument("--d", type=int, default=16, help="Bottleneck size.")
    p.add_argument("--L", type=int, default=7, help="Quantization Level.")
    p.add_argument("--model", default="AE", choices=list(MODELS),
                   help="Type of the model (AE or PPPF-AE); both families share "
                        "the binary pipeline.")
    p.add_argument("--seed", type=int, default=DEFAULT_SEED,
                   help="Seed of the random weights used when the model folder is empty.")
    p.add_argument("--batch_size", type=int, default=None,
                   help="Clouds per device batch. Default 64 (AE), 16 for PPPF-AE, as "
                        "pcc_tpu's CLIs.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on; 'cuda' raises when there is no card.")
    p.add_argument("--d_a", type=int, default=16,
                   help="Attribute bottleneck size (with --attributes).")


def config_from_args(args) -> CodecConfig:
    return CodecConfig(N0=args.N0, ALPHA=args.ALPHA, K=args.K, d=args.d, L=args.L,
                       model=args.model,
                       compute_dtype="bfloat16" if args.bf16 else "float32")


def batch_size_from_args(args) -> int:
    """--batch_size, default 64 (AE) or 16 (PPPF-AE) as pcc_tpu's CLIs,
    rounded down to a multiple of --devices, and at least --devices, as
    pcc_tpu's compress and decompress round it."""
    bs = args.batch_size if args.batch_size is not None else (
        16 if args.model == "PPPF-AE" else 64)
    n = args.devices
    return n * max(1, bs // n) if n > 1 and bs % n else bs


def load_codec(model_load_folder: str, cfg: CodecConfig, seed: int,
               batch_size: int = 64, device: str = "cuda") -> Codec:
    """Codec from pcc_tpu's ae.pkl/prob.pkl in the folder, or from seeded
    random weights when the folder holds none."""
    ae_state, prob_state = load_inference_params(model_load_folder)
    if ae_state is None:
        print0(f"WARNING: no ae.pkl/prob.pkl in {model_load_folder}; "
               "using randomly initialized weights.")
        ae_state, prob_state = init_params(seed, cfg)
    return Codec(cfg, ae_state, prob_state, batch_size=batch_size, device=device)


def load_attr_codec(model_load_folder: str, cfg: CodecConfig, seed: int, d_a: int = 16,
                    device: str = "cuda"):
    """AttrCodec (batches of 16, as pcc_tpu's) from pcc_tpu's ae/prob/attr/
    attr_prob pickles in the folder; a missing pair gets seeded random
    weights (the attribute pair from seed + 1), with a warning."""
    from pcc_tpu_torch.attrib import AttrCodec, init_attr_params

    ae_state, prob_state = load_inference_params(model_load_folder)
    if ae_state is None:
        print(f"WARNING: no ae.pkl/prob.pkl in {model_load_folder}; "
              "using randomly initialized weights.")
        ae_state, prob_state = init_params(seed, cfg)
    attr_state, attr_prob_state = load_attr_params(model_load_folder)
    if attr_state is None:
        print(f"WARNING: no attr.pkl/attr_prob.pkl in {model_load_folder}; "
              "using randomly initialized attribute weights.")
        attr_state, attr_prob_state = init_attr_params(seed + 1, cfg, d_a)
    params = {"ae": ae_state, "prob": prob_state, "attr": attr_state,
              "attr_prob": attr_prob_state}
    return AttrCodec(cfg, params, d_a=d_a, device=device)


def print0(*args, **kwargs) -> None:
    """print on rank 0 only (everywhere without a process group)."""
    if rank() == 0:
        print(*args, **kwargs)


def add_devices_flag(parser) -> None:
    parser.add_argument(
        "--devices", type=int, default=1,
        help="Data-parallel device count: >1 runs one process per device "
             "(cuda:0 .. cuda:N-1 on NCCL; with --device cpu, N processes on "
             "gloo) and shards the cloud batch across them. 1 = single-device "
             "(default).")


def maybe_launch(args, main_fn, argv, batch_size: int | None = None) -> bool:
    """pcc_tpu's maybe_mesh: False for --devices 1, and in a worker, where the
    caller then runs its body; else checks that N devices are visible and
    that N divides `batch_size` (where given), runs main_fn(argv) on N
    spawned workers (parallel/mesh.py::launch, which raises if one fails)
    and returns True."""
    n = args.devices
    if n <= 1 or is_distributed():
        return False
    avail = torch.cuda.device_count() if args.device == "cuda" else n
    if avail < n:
        raise SystemExit(
            f"--devices {n} requested but only {avail} device(s) visible "
            "(for CPU testing: --device cpu runs the N processes on gloo)")
    if batch_size is not None and batch_size % n:
        raise SystemExit(f"--batch_size {batch_size} must be divisible by --devices {n}")
    launch(n, main_fn, sys.argv[1:] if argv is None else list(argv), device=args.device)
    return True
