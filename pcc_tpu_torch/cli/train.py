"""Train the patch autoencoder (reference train.py CLI, PyTorch port of
pcc_tpu/cli/train.py).

Flags, defaults and derived parameters are pcc_tpu's (reference
train.py:29-53,254), plus --device cuda|cpu ('cuda' raises where there is
no card). On the card the step runs the port's CUDA kernels (IPDAE: FPS,
the patch encoder and its backward; PPPF-AE: FPS, and after the BatchNorm
warm-up the PN++ stage and its backward; both families the chamfer
forward and backward at every cloud size, ops/chamfer.py's route); on the
CPU their plain versions.
Checkpoints are pcc_tpu-readable (train/checkpoint.py). PPPE training is
cli/train_pppe_pcd_ae.py, the attribute codec's cli/train_attributes.py.

  python -m pcc_tpu_torch.cli.train --train_glob 'in/*.ply' \\
      --model_save_folder model/ --batch_size 8 [--model PPPF-AE] [--device cpu]

--model PPPF-AE trains the first --bn_warmup_steps steps with the
encoder's BatchNorm on batch statistics (plain products), then the fused
step with them frozen (train/steps_pppf.py), as pcc_tpu's --fused_encoder
auto does on one accelerator. --bf16 trains --model AE in bf16 mixed
precision on one device, as pcc_tpu's --bf16 with its fused encoder does
(CodecConfig(compute_dtype="bfloat16"): the bf16 instances of the encoder
and its backward kernel, flax's bf16 rules in the decoder and the
probability model; parameters, Adam and the chamfer float32); the
checkpoints are the same float32 pickles. --model PPPF-AE --bf16 (one
device or --devices N) trains the float32 step, as pcc_tpu's does: its
PPPF-AE trainer builds its models with no dtype whatever --bf16 says
(pcc_tpu/train/steps_pppf.py:50-54), so the checkpoints are those of the
run without --bf16. Refused with a message: --model AE --devices N > 1
--bf16 (not ported yet); --fused_encoder and --jax_debug_nans are not
flags of this parser, which rejects them.

--devices N > 1 trains data-parallel on N processes, one per device
(cli/_common.py::maybe_launch, parallel/mesh.py): every rank draws the same
global batch and FPS starts and trains on its shard, the step being the
single-device step of the global batch; rank 0 prints and writes the
checkpoints. --batch_size must be divisible by N.
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob

import numpy as np
import torch

from pcc_tpu_torch.cli._common import add_devices_flag, maybe_launch, print0
from pcc_tpu_torch.config import DEFAULT_SEED, CodecConfig
from pcc_tpu_torch.io import read_point_clouds
from pcc_tpu_torch.parallel.mesh import (build_sharded_pppf_train_step,
                                         build_sharded_train_step, rank)
from pcc_tpu_torch.train import create_train_state, load_latest_checkpoint, save_checkpoint
from pcc_tpu_torch.train.state import make_optimizer


def build_parser():
    p = argparse.ArgumentParser(
        prog="train.py",
        description="Train autoencoder using point cloud patches",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--train_glob", default="./data/ModelNet40_pc_01_8192p/**/train/*.ply",
                   help="Point clouds glob pattern for training.")
    p.add_argument("--model_save_folder", default="./model/K256/",
                   help="Directory where to save trained models.")
    p.add_argument("--model", default="AE", help="Type of the model (AE or PPPF-AE).")
    p.add_argument("--N", type=int, default=8192, help="Point cloud resolution.")
    p.add_argument("--N0", type=int, default=1024, help="Scale Transformation constant.")
    p.add_argument("--ALPHA", type=int, default=2, help="The factor of patch coverage ratio.")
    p.add_argument("--K", type=int, default=256, help="Number of points in each patch.")
    p.add_argument("--d", type=int, default=16, help="Bottleneck size.")
    p.add_argument("--L", type=int, default=7, help="Quantization Level.")
    p.add_argument("--lr", type=float, default=0.0005, help="Learning rate.")
    p.add_argument("--batch_size", type=int, default=1, help="Batch size.")
    p.add_argument("--step_window", type=int, default=100,
                   help="Number of steps per window to iterate in epoch.")
    p.add_argument("--lamda", type=float, default=1e-06,
                   help="Lambda for rate-distortion tradeoff.")
    p.add_argument("--rate_loss_enable_step", type=int, default=40000,
                   help="Apply rate-distortion tradeoff at x steps.")
    p.add_argument("--lr_decay", type=float, default=0.1,
                   help="Decays the learning rate to x times the original.")
    p.add_argument("--lr_decay_steps", type=int, default=60000,
                   help="Decays the learning rate every x steps.")
    p.add_argument("--max_steps", type=int, default=80000,
                   help="Train up to this number of steps.")
    p.add_argument("--reset", action="store_true",
                   help="Reset training and start from scratch (ignore saved model).")
    p.add_argument("--rate_mode", default="reference", choices=["reference", "fixed"],
                   help="Rate-term normalization (see train/steps.py).")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision network compute, parameters and Adam "
                        "float32 (--model AE on one device; --model PPPF-AE computes its "
                        "float32 step, as pcc_tpu's does; --model AE with --devices N > 1 "
                        "in bf16 is not ported).")
    p.add_argument("--bn_warmup_steps", type=int, default=1000,
                   help="PPPF-AE only: steps trained with the encoder's BatchNorm on "
                        "batch statistics (running statistics updating) before the "
                        "fused step with them frozen (the PN++ stage kernels and "
                        "their backward). 0 = fused from the start.")
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    add_devices_flag(p)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on; 'cuda' raises when there is no card.")
    p.add_argument("--profile_dir", default=None,
                   help="Write a torch.profiler trace of the first logging "
                        "window of training steps here.")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.model not in ("AE", "PPPF-AE"):
        raise SystemExit(f"Unknown model type: {args.model}")
    if args.bf16 and args.devices > 1 and args.model == "AE":
        raise SystemExit("--model AE --devices N --bf16: multi-device bf16 training is not "
                         "ported yet (pcc_tpu runs it unfused, on flax's rounding, not the "
                         "kernels'); --bf16 trains on one device")
    if maybe_launch(args, main, argv, batch_size=args.batch_size):
        return
    cfg = CodecConfig(N=args.N, N0=args.N0, ALPHA=args.ALPHA, K=args.K, d=args.d, L=args.L,
                      model=args.model, compute_dtype="bfloat16" if args.bf16 else "float32")
    tx = make_optimizer(args.lr, args.lr_decay, args.lr_decay_steps, args.max_steps)
    state = create_train_state(args.seed, cfg, tx, device=args.device)
    device = state.optimizer.param_groups[0]["params"][0].device
    # the dtype the train state built: PPPF-AE's is float32 whatever --bf16 says
    bf16 = state.ae.bf16
    print0(f"Training {args.model} on {device}" + (" in bf16" if bf16 else ""))
    if args.bf16 and not bf16:
        print0(f"--bf16: the {args.model} step computes in float32, as pcc_tpu's does")
    print0(f"N={cfg.N}, K={cfg.K}, S={cfg.S}, d={cfg.d}, L={cfg.L}")

    os.makedirs(args.model_save_folder, exist_ok=True)
    files = sorted(glob(args.train_glob, recursive=True))
    if not files:
        raise SystemExit(f"no training files match {args.train_glob}")
    print0("loading point clouds...")
    points = read_point_clouds(files)
    print0(f"Loaded {points.shape} points, range: [{points.min()}, {points.max()}]")

    if args.model == "PPPF-AE":
        # the BatchNorm warm-up, then the fused step; chosen per step off the
        # Python counter, never off a device value
        warmup_step = build_sharded_pppf_train_step(cfg, tx, rate_mode=args.rate_mode)
        fused_step = build_sharded_pppf_train_step(cfg, tx, rate_mode=args.rate_mode, fused=True)
        fused_after = args.bn_warmup_steps
    else:
        warmup_step = fused_step = build_sharded_train_step(cfg, tx, rate_mode=args.rate_mode)
        fused_after = 0
    start_step = 0
    if not args.reset:
        state, start_step = load_latest_checkpoint(args.model_save_folder, state)
        print0(f"Resuming from step {start_step}")
    else:
        print0("Resetting training from scratch.")

    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed + 1)   # FPS start indices
    global_step = start_step
    prof = None
    if args.profile_dir and rank() == 0:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        prof = profile(activities=acts)
        prof.start()
    B = args.batch_size
    if args.devices > 1:
        print0(f"data-parallel training over {args.devices} devices "
               f"({B // args.devices} clouds/device/step)")
    window = {"loss": [], "fbpp": [], "bpp": []}
    t_window = time.time()

    for epoch in range(10**9):
        order = rng.permutation(len(points))
        for lo in range(0, len(order) - B + 1, B):
            if global_step >= args.max_steps:
                break
            # the global batch and its starts, the same on every rank (the
            # step takes this rank's shard of both)
            batch = torch.from_numpy(points[order[lo:lo + B]]).to(device)
            starts = torch.randint(0, points.shape[1], (B,), generator=gen,
                                   dtype=torch.int32).to(device)
            lam = args.lamda if global_step >= args.rate_loss_enable_step else 0.0
            step_fn = fused_step if global_step >= fused_after else warmup_step
            state, aux = step_fn(state, batch, starts, lam)
            global_step += 1

            # aux stays on the device; it is read once per window
            window["loss"].append(aux["loss"])
            window["fbpp"].append(aux["true_fbpp"])
            window["bpp"].append(aux["bpp"])
            if global_step % args.step_window == 0:
                window = {k: torch.stack(v).cpu().numpy() for k, v in window.items()}
                dt = time.time() - t_window
                print0(
                    f"[Epoch {epoch}] Step {global_step} | "
                    f"Feature bpp: {np.mean(window['fbpp']):.5f} | "
                    f"Bpp: {np.mean(window['bpp']):.5f} | "
                    f"Loss: {np.mean(window['loss']):.5f} | "
                    f"{args.step_window / dt:.2f} steps/s"
                )
                window = {"loss": [], "fbpp": [], "bpp": []}
                t_window = time.time()
                save_checkpoint(args.model_save_folder, state, global_step)
                if prof is not None:
                    prof.stop()
                    os.makedirs(args.profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
                    print0(f"profiler trace written to {args.profile_dir}")
                    prof = None
        if global_step >= args.max_steps:
            break

    save_checkpoint(args.model_save_folder, state, "")
    print0("Done.")


if __name__ == "__main__":
    main()
