"""Train the PPPE whole-cloud AE (reference train_pppe_pcd_ae.py CLI, PyTorch
port of pcc_tpu/cli/train_pppe_pcd_ae.py).

Flags and defaults are pcc_tpu's (train_pppe:25-38), plus --device
cuda|cpu ('cuda' raises where there is no card). Replicated: lambda warm-up
over --warmup_steps, the gradient clip at 1.0, the per-epoch cosine
learning rate (T_max 100), the skip of a step whose loss is not finite
(on the device, train/steps_pppe.py; the skips are read once per window
and reported), best and latest checkpoints by windowed mean loss
(train/checkpoint.py::save_pppe_checkpoint, pcc_tpu's layout), the
train.npy cache, and dataset_norm.pkl, whose statistics are computed and
saved but NOT applied, as the reference and pcc_tpu leave them: training
sees raw clouds, while the PPPE compress CLI normalizes each cloud, so
training data should already lie in about [0, 1]. On the card the step
runs the FPS kernel 3 times and the chamfer kernels once each.
--lr_decay and --lr_decay_steps are parsed and unused, as in pcc_tpu.
--bf16 trains in bf16 mixed precision (PPPEConfig(compute_dtype=
"bfloat16"), pcc_tpu's: flax's bf16 rules in every module but the
probability model; parameters, Adam, the clip and the chamfer float32),
also with --devices N; the checkpoints are float32 and serve in float32
(pppe_pcd_compress / pppe_pcd_decompress / eval_pppe, as pcc_tpu's do).
--devices N > 1 trains data-parallel on N processes, one per device, as
cli/train.py does (the step is the single-device step of the global batch,
train/steps_pppe.py); rank 0 prints and writes dataset_norm.pkl and the
checkpoints.

  python -m pcc_tpu_torch.cli.train_pppe_pcd_ae --train_glob 'in/*.ply' \\
      --model_save_folder model/ [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from glob import glob

import numpy as np
import torch

from pcc_tpu_torch.cli._common import add_devices_flag, maybe_launch, print0
from pcc_tpu_torch.config import DEFAULT_SEED, PPPEConfig
from pcc_tpu_torch.io import read_point_clouds
from pcc_tpu_torch.parallel.mesh import build_sharded_pppe_train_step, rank
from pcc_tpu_torch.train.checkpoint import resume_pppe_checkpoint, save_pppe_checkpoint
from pcc_tpu_torch.train.steps_pppe import (cosine_epoch_lr, create_pppe_state,
                                            make_pppe_optimizer, set_lr)


def build_parser():
    p = argparse.ArgumentParser(
        prog="train_pppe_pcd_ae.py",
        description="Train autoencoder (PointNet++ + PCN) with conditional prob model",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--train_glob", default="./data/ModelNet40_pc_01_8192p/**/train/*.ply")
    p.add_argument("--model_save_folder", default="./model/P1/")
    p.add_argument("--N", type=int, default=8192, help="Point cloud resolution.")
    p.add_argument("--K", type=int, default=256, help="Latent space dimension.")
    p.add_argument("--L", type=int, default=7, help="Quantization level.")
    p.add_argument("--lr", type=float, default=0.0005, help="Learning rate.")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_steps", type=int, default=80000)
    p.add_argument("--step_window", type=int, default=100)
    p.add_argument("--lr_decay", type=float, default=0.95)
    p.add_argument("--lr_decay_steps", type=int, default=60000)
    p.add_argument("--warmup_steps", type=int, default=5000,
                   help="Number of steps to gradually ramp up lambda in RD loss")
    p.add_argument("--reset", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision compute; parameters, Adam and the "
                        "checkpoints float32.")
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    add_devices_flag(p)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on; 'cuda' raises when there is no card.")
    return p


def load_training_points(train_glob: str) -> np.ndarray:
    """The train.npy cache next to the data root (train_pppe:260-267), else
    the PLY files of the glob."""
    npy_path = os.path.join(os.path.dirname(train_glob.split("*")[0]), "train.npy")
    if os.path.exists(npy_path):
        print(f"Loading cached point clouds from {npy_path}")
        return np.load(npy_path)
    files = sorted(glob(train_glob, recursive=True))
    if not files:
        raise SystemExit(f"no training files match {train_glob}")
    points = read_point_clouds(files)
    print(f"Loaded {points.shape} points")
    return points


def compute_dataset_norm(points: np.ndarray):
    """Dataset mean and largest radius about it (train_pppe:147-160)."""
    flat = points.reshape(-1, 3)
    center = flat.mean(axis=0)
    longest = np.linalg.norm(flat - center, axis=1).max()
    return center, longest


def main(argv=None):
    args = build_parser().parse_args(argv)
    if maybe_launch(args, main, argv, batch_size=args.batch_size):
        return
    cfg = PPPEConfig(N=args.N, latent_dim=args.K, L=args.L,
                     compute_dtype="bfloat16" if args.bf16 else "float32")
    tx = make_pppe_optimizer(args.lr)
    state = create_pppe_state(args.seed, cfg, tx, device=args.device)
    device = state.params.device
    print0(f"Training PointNet++ + PCN + ProbModel on {device}" + (" in bf16" if args.bf16
                                                                     else ""))
    os.makedirs(args.model_save_folder, exist_ok=True)
    points = load_training_points(args.train_glob)
    train_step = build_sharded_pppe_train_step(tx)

    center, longest = compute_dataset_norm(points)
    if rank() == 0:
        with open(os.path.join(args.model_save_folder, "dataset_norm.pkl"), "wb") as f:
            pickle.dump({"center": center, "longest": longest}, f)

    start_step = 0
    if not args.reset:
        state, start_step = resume_pppe_checkpoint(args.model_save_folder, state)
        print0(f"Resuming from step {start_step}")
    else:
        print0("Starting training from scratch.")

    rng = np.random.default_rng(args.seed)
    B = args.batch_size
    if args.devices > 1:
        print0(f"data-parallel training over {args.devices} devices")
    global_step = start_step
    best_loss = float("inf")
    window = {"loss": [], "dist": [], "rate": [], "skipped": []}
    t_window = time.time()

    for epoch in range(10**9):
        state = set_lr(state, cosine_epoch_lr(args.lr, epoch))
        order = rng.permutation(len(points))
        for lo in range(0, len(order) - B + 1, B):
            if global_step >= args.max_steps:
                break
            # the global batch, the same on every rank (the step takes this
            # rank's shard)
            batch = torch.from_numpy(np.ascontiguousarray(points[order[lo:lo + B]],
                                                          np.float32)).to(device)
            lam_eff = 1.0 * min(1.0, global_step / max(1, args.warmup_steps))
            state, aux = train_step(state, batch, lam_eff)
            # the skip is decided on the device; aux is read once per window
            global_step += 1
            for k in window:
                window[k].append(aux[k])

            if global_step % args.step_window == 0:
                vals = {k: torch.stack(v).cpu().numpy() for k, v in window.items()}
                n_skip = int(vals.pop("skipped").sum())
                if n_skip:
                    print0(f"[Warning] {n_skip} loss anomalies in window")
                avg = {k: float(np.mean(v)) for k, v in vals.items()}
                if avg["loss"] < best_loss:
                    best_loss = avg["loss"]
                    save_pppe_checkpoint(args.model_save_folder, state, global_step, best=True)
                dt = time.time() - t_window
                print0(f"[Epoch {epoch}] Step {global_step} | "
                       f"Loss: {avg['loss']:.5f} | Dist: {avg['dist']:.5f} | "
                       f"Rate: {avg['rate']:.5f} | "
                       f"{args.step_window / dt:.2f} steps/s")
                window = {k: [] for k in window}
                t_window = time.time()
                save_pppe_checkpoint(args.model_save_folder, state, global_step)
        if global_step >= args.max_steps:
            break

    save_pppe_checkpoint(args.model_save_folder, state, global_step)
    print0("Done.")


if __name__ == "__main__":
    main()
