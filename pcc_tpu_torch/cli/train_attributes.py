"""Train the joint geometry + RGB attribute codec (PyTorch port of
pcc_tpu/cli/train_attributes.py; an extension, the reference codes geometry
only).

The IPDAE patch pipeline plus the per-patch colour autoencoder and the
skeleton-conditioned attribute probability model (attrib.py), trained
jointly on chamfer + colour MSE + lambda * rate, with Adam and the step
decay of train/state.py. Flags and defaults are pcc_tpu's, plus --device
cuda|cpu ('cuda' raises where there is no card); --color_weight is parsed
and ignored, as pcc_tpu does: the colour MSE's weight is 1. Writes ae.pkl, prob.pkl,
attr.pkl and attr_prob.pkl in pcc_tpu's layout, the set compress
--attributes loads. On the card each step runs the FPS kernel, the patch
encoder and its backward, and the chamfer kernels once each.

  python -m pcc_tpu_torch.cli.train_attributes --train_glob 'in/*.ply' \\
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

from pcc_tpu_torch.attrib import build_attr_train_step, create_attr_train_state
from pcc_tpu_torch.config import DEFAULT_SEED, CodecConfig
from pcc_tpu_torch.io import read_point_cloud_attr
from pcc_tpu_torch.train.state import make_optimizer
from pcc_tpu_torch.weights import attr_to_jax, to_jax_params


def build_parser():
    p = argparse.ArgumentParser(
        prog="train_attributes.py",
        description="Train the XYZ+RGB attribute codec on colored point clouds",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--train_glob", default="./data/colored/**/train/*.ply",
                   help="Colored point clouds glob pattern for training.")
    p.add_argument("--model_save_folder", default="./model/K256_attr/",
                   help="Directory where to save trained models.")
    p.add_argument("--N", type=int, default=8192)
    p.add_argument("--N0", type=int, default=1024)
    p.add_argument("--ALPHA", type=int, default=2)
    p.add_argument("--K", type=int, default=256)
    p.add_argument("--d", type=int, default=16, help="Geometry bottleneck size.")
    p.add_argument("--d_a", type=int, default=16, help="Attribute bottleneck size.")
    p.add_argument("--L", type=int, default=7)
    p.add_argument("--lr", type=float, default=0.0005)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--step_window", type=int, default=100)
    p.add_argument("--lamda", type=float, default=1e-4,
                   help="Rate weight (applied from --rate_loss_enable_step).")
    p.add_argument("--rate_loss_enable_step", type=int, default=2000)
    p.add_argument("--color_weight", type=float, default=1.0)
    p.add_argument("--lr_decay", type=float, default=0.1)
    p.add_argument("--lr_decay_steps", type=int, default=8000)
    p.add_argument("--max_steps", type=int, default=10000)
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on; 'cuda' raises when there is no card.")
    return p


def save_attr_models(folder: str, state) -> None:
    """ae.pkl, prob.pkl, attr.pkl and attr_prob.pkl in pcc_tpu's layout."""
    os.makedirs(folder, exist_ok=True)
    trees = (*to_jax_params(state.ae.state_dict(), state.prob.state_dict()),
             *attr_to_jax(state.attr.state_dict(), state.attr_prob.state_dict()))
    for name, tree in zip(("ae", "prob", "attr", "attr_prob"), trees):
        with open(os.path.join(folder, f"{name}.pkl"), "wb") as f:
            pickle.dump(tree, f)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = CodecConfig(N=args.N, N0=args.N0, ALPHA=args.ALPHA, K=args.K, d=args.d, L=args.L)
    tx = make_optimizer(args.lr, args.lr_decay, args.lr_decay_steps, args.max_steps)
    state = create_attr_train_state(args.seed, cfg, tx, args.d_a, device=args.device)
    device = state.optimizer.param_groups[0]["params"][0].device
    print(f"Training attribute codec on {device}; "
          f"N={cfg.N}, K={cfg.K}, S={cfg.S}, d={cfg.d}, d_a={args.d_a}")
    os.makedirs(args.model_save_folder, exist_ok=True)

    files = sorted(glob(args.train_glob, recursive=True))
    if not files:
        raise SystemExit(f"no training files match {args.train_glob}")
    pcs, rgbs = [], []
    for f in files:
        pc, rgb = read_point_cloud_attr(f)
        if rgb is None:
            print(f"skipping {f}: no RGB attributes")
            continue
        pcs.append(pc)
        rgbs.append(rgb.astype(np.float32) / 255.0)
    if not pcs:
        raise SystemExit("no colored clouds found")
    points, colors = np.stack(pcs), np.stack(rgbs)
    print(f"Loaded {points.shape} xyz + rgb")

    step_fn = build_attr_train_step(cfg, tx)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed + 2)   # FPS start indices
    B = args.batch_size
    global_step = 0
    window = {"loss": [], "color_mse": [], "bpp": []}
    t_window = time.time()

    while global_step < args.max_steps:
        order = rng.permutation(len(points))
        for lo in range(0, len(order) - B + 1, B):
            if global_step >= args.max_steps:
                break
            sel = order[lo:lo + B]
            lam = args.lamda if global_step >= args.rate_loss_enable_step else 0.0
            starts = torch.randint(0, points.shape[1], (B,), generator=gen,
                                   dtype=torch.int32).to(device)
            state, aux = step_fn(state, torch.from_numpy(points[sel]).to(device),
                                 torch.from_numpy(colors[sel]).to(device), starts, lam)
            global_step += 1
            for k in window:     # aux stays on the device; read once per window
                window[k].append(aux[k])
            if global_step % args.step_window == 0:
                vals = {k: torch.stack(v).cpu().numpy() for k, v in window.items()}
                dt = time.time() - t_window
                print(f"Step {global_step} | Loss: {np.mean(vals['loss']):.6f} | "
                      f"Color MSE: {np.mean(vals['color_mse']):.6f} | "
                      f"Bpp: {np.mean(vals['bpp']):.4f} | "
                      f"{args.step_window / dt:.2f} steps/s")
                window = {k: [] for k in window}
                t_window = time.time()

    save_attr_models(args.model_save_folder, state)
    print(f"Saved attribute codec checkpoints to {args.model_save_folder}")


if __name__ == "__main__":
    main()
