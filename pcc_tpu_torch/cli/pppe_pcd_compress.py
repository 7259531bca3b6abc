"""PPPE fast compression (reference pppe_pcd_compress.py CLI, PyTorch port
of pcc_tpu/cli/pppe_pcd_compress.py).

The same on-disk contract by default: per cloud a `.bin` holding a uint32
count, then the raw float32 latent (pppe_pcd_compress.py:36-41, 55-66), in
an output tree that mirrors the input's (pppe_pcd_compress.py:90-93).
--entropy_coding writes pcc_tpu's self-contained coded stream instead: the
latent quantized by the model's quantize_st forward, round(clip(latent, 0,
L-1)), its histogram in the header, the symbols range-coded under that
histogram's PMF (coding/rangecoder.py). Clouds are normalized and encoded
--batch_size at a time, the last batch padded by repetition; each file's
latent is its cloud's alone. The model folder holds pcc_tpu's
ae_{latest,best}.pkl; without one the weights are random from --seed.

  python -m pcc_tpu_torch.cli.pppe_pcd_compress 'in/**/*.ply' comp/ model/ \\
      [--entropy_coding] [--best] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import struct
from glob import glob

import numpy as np
import torch

from pcc_tpu_torch.config import DEFAULT_SEED, PPPEConfig
from pcc_tpu_torch.device import resolve_device
from pcc_tpu_torch.io import read_point_cloud
from pcc_tpu_torch.models.pppe import PointCloudAE, make_pppe_model
from pcc_tpu_torch.ops.normalize import normalize

# magic of the entropy-coded stream; cannot collide with the raw contract,
# whose first 4 bytes are the latent count (a small uint32)
ENTROPY_MAGIC = 0x45505045  # "EPPE"


def add_pppe_flags(p) -> None:
    """Flags shared by the PPPE compress and decompress CLIs."""
    p.add_argument("--N", type=int, default=8192, help="Number of points for the model.")
    p.add_argument("--K", type=int, default=256, help="Latent space dimension.")
    p.add_argument("--L", type=int, default=7, help="Quantization level.")
    p.add_argument("--best", action="store_true")
    p.add_argument("--seed", type=int, default=DEFAULT_SEED,
                   help="Seed of the random weights used when the model folder is empty.")
    p.add_argument("--batch_size", type=int, default=32,
                   help="Clouds per device batch (pcc_tpu's extension; the reference "
                        "goes one at a time). Outputs are the same per file.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on; 'cuda' raises when there is no card.")


def build_parser():
    p = argparse.ArgumentParser(
        description="Batch Point Cloud Compression",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("input_glob", help="Point clouds glob pattern for compression.")
    p.add_argument("compressed_path", help="Compressed .bin files folder.")
    p.add_argument("model_load_folder", help="Directory where to load trained models.")
    add_pppe_flags(p)
    p.add_argument("--entropy_coding", action="store_true",
                   help="Write quantized, range-coded latents (histogram PMF in the "
                        "header) instead of the reference's raw float32 contract.")
    return p


def save_binary(latent: np.ndarray, out_path: str) -> None:
    """uint32 count header + float32 payload (pppe_pcd_compress.py:36-41)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    arr = np.asarray(latent, dtype="<f4")
    with open(out_path, "wb") as f:
        f.write(struct.pack("<I", arr.shape[0]))
        arr.tofile(f)


def save_binary_entropy(latent: np.ndarray, L: int, out_path: str) -> None:
    """Quantize with the model's own quantize_st forward and range-code.

    Layout: uint32 magic | uint16 d | uint8 L | uint8 pad | uint32 counts[L]
    | uint32 nbytes | payload. The decoder rebuilds the same histogram PMF
    from the integer counts, so the stream is self-contained."""
    from pcc_tpu_torch.coding.rangecoder import encode_float_cdf

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    lat = np.asarray(latent, dtype=np.float32).reshape(-1)
    if lat.shape[0] >= 1 << 16:
        raise ValueError(
            f"entropy stream header caps latent length at 65535 "
            f"(got {lat.shape[0]}); use the raw float format for larger d")
    if L >= 256:
        raise ValueError(f"entropy stream header caps L at 255 (got {L})")
    sym = np.clip(np.round(lat), 0, L - 1).astype(np.int16)
    counts = np.bincount(sym, minlength=L).astype("<u4")
    pmf = counts / counts.sum()
    cdf = np.concatenate([[0.0], np.cumsum(pmf)])          # [L + 1]
    payload = encode_float_cdf(np.tile(cdf, (sym.shape[0], 1)), sym)
    with open(out_path, "wb") as f:
        f.write(struct.pack("<IHBB", ENTROPY_MAGIC, lat.shape[0], L, 0))
        counts.tofile(f)
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def rel_output_path(ply_path: str, input_glob: str, out_root: str, ext: str) -> str:
    """Mirror the input directory tree under the output root
    (pppe_pcd_compress.py:90-93)."""
    base = input_glob.split("**")[0].split("*")[0]
    base = os.path.dirname(base) if not os.path.isdir(base) else base
    rel = os.path.relpath(ply_path, start=base or ".")
    return os.path.join(out_root, rel).replace(".ply", ext)


def load_pppe_model(args, cfg: PPPEConfig) -> PointCloudAE:
    """The PPPE model of the folder's ae_{latest,best}.pkl on args.device,
    or seeded random weights when it holds none."""
    from pcc_tpu_torch.train.checkpoint import load_pppe_checkpoint

    dev = resolve_device(args.device)
    model = make_pppe_model(cfg, seed=args.seed)
    if not load_pppe_checkpoint(args.model_load_folder, model, best=args.best):
        print(f"WARNING: no ae_{'best' if args.best else 'latest'}.pkl in "
              f"{args.model_load_folder}; using randomly initialized weights.")
    return model.to(dev)


def encode_clouds(model: PointCloudAE, clouds: np.ndarray, cfg: PPPEConfig) -> torch.Tensor:
    """[B, N, 3] clouds -> latents [B, latent_dim], each cloud normalized
    on its own (pcc_tpu's vmapped normalize) on the model's device."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        pc01 = normalize(torch.from_numpy(np.asarray(clouds, np.float32)).to(dev),
                         margin=cfg.margin)[0]
        return model.encoder(pc01)[0]


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = PPPEConfig(N=args.N, latent_dim=args.K, L=args.L)
    model = load_pppe_model(args, cfg)
    files = sorted(glob(args.input_glob, recursive=True))
    print(f"Found {len(files)} point clouds.")
    B = max(1, args.batch_size)
    for lo in range(0, len(files), B):
        chunk = files[lo:lo + B]
        pcs = [read_point_cloud(f) for f in chunk]
        pcs += [pcs[-1]] * (B - len(pcs))          # pad the tail batch
        lat = encode_clouds(model, np.stack(pcs), cfg).cpu().numpy()
        for i, f in enumerate(chunk):
            out = rel_output_path(f, args.input_glob, args.compressed_path, ".bin")
            if args.entropy_coding:
                save_binary_entropy(lat[i], args.L, out)
            else:
                save_binary(lat[i], out)


if __name__ == "__main__":
    main()
