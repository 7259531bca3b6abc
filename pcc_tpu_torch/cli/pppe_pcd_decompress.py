"""PPPE fast decompression (reference pppe_pcd_decompress.py CLI, PyTorch
port of pcc_tpu/cli/pppe_pcd_decompress.py).

By default the reference source's transform, which pcc_tpu keeps for
parity: the loaded latent through the IPDAE sigmoid spread, its rounding
discarded, the unrounded value decoded (pppe_pcd_decompress.py:42-48).
--use_quantized feeds the decoder the model's own quantizer output,
round(clip(latent, 0, L-1)), what it saw in training. Entropy-coded
streams (pppe_pcd_compress --entropy_coding) are detected by their magic;
their symbols are already that quantizer's output and are decoded as they
are. Latents are decoded --batch_size at a time, grouped by transform and
width, the last batch padded by repetition.

  python -m pcc_tpu_torch.cli.pppe_pcd_decompress 'comp/**/*.bin' decomp/ model/ \\
      [--use_quantized] [--best] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import struct
from glob import glob

import numpy as np
import torch

from pcc_tpu_torch.cli.pppe_pcd_compress import (ENTROPY_MAGIC, add_pppe_flags,
                                                 load_pppe_model, rel_output_path)
from pcc_tpu_torch.config import PPPEConfig
from pcc_tpu_torch.io import save_point_cloud
from pcc_tpu_torch.models.pppe import PointCloudAE

def build_parser():
    p = argparse.ArgumentParser(
        description="Batch Point Cloud Decompression",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("input_glob", help="Compressed .bin files glob pattern.")
    p.add_argument("decompressed_path", help="Output folder for decompressed .ply files.")
    p.add_argument("model_load_folder", help="Directory where to load trained models.")
    add_pppe_flags(p)
    p.add_argument("--use_quantized", action="store_true",
                   help="Feed the model's own quantized latent (round(clamp(latent, "
                        "q_min, q_max)), the training-time path) to the decoder instead "
                        "of the reference's sigmoid-spread transform.")
    return p


def load_binary(in_path: str) -> np.ndarray:
    with open(in_path, "rb") as f:
        n = struct.unpack("<I", f.read(4))[0]
        arr = np.fromfile(f, dtype="<f4")
    return arr.astype(np.float32).reshape(1, n)


def load_binary_any(in_path: str):
    """(latent [1, d], is_quantized): an entropy-coded stream by its magic,
    else the reference's raw float32 contract."""
    from pcc_tpu_torch.coding.rangecoder import decode_float_cdf

    with open(in_path, "rb") as f:
        magic = struct.unpack("<I", f.read(4))[0]
        if magic != ENTROPY_MAGIC:
            return load_binary(in_path), False
        d, L, _ = struct.unpack("<HBB", f.read(4))
        counts = np.fromfile(f, dtype="<u4", count=L).astype(np.uint64)
        nbytes = struct.unpack("<I", f.read(4))[0]
        payload = f.read(nbytes)
    pmf = counts / counts.sum()
    cdf = np.concatenate([[0.0], np.cumsum(pmf)])
    sym = decode_float_cdf(np.tile(cdf, (d, 1)), payload)
    return sym.astype(np.float32)[None, :], True


def latent_to_code(latents: torch.Tensor, mode: str, L: int) -> torch.Tensor:
    """The decoder's input for loaded latents [B, d] under `mode`:
    "quantized" as they are (decoded entropy symbols), "round"
    round(clip(latent, 0, L - 1)), "sigmoid" the reference's spread."""
    if mode == "quantized":
        return latents
    if mode == "round":
        return torch.round(torch.clamp(latents, 0.0, L - 1.0))
    spread = L - 0.2
    return torch.sigmoid(latents) * spread - spread / 2


def decode_latents(model: PointCloudAE, latents: np.ndarray, mode: str, L: int) -> torch.Tensor:
    """Loaded latents [B, d] -> decoded clouds [B, N, 3] on the model's
    device."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        z = latent_to_code(torch.from_numpy(np.asarray(latents, np.float32)).to(dev), mode, L)
        return model.decoder(z)[1]


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = PPPEConfig(N=args.N, latent_dim=args.K, L=args.L)
    model = load_pppe_model(args, cfg)
    files = sorted(glob(args.input_glob, recursive=True))
    print(f"Found {len(files)} compressed files.")
    B = max(1, args.batch_size)

    def dispatch(mode, items):
        lats = [raw[0] for _, raw in items]
        lats += [lats[-1]] * (B - len(lats))       # pad the tail batch
        fine = decode_latents(model, np.stack(lats), mode, args.L).cpu().numpy()
        for i, (f, _) in enumerate(items):
            out = rel_output_path(f, args.input_glob, args.decompressed_path, "")
            out_dir, name = os.path.split(out)
            base = name[:-len(".bin")] if name.endswith(".bin") else name
            save_point_cloud(fine[i], base + ".bin.ply", path=out_dir or ".")

    # bucketed by (transform, latent width), so that each batch is uniform
    buckets = {}
    for f in files:
        raw, is_quantized = load_binary_any(f)
        mode = "quantized" if is_quantized else "round" if args.use_quantized else "sigmoid"
        key = (mode, raw.shape[-1])
        buckets.setdefault(key, []).append((f, raw))
        if len(buckets[key]) == B:
            dispatch(mode, buckets.pop(key))
    for (mode, _), items in buckets.items():
        dispatch(mode, items)


if __name__ == "__main__":
    main()
