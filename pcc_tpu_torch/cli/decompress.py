"""Decompress .p/.s/.c.bin streams to .ply (reference decompress.py CLI,
PyTorch port). Output files are named {name}.bin.ply, as pcc_tpu's.

  python -m pcc_tpu_torch.cli.decompress comp/ decomp/ model/ [--model PPPF-AE] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob

from pcc_tpu_torch.cli._common import (add_codec_flags, batch_size_from_args,
                                        config_from_args, load_codec)
from pcc_tpu_torch.io import save_point_cloud


def build_parser():
    p = argparse.ArgumentParser(
        prog="decompress.py",
        description="Decompress Point Clouds Using Trained Model.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("compressed_path", help="Compressed .bin files folder.")
    p.add_argument("decompressed_path", help="Decompressed .ply files folder.")
    p.add_argument("model_load_folder", help="Directory where to load trained models.")
    add_codec_flags(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    files = sorted(glob(os.path.join(args.compressed_path, "*.s.bin")))
    if not files:
        raise SystemExit(f"no .s.bin files in {args.compressed_path}")
    os.makedirs(args.decompressed_path, exist_ok=True)
    codec = load_codec(args.model_load_folder, config_from_args(args), args.seed,
                       batch_size=batch_size_from_args(args), device=args.device)
    print(f"Processing on device: {codec.device}")

    names, streams = [], []
    for f in files:
        name = os.path.split(f)[1][: -len(".s.bin")]
        names.append(name)
        blobs = []
        for ext in (".p.bin", ".s.bin", ".c.bin"):
            with open(os.path.join(args.compressed_path, name + ext), "rb") as fi:
                blobs.append(fi.read())
        streams.append(tuple(blobs))
    start = time.time()
    clouds = codec.decompress_many(streams)
    elapsed = time.time() - start
    for name, pc in zip(names, clouds):
        save_point_cloud(pc, name + ".bin.ply", path=args.decompressed_path)
    print(f"Done! Execution time: {round(elapsed / len(files), 5)}s per point cloud.")


if __name__ == "__main__":
    main()
