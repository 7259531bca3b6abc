"""Compress point clouds (reference compress.py CLI, PyTorch port).

Same positional arguments, flags and outputs ({name}.p.bin/.s.bin/.c.bin,
compress.py:139-152) as pcc_tpu's compress; the streams are byte-compatible.

  python -m pcc_tpu_torch.cli.compress 'in/*.ply' comp/ model/ [--model PPPF-AE] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob

from pcc_tpu_torch.cli._common import (add_codec_flags, batch_size_from_args,
                                        config_from_args, load_codec)
from pcc_tpu_torch.io import read_point_cloud


def build_parser():
    p = argparse.ArgumentParser(
        prog="compress.py",
        description="Compress Point Clouds Using Trained Model.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("input_glob", help="Point clouds glob pattern for compression.")
    p.add_argument("compressed_path", help="Compressed .bin files folder.")
    p.add_argument("model_load_folder", help="Directory where to load trained models.")
    add_codec_flags(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    files = sorted(glob(args.input_glob, recursive=True))
    if not files:
        raise SystemExit(f"no input files match {args.input_glob}")
    os.makedirs(args.compressed_path, exist_ok=True)
    codec = load_codec(args.model_load_folder, config_from_args(args), args.seed,
                       batch_size=batch_size_from_args(args), device=args.device)
    print(f"Processing on device: {codec.device}")

    clouds = [read_point_cloud(f) for f in files]
    start = time.time()
    streams = codec.compress_many(clouds)
    elapsed = time.time() - start
    for f, blobs in zip(files, streams):
        name = os.path.split(f)[1]
        for ext, blob in zip((".p.bin", ".s.bin", ".c.bin"), blobs):
            with open(os.path.join(args.compressed_path, name + ext), "wb") as fo:
                fo.write(blob)
    print(f"Done! Execution time: {round(elapsed / len(files), 5)}s per point cloud.")


if __name__ == "__main__":
    main()
