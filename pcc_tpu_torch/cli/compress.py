"""Compress point clouds (reference compress.py CLI, PyTorch port).

Same positional arguments, flags and outputs ({name}.p.bin/.s.bin/.c.bin,
compress.py:139-152) as pcc_tpu's compress; the streams are byte-compatible.
--attributes also codes each cloud's RGB into {name}.a.bin (pcc_tpu's
extension, attrib.py), with attr.pkl / attr_prob.pkl from the model folder;
clouds without RGB are skipped. --devices N > 1 compresses on N processes,
one per device, each coding its shard of every batch (codec.py), and rank 0
writes the streams: the same bytes as one device. --batch_size is rounded
down to a multiple of N, as pcc_tpu rounds it. --attributes ignores
--devices, as pcc_tpu's does. --bf16 computes the networks in bf16 mixed
precision (pcc_tpu's flag; the bf16 kernel instances on the card): the
skeleton and .s.bin / .c.bin are the float32 run's bytes, the latents and
.p.bin are bf16's; decompress with --bf16 too. With --attributes the
geometry computes in bf16 and the colour nets in float32.

  python -m pcc_tpu_torch.cli.compress 'in/*.ply' comp/ model/ [--model PPPF-AE] [--device cpu]
  python -m pcc_tpu_torch.cli.compress 'in/*.ply' comp/ model/ --attributes [--d_a 16]
  python -m pcc_tpu_torch.cli.compress 'in/*.ply' comp/ model/ --bf16 [--model PPPF-AE]
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob

from pcc_tpu_torch.cli._common import (add_codec_flags, add_devices_flag, batch_size_from_args,
                                        config_from_args, load_attr_codec, load_codec,
                                        maybe_launch, print0)
from pcc_tpu_torch.io import read_point_cloud, read_point_cloud_attr
from pcc_tpu_torch.parallel.mesh import rank


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
    add_devices_flag(p)
    p.add_argument("--attributes", action="store_true",
                   help="Also compress RGB attributes into a {name}.a.bin stream "
                        "(extension; the reference codes geometry only).")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision network compute. Streams remain "
                        "decodable (decompress with --bf16 too: both sides "
                        "derive the CDF from the same compiled program).")
    return p


def write_streams(folder: str, name: str, blobs) -> None:
    for ext, blob in zip((".p.bin", ".s.bin", ".c.bin", ".a.bin"), blobs):
        with open(os.path.join(folder, name + ext), "wb") as fo:
            fo.write(blob)


def main(argv=None):
    args = build_parser().parse_args(argv)
    files = sorted(glob(args.input_glob, recursive=True))
    if not files:
        raise SystemExit(f"no input files match {args.input_glob}")
    os.makedirs(args.compressed_path, exist_ok=True)
    if args.attributes:
        return compress_with_attributes(args, files)
    if maybe_launch(args, main, argv):
        return
    if args.devices > 1:
        print0(f"data-parallel compression over {args.devices} devices")
    codec = load_codec(args.model_load_folder, config_from_args(args), args.seed,
                       batch_size=batch_size_from_args(args), device=args.device)
    print0(f"Processing on device: {codec.device}")

    clouds = [read_point_cloud(f) for f in files]
    start = time.time()
    streams = codec.compress_many(clouds)
    elapsed = time.time() - start
    if rank() == 0:
        for f, blobs in zip(files, streams):
            write_streams(args.compressed_path, os.path.split(f)[1], blobs)
    print0(f"Done! Execution time: {round(elapsed / len(files), 5)}s per point cloud.")


def compress_with_attributes(args, files) -> None:
    codec = load_attr_codec(args.model_load_folder, config_from_args(args), args.seed,
                            d_a=args.d_a, device=args.device)
    print(f"Processing on device: {codec.device}")
    start = time.time()
    clouds, rgbs, names = [], [], []
    for f in files:
        pc, rgb = read_point_cloud_attr(f)
        if rgb is None:
            print(f"skipping {f}: no RGB attributes")
            continue
        clouds.append(pc)
        rgbs.append(rgb)
        names.append(os.path.split(f)[1])
    for name, blobs in zip(names, codec.compress_many(clouds, rgbs)):
        write_streams(args.compressed_path, name, blobs)
    if names:
        print(f"Done! Execution time: {round((time.time() - start) / len(names), 5)}s "
              "per point cloud.")


if __name__ == "__main__":
    main()
