"""Decompress .p/.s/.c.bin streams to .ply (reference decompress.py CLI,
PyTorch port). Output files are named {name}.bin.ply, as pcc_tpu's.
--attributes also decodes {name}.a.bin into the PLY's RGB (pcc_tpu's
extension); a cloud without its .a.bin is skipped. --devices N > 1
decompresses on N processes, one per device, as compress does; rank 0
writes the clouds. --bf16 decodes in bf16 mixed precision, as the streams
were compressed.

  python -m pcc_tpu_torch.cli.decompress comp/ decomp/ model/ [--model PPPF-AE] [--device cpu]
  python -m pcc_tpu_torch.cli.decompress comp/ decomp/ model/ --attributes [--d_a 16]
  python -m pcc_tpu_torch.cli.decompress comp/ decomp/ model/ --bf16 [--model PPPF-AE]
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob

from pcc_tpu_torch.cli._common import (add_codec_flags, add_devices_flag, batch_size_from_args,
                                        config_from_args, load_attr_codec, load_codec,
                                        maybe_launch, print0)
from pcc_tpu_torch.io import save_point_cloud
from pcc_tpu_torch.parallel.mesh import rank


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
    add_devices_flag(p)
    p.add_argument("--attributes", action="store_true",
                   help="Decode {name}.a.bin RGB streams into colored .ply outputs "
                        "(extension; the reference codes geometry only).")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision network compute (must match the "
                        "compress-side setting so the CDF program is identical).")
    return p


def read_streams(folder: str, name: str, exts):
    """The streams of `name` with the extensions, or None if one is missing."""
    blobs = []
    for ext in exts:
        path = os.path.join(folder, name + ext)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as fi:
            blobs.append(fi.read())
    return tuple(blobs)


def main(argv=None):
    args = build_parser().parse_args(argv)
    files = sorted(glob(os.path.join(args.compressed_path, "*.s.bin")))
    if not files:
        raise SystemExit(f"no .s.bin files in {args.compressed_path}")
    os.makedirs(args.decompressed_path, exist_ok=True)
    if args.attributes:
        return decompress_with_attributes(args, files)
    if maybe_launch(args, main, argv):
        return
    if args.devices > 1:
        print0(f"data-parallel decompression over {args.devices} devices")
    codec = load_codec(args.model_load_folder, config_from_args(args), args.seed,
                       batch_size=batch_size_from_args(args), device=args.device)
    print0(f"Processing on device: {codec.device}")

    names = [os.path.split(f)[1][: -len(".s.bin")] for f in files]
    streams = [read_streams(args.compressed_path, name, (".p.bin", ".s.bin", ".c.bin"))
               for name in names]
    start = time.time()
    clouds = codec.decompress_many(streams)
    elapsed = time.time() - start
    if rank() == 0:
        for name, pc in zip(names, clouds):
            save_point_cloud(pc, name + ".bin.ply", path=args.decompressed_path)
    print0(f"Done! Execution time: {round(elapsed / len(files), 5)}s per point cloud.")


def decompress_with_attributes(args, files) -> None:
    codec = load_attr_codec(args.model_load_folder, config_from_args(args), args.seed,
                            d_a=args.d_a, device=args.device)
    print(f"Processing on device: {codec.device}")
    start = time.time()
    names, streams = [], []
    for f in files:
        name = os.path.split(f)[1][: -len(".s.bin")]
        blobs = read_streams(args.compressed_path, name, (".p.bin", ".s.bin", ".c.bin", ".a.bin"))
        if blobs is None:
            print(f"skipping {name}: missing attribute stream")
            continue
        names.append(name)
        streams.append(blobs)
    for name, (pc, rgb) in zip(names, codec.decompress_many(streams)):
        save_point_cloud(pc, name + ".bin.ply", path=args.decompressed_path, rgb=rgb)
    if names:
        print(f"Done! Execution time: {round((time.time() - start) / len(names), 5)}s "
              "per point cloud.")


if __name__ == "__main__":
    main()
