"""Evaluate PPPE compression (reference eval_pppe.py CLI, PyTorch port of
pcc_tpu/cli/eval_pppe.py).

pcc_tpu's CSV schema (eval_pppe:92-100): the patch pipeline's columns
without the uniformity coefficient; bpp from the single `.bin` file
(eval_pppe:80); compressed and decompressed files found by recursive
filename match (eval_pppe:63-68). Written in pandas' CSV format
(io/table.py); the metrics run on the card unless --device cpu.

  python -m pcc_tpu_torch.cli.eval_pppe --input_glob 'in/**/*.ply' --compressed_path comp/ \\
      --decompressed_path decomp/ --output_file eval.csv [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from glob import glob

from pcc_tpu_torch.cli.eval import GEOMETRY_AVERAGES, averages, batched_metrics
from pcc_tpu_torch.io import read_point_cloud
from pcc_tpu_torch.io.table import write_csv
from pcc_tpu_torch.metrics import compute_bitrate


def build_parser():
    p = argparse.ArgumentParser(
        description="Evaluate new compressed/decompressed point cloud data")
    p.add_argument("--input_glob", default="./data/ModelNet40_pc_01_8192p/**/test/*.ply",
                   help="Original point clouds glob pattern.")
    p.add_argument("--compressed_path", default="./data/ModelNet40_K256_compressed_p1/",
                   help="Compressed .bin files folder.")
    p.add_argument("--decompressed_path", default="./data/ModelNet40_K256_decompressed_p1/",
                   help="Decompressed .ply files folder.")
    p.add_argument("--output_file", default="./eval/ModelNet40_pppe.csv",
                   help="Evaluation Detail saved as csv.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on; 'cuda' raises when there is no card.")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    files = sorted(glob(args.input_glob, recursive=True))
    rows = {k: [] for k in (
        "filename", "p2pointPSNR", "p2planePSNR", "chamfer_distance",
        "n_points_input", "n_points_output", "bpp")}

    print("Evaluating...")
    pending = []
    for f in files:
        name = os.path.split(f)[1]
        comp = glob(os.path.join(args.compressed_path, "**", name.replace(".ply", ".bin")),
                    recursive=True)
        decomp = glob(os.path.join(args.decompressed_path, "**",
                                   name.replace(".ply", ".bin.ply")), recursive=True)
        if not comp or not decomp:
            continue
        pending.append({"name": name, "in": read_point_cloud(f),
                        "out": read_point_cloud(decomp[0]), "bytes": os.path.getsize(comp[0])})
    batched_metrics(pending, args.device)

    for item in pending:
        m = item["metrics"]
        rows["filename"].append(item["name"])
        rows["p2pointPSNR"].append(round(m["p2point_psnr"], 3))
        rows["p2planePSNR"].append(round(m["p2plane_psnr"], 3))
        rows["chamfer_distance"].append(m["chamfer"])
        rows["n_points_input"].append(item["in"].shape[0])
        rows["n_points_output"].append(item["out"].shape[0])
        rows["bpp"].append(compute_bitrate(item["bytes"], item["in"].shape[0]))

    if rows["filename"]:
        print(f"Done! {averages(rows, GEOMETRY_AVERAGES)}")
    else:
        print("Done! No input/decompressed file pairs matched — nothing to average.")
    os.makedirs(os.path.dirname(args.output_file) or ".", exist_ok=True)
    write_csv(args.output_file, rows)
    print(f"Evaluation results saved to {args.output_file}")


if __name__ == "__main__":
    main()
