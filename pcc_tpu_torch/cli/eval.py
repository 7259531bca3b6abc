"""Evaluate original vs decompressed clouds (reference eval.py CLI, PyTorch
port of pcc_tpu/cli/eval.py).

The same flags, printed lines and CSV as pcc_tpu's (eval.py:212-221):
columns [filename, p2pointPSNR, p2planePSNR, chamfer_distance,
n_points_input, n_points_output, bpp, uniformity coefficient], plus
color_psnr and attr_bpp when {name}.a.bin attribute streams exist, written
in pandas' CSV format (io/table.py). The metrics run on the card
(metrics.py) unless --device cpu.

  python -m pcc_tpu_torch.cli.eval --input_glob 'in/*.ply' --compressed_path comp/ \\
      --decompressed_path decomp/ --output_file eval.csv [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

from pcc_tpu_torch.io import read_point_cloud, read_point_cloud_attr, read_point_cloud_normals
from pcc_tpu_torch.io.table import write_csv
from pcc_tpu_torch.metrics import (calc_uc, compute_bitrate, compute_color_psnr,
                                   compute_p2point_p2plane_psnr, eval_batch, normalized_chamfer)


def build_parser():
    p = argparse.ArgumentParser(
        prog="eval.py",
        description="Evaluate point cloud patches",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--input_glob", default="./data/ModelNet40_pc_01_8192p/**/test/*.ply",
                   help="Point clouds glob pattern for compression.")
    p.add_argument("--compressed_path", default="./data/ModelNet40_K256_compressed/",
                   help="Compressed .bin files folder.")
    p.add_argument("--decompressed_path", default="./data/ModelNet40_K256_decompressed/",
                   help="Decompressed .ply files folder.")
    p.add_argument("--output_file", default="./eval/ModelNet40_K256.csv",
                   help="Evaluation Detail saved as csv.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on; 'cuda' raises when there is no card.")
    return p


def batched_metrics(pending: list, device: str) -> None:
    """metrics.eval_batch per (N, M) shape group of the pairs in `pending`
    that carry no file normals; each result goes into its item's
    "metrics"."""
    by_shape: dict[tuple, list[int]] = {}
    for i, item in enumerate(pending):
        if item.get("normals") is None:
            by_shape.setdefault((item["in"].shape[0], item["out"].shape[0]), []).append(i)
    for idxs in by_shape.values():
        origs = np.stack([pending[i]["in"] for i in idxs])
        recons = np.stack([pending[i]["out"] for i in idxs])
        for i, m in zip(idxs, eval_batch(origs, recons, device=device)):
            pending[i]["metrics"] = m


def averages(rows: dict, columns) -> str:
    """pcc_tpu's averages line: ' | '-joined (label, column, digits), the
    attribute columns' means over the clouds that have them."""
    return " | ".join(
        f"{label}: {round(float((np.nanmean if col in ATTR_COLUMNS else np.mean)(rows[col])), nd)}"
        for label, col, nd in columns)


ATTR_COLUMNS = ("color_psnr", "attr_bpp")
GEOMETRY_AVERAGES = (("The average p2pointPSNR", "p2pointPSNR", 3),
                     ("p2plane PSNR", "p2planePSNR", 3),
                     ("chamfer distance", "chamfer_distance", 8), ("bpp", "bpp", 3))


def main(argv=None):
    args = build_parser().parse_args(argv)
    files = sorted(glob(args.input_glob, recursive=True))
    filenames = [os.path.split(x)[1] for x in files]

    rows = {k: [] for k in (
        "filename", "p2pointPSNR", "p2planePSNR", "chamfer_distance",
        "n_points_input", "n_points_output", "bpp", "uniformity coefficient")}
    # extension columns, added only when {name}.a.bin attribute streams
    # exist, so that geometry-only CSVs keep the reference schema
    attr_rows = {k: [] for k in ATTR_COLUMNS}

    print("Evaluating...")
    pending = []
    for f, name in zip(files, filenames):
        comp = [os.path.join(args.compressed_path, name + ext)
                for ext in (".s.bin", ".p.bin", ".c.bin")]
        comp_a = os.path.join(args.compressed_path, name + ".a.bin")
        decomp = os.path.join(args.decompressed_path, name + ".bin.ply")
        if not os.path.exists(decomp):
            continue
        input_pc, input_normals = read_point_cloud_normals(f)
        pending.append({
            "f": f, "name": name, "in": input_pc, "out": read_point_cloud(decomp),
            "normals": input_normals, "bytes": sum(os.path.getsize(p) for p in comp),
            "a": comp_a if os.path.exists(comp_a) else None,
        })
    # batched per shape group; files carrying their own normals go one by
    # one (the reference's eval.py:59-60 uses file normals)
    batched_metrics(pending, args.device)

    for item in pending:
        input_pc, decomp_pc = item["in"], item["out"]
        n_in, n_out = input_pc.shape[0], decomp_pc.shape[0]
        if "metrics" in item:
            m = item["metrics"]
            d1, d2, uc, ch = m["p2point_psnr"], m["p2plane_psnr"], m["uc"], m["chamfer"]
        else:
            psnr = compute_p2point_p2plane_psnr(input_pc, decomp_pc, normals=item["normals"],
                                                device=args.device)
            d1, d2 = psnr["p2point_psnr"], psnr["p2plane_psnr"]
            uc = calc_uc(input_pc, decomp_pc, device=args.device)
            ch = normalized_chamfer(input_pc, decomp_pc, device=args.device)

        rows["filename"].append(item["name"])
        rows["p2pointPSNR"].append(round(d1, 3))
        rows["p2planePSNR"].append(round(d2, 3))
        rows["chamfer_distance"].append(ch)
        rows["n_points_input"].append(n_in)
        rows["n_points_output"].append(n_out)
        rows["bpp"].append(compute_bitrate(item["bytes"], n_in))
        rows["uniformity coefficient"].append(round(uc, 3))

        color, attr_bpp = float("nan"), float("nan")
        if item["a"] is not None:
            in_pc_a, in_rgb = read_point_cloud_attr(item["f"])
            out_pc_a, out_rgb = read_point_cloud_attr(
                os.path.join(args.decompressed_path, item["name"] + ".bin.ply"))
            if in_rgb is not None and out_rgb is not None:
                color = round(compute_color_psnr(in_pc_a, in_rgb, out_pc_a, out_rgb,
                                                 device=args.device), 3)
            attr_bpp = compute_bitrate(os.path.getsize(item["a"]), n_in)
        attr_rows["color_psnr"].append(color)
        attr_rows["attr_bpp"].append(attr_bpp)

    if not np.all(np.isnan(attr_rows["attr_bpp"])):
        rows.update(attr_rows)

    if rows["filename"]:
        cols = GEOMETRY_AVERAGES + (("uc", "uniformity coefficient", 3),)
        if "color_psnr" in rows:
            cols += (("color PSNR", "color_psnr", 3), ("attr bpp", "attr_bpp", 3))
        print(f"Done! {averages(rows, cols)}")
    else:
        print("Done! No input/decompressed file pairs matched — nothing to average.")

    os.makedirs(os.path.dirname(args.output_file) or ".", exist_ok=True)
    write_csv(args.output_file, rows)
    print(f"Evaluation results saved to {args.output_file}")


if __name__ == "__main__":
    main()
