"""The golden run of eval/GOLDEN.md's "reference recipe (parity)" column,
through the port's own CLIs, on an NVIDIA GPU.

  python3 -m pcc_tpu_torch.tools.golden_run [--work DIR] [--out DIR] [--max_steps N]

1. Writes eval/GOLDEN.md's seeded surfaces (its generator, copied here:
   numpy rng 42, 256 train then 32 test clouds of 8192 points) with the
   port's PLY writer.
2. Trains IPDAE with the reference recipe through
   `python -m pcc_tpu_torch.cli.train --rate_mode reference --batch_size 1
   --step_window 2000`, every schedule flag at its default (80 k steps, lr
   5e-4 decayed x0.1 at 60 k, lambda 1e-6 from 40 k), in one run of the
   train CLI. With --segment S it runs in segments of S steps instead:
   each one run of the train CLI with --max_steps at the segment's end,
   resuming the latest checkpoint as the CLI does (models, Adam state and
   step; the reference's resume counts the saved step + 1, so each resume
   skips one step number, and the data order and FPS starts restart from
   --seed); a segment starts only while its time, at the last segment's
   rate, fits in --budget_s. A run stopped there, or cut, goes on from
   where it stopped when started again on the same --work. While it
   trains, all but the two newest step-suffixed checkpoints are deleted
   (each is about 210 MB).
3. Compresses and decompresses the 32 test clouds and evaluates them with
   the port's cli/compress.py, cli/decompress.py and cli/eval.py.
4. Prints D1, D2, chamfer, bpp and uc beside the parity column, with the
   train CLI's steps/s and every phase's wall, and writes them as JSON to
   --out/golden.json, beside the eval CSV and the train log.

--max_steps N < 80000, or a run the budget stops short, ends at fewer steps
(not the parity recipe: the schedule flags keep their defaults, so lambda
and the decay start only at 40 k and 60 k steps); the JSON gives the steps
reached and says so. --device cpu with a small --max_steps and
--segment rehearses the whole flow on the CPU (checkpoints, and so
resumes, come only every 2000 steps).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
from glob import glob

import numpy as np

from pcc_tpu_torch.io import save_point_cloud

PARITY = {"p2pointPSNR": 43.87, "p2planePSNR": 48.60, "chamfer_distance": 1.75e-4,
          "bpp": 0.651, "uniformity coefficient": 2.93}
RECIPE_STEPS = 80000       # cli/train.py's --max_steps default
N_TRAIN, N_TEST = 256, 32


def surface_clouds(seed: int = 42, n_train: int = N_TRAIN, n_test: int = N_TEST,
                   n: int = 8192):
    """eval/GOLDEN.md's seeded random smooth star-shaped surfaces, in its
    order: (train clouds, test clouds), float32 [n, 3] each."""
    rng = np.random.default_rng(seed)

    def surface_cloud():
        theta = np.arccos(rng.uniform(-1, 1, n))
        phi = rng.uniform(0, 2 * np.pi, n)
        r = 1.0
        for k in range(2, 7):
            a, p1, p2 = (rng.uniform(0.02, 0.15), rng.uniform(0, 2 * np.pi),
                         rng.uniform(0, 2 * np.pi))
            r = r + a * np.sin(k * theta + p1) * np.cos(k * phi + p2)
        x = r * np.sin(theta) * np.cos(phi)
        y = r * np.sin(theta) * np.sin(phi)
        z = r * np.cos(theta)
        return (np.stack([x, y, z], 1) * rng.uniform(0.4, 2.5, 3)).astype(np.float32)

    train = [surface_cloud() for _ in range(n_train)]
    test = [surface_cloud() for _ in range(n_test)]
    return train, test


def write_data(work: str) -> None:
    train, test = surface_clouds()
    for i, pc in enumerate(train):
        save_point_cloud(pc, f"train_{i:03d}.ply", path=os.path.join(work, "train"))
    for i, pc in enumerate(test):
        save_point_cloud(pc, f"test_{i:02d}.ply", path=os.path.join(work, "test"))


_STEP_FILE = re.compile(r"^(ae|prob|optimizer|global)_step(\d+)\.pkl$")


def prune_checkpoints(folder: str, keep: int = 2) -> None:
    """Delete the step-suffixed checkpoints of all but the `keep` newest
    steps."""
    if not os.path.isdir(folder):
        return
    files = [(int(m.group(2)), f) for f in os.listdir(folder)
             if (m := _STEP_FILE.match(f))]
    newest = sorted({s for s, _ in files})[-keep:]
    for s, f in files:
        if s not in newest:
            os.remove(os.path.join(folder, f))


def run(cmd: list, log_path: str, prune: str | None = None) -> tuple[float, str]:
    """Run a CLI, its output to the console and to log_path; every 30 s
    while it runs, prune_checkpoints(prune). Returns (wall s, output)."""
    print("$ " + " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    done = threading.Event()

    def pruner():
        while not done.wait(30.0):
            prune_checkpoints(prune)

    thread = threading.Thread(target=pruner, daemon=True) if prune else None
    if thread:
        thread.start()
    lines = []
    with open(log_path, "a") as log, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) as proc:
        for line in proc.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            log.write(line)
            lines.append(line)
        rc = proc.wait()
    done.set()
    if thread:
        thread.join()
        prune_checkpoints(prune)
    if rc != 0:
        raise RuntimeError(f"{cmd[2]} exited with {rc}")
    return time.perf_counter() - t0, "".join(lines)


def latest_step(folder: str) -> int:
    """The step of the newest step-suffixed checkpoint in folder, or 0."""
    steps = [int(m.group(2)) for f in (os.listdir(folder) if os.path.isdir(folder) else [])
             if (m := _STEP_FILE.match(f))]
    return max(steps, default=0)


def read_eval_csv(path: str) -> dict:
    """Column means of the eval CSV (the averages line's numbers, unrounded)."""
    import csv

    with open(path) as f:
        rows = list(csv.DictReader(f))
    return {k: float(np.mean([float(r[k]) for r in rows])) for k in PARITY} | {
        "clouds": len(rows)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--work", default=".golden_work/torch",
                   help="Folder of the data, the model, the streams and the decoded clouds.")
    p.add_argument("--out", default=None,
                   help="Folder of golden.json, the eval CSV and the logs (default: "
                        "--work/results).")
    p.add_argument("--max_steps", type=int, default=RECIPE_STEPS)
    p.add_argument("--segment", type=int, default=None,
                   help="Steps per run of the train CLI (a multiple of 2000, the "
                        "checkpoint window; default --max_steps, one run).")
    p.add_argument("--budget_s", type=float, default=2900.0,
                   help="With --segment: seconds of training after which no further "
                        "segment starts.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    work = os.path.abspath(args.work)
    out = os.path.abspath(args.out or os.path.join(work, "results"))
    os.makedirs(work, exist_ok=True)
    os.makedirs(out, exist_ok=True)
    py = [sys.executable, "-m"]
    dev = ["--device", args.device]
    model = os.path.join(work, "model")
    walls = {}

    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    else:
        smi = "cpu"
    print(smi, flush=True)
    t0 = time.perf_counter()
    if len(glob(os.path.join(work, "test", "*.ply"))) < N_TEST:
        write_data(work)
    walls["data_s"] = time.perf_counter() - t0

    train_cmd = py + ["pcc_tpu_torch.cli.train", "--train_glob",
                      os.path.join(work, "train", "*.ply"), "--model_save_folder", model,
                      "--rate_mode", "reference", "--batch_size", "1", "--step_window", "2000",
                      *dev]
    t_start, train_log, segments = time.perf_counter(), "", []
    reached = latest_step(model)
    segment = args.segment or args.max_steps
    for target in list(range(segment, args.max_steps, segment)) + [args.max_steps]:
        if reached >= target:
            continue
        if segments:
            rate = (segments[-1][1] - segments[-1][0]) / segments[-1][2]
            if rate <= 0:
                print(f"stopping: the segment to {segments[-1][1]} left no newer "
                      "step checkpoint to resume from", flush=True)
                break
            if time.perf_counter() - t_start + (target - reached) / rate > args.budget_s:
                print(f"stopping at step {reached}: the segment to {target} would not "
                      f"fit in the {args.budget_s:.0f} s budget", flush=True)
                break
        wall, log = run(train_cmd + ["--max_steps", str(target)],
                        os.path.join(out, "train.log"), prune=model)
        train_log += log
        segments.append((reached, latest_step(model), wall))
        reached = segments[-1][1]
    walls["train_s"] = time.perf_counter() - t_start
    windows = [(int(s), float(b), float(r)) for s, b, r in re.findall(
        r"Step (\d+) \| Feature bpp: [0-9.e+-]+ \| Bpp: ([0-9.e+-]+) \| Loss: [0-9.e+-]+ \| "
        r"([0-9.]+) steps/s", train_log)]

    comp, decomp = os.path.join(work, "comp"), os.path.join(work, "decomp")
    test_glob = os.path.join(work, "test", "*.ply")
    walls["compress_s"], _ = run(py + ["pcc_tpu_torch.cli.compress", test_glob, comp, model, *dev],
                                 os.path.join(out, "codec.log"))
    walls["decompress_s"], _ = run(py + ["pcc_tpu_torch.cli.decompress", comp, decomp, model,
                                         *dev], os.path.join(out, "codec.log"))
    csv_path = os.path.join(out, "eval.csv")
    walls["eval_s"], eval_log = run(py + ["pcc_tpu_torch.cli.eval", "--input_glob", test_glob,
                                          "--compressed_path", comp, "--decompressed_path",
                                          decomp, "--output_file", csv_path, *dev],
                                    os.path.join(out, "eval.log"))
    got = read_eval_csv(csv_path)
    rates = [r for _, _, r in windows]
    result = {
        "card": smi, "steps": reached, "parity_recipe": reached == RECIPE_STEPS,
        "segments": [dict(start=a, end=b, wall_s=w, steps_per_s=(b - a) / w)
                     for a, b, w in segments],
        "metrics": got, "parity_column": PARITY,
        "averages_line": next((ln for ln in eval_log.splitlines() if ln.startswith("Done!")), ""),
        "steps_per_s_windows": rates,
        "steps_per_s_median": float(np.median(rates)) if rates else None,
        "train_bpp_last_window": windows[-1][1] if windows else None,
        "walls_s": walls,
    }
    print(f"golden run on {smi}: {reached} steps"
          + ("" if result["parity_recipe"] else " (NOT the parity recipe's 80000)"))
    for k, want in PARITY.items():
        print(f"  {k:24s} port {got[k]:.6g}   GOLDEN.md parity column {want:g}")
    print(f"  train {walls['train_s']:.1f} s, median {result['steps_per_s_median']} steps/s; "
          f"compress {walls['compress_s']:.1f} s, decompress {walls['decompress_s']:.1f} s, "
          f"eval {walls['eval_s']:.1f} s")
    with open(os.path.join(out, "golden.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
