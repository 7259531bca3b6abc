"""FPS at the IPDAE serving skeleton [64, 8192 -> 64], this tree against
another one, on an NVIDIA GPU.

  python3 -m pcc_tpu_torch.tools.fps_ab OTHER_TREE   # from the repo root

OTHER_TREE is a checkout of another commit (for example a `git archive`
of the parent unpacked into a directory that .gitignore lists). The two
trees run in turns, other, this, this, other, each in a process of its own
that builds that tree's csrc/fps.cu and times its fps_batch on
chip_smoke.py's seeded clouds, normalized as the codec normalizes them:
CUDA-event ms over 200 calls after a warm-up, and device ms from CUDA-graph
replays, three of each. Prints the card's name and power limit, then one
JSON line per run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(tree: str) -> dict:
    """The times of one tree, in this process (the tree first on the path)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from pcc_tpu_torch.ops.fps import fps_batch
    from pcc_tpu_torch.ops.normalize import normalize

    dev = torch.device("cuda")
    x = torch.from_numpy(np.stack(cs.synthetic_clouds(64, 8192, cs.SEED))).to(dev)
    pc01 = normalize(x, 0.01)[0].contiguous()
    z = torch.zeros(64, dtype=torch.int32, device=dev)
    fn = lambda: fps_batch(pc01, 64, z)  # noqa: E731
    return dict(ms=[cs.cuda_ms(fn, 200) for _ in range(3)],
                device_ms=[cs.graph_ms(fn, 50) for _ in range(3)])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other tree's root")
    ap.add_argument("--tree", help=argparse.SUPPRESS)   # a worker: time this tree
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(dict(tree=args.tree, **measure(os.path.abspath(args.tree)))))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    other = os.path.abspath(args.other)
    for tree in (other, REPO, REPO, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), args.other, "--tree",
                              tree], cwd=tree, capture_output=True, text=True, check=True)
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
