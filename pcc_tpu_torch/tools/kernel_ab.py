"""The patch decoder's two instances in this tree beside another tree's, in
turns on one card.

  python3 -m pcc_tpu_torch.tools.kernel_ab OTHER_TREE    # from the repo root

OTHER_TREE is a checkout of another commit (e.g. `git archive` of the
parent unpacked into a git-ignored folder). Each tree is driven through its
own public wrappers (ops/decoder_cuda.py: pack_decoder once, then
patch_decoder), in a process of its own that imports that tree's package
and builds its kernels from that tree's sources, in the order other, this,
this, other. Every process makes the same seeded inputs at the IPDAE
serving batch's shape (h2 [4096, 1024], d 16, k 128) and times each case
with CUDA events; the outputs of the two trees are compared.

Prints the card's name and power limit, then one line per case: each turn's
ms, and how far the two trees' outputs differ.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

P, C, D, K = 4096, 1024, 16, 128
REPS = 20
CASES = ("patch_decoder_bf16", "patch_decoder")


def worker(out_path: str) -> None:
    """Time CASES with this process's pcc_tpu_torch (the tree on
    PYTHONPATH) and save {case: (ms, output)} to out_path."""
    import torch

    from pcc_tpu_torch.ops.decoder_cuda import pack_decoder, patch_decoder

    g = torch.Generator().manual_seed(22)

    def layer(n_in, n_out):
        w = (torch.rand((n_in, n_out), generator=g) * 2 - 1) * n_in ** -0.5
        return w.cuda(), (torch.rand(n_out, generator=g) * 0.2 - 0.1).cuda()

    h2 = torch.rand((P, C), generator=g).cuda()
    lat = torch.randint(-3, 4, (P, D), generator=g).float().cuda()
    w3r, b3r = layer(C, K * 128)
    mlp = [layer(a, b) for a, b in zip((128 + D, 128, 64, 32), (128, 64, 32, 3))]
    res = {}
    for case in CASES:
        bf16 = case.endswith("_bf16")
        packed = pack_decoder(w3r.t().contiguous(), b3r, mlp, bf16=bf16)

        def call():
            return patch_decoder(h2, lat, w3r, b3r, mlp, K, packed=packed, bf16=bf16)

        out = call()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(REPS):
            call()
        t1.record()
        torch.cuda.synchronize()
        res[case] = (t0.elapsed_time(t1) / REPS, out.cpu())
    torch.save(res, out_path)


def run_tree(tree: str, out_path: str) -> dict:
    import torch

    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", out_path],
                          cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: worker failed\n{proc.stdout}\n{proc.stderr}")
    return torch.load(out_path)


def main(other: str) -> None:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    this = os.getcwd()
    turns = [("other", os.path.abspath(other)), ("this", this), ("this", this),
             ("other", os.path.abspath(other))]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, tree) in enumerate(turns):
            runs.append((label, run_tree(tree, os.path.join(tmp, f"{i}.pt"))))
    for case in CASES:
        ms = {lab: [r[case][0] for l2, r in runs if l2 == lab] for lab in ("other", "this")}
        a, b = runs[1][1][case][1], runs[0][1][case][1]
        share = float((a == b).double().mean())
        err = float((a - b).abs().max())
        print(f"{case}: other {' / '.join(f'{t:.4f}' for t in ms['other'])} ms, this "
              f"{' / '.join(f'{t:.4f}' for t in ms['this'])} ms; outputs {share:.5f} bit-equal, "
              f"max |diff| {err:.3g} of {float(b.abs().max()):.3g}")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    elif len(sys.argv) == 2:
        main(sys.argv[1])
    else:
        sys.exit(__doc__)
