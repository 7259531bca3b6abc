"""Kernels of this tree beside another tree's, in turns on one card.

  python3 -m pcc_tpu_torch.tools.kernel_ab OTHER_TREE    # from the repo root

OTHER_TREE is a checkout of another commit (e.g. `git archive` of the
parent unpacked into a git-ignored folder). Each tree is driven through its
own public wrappers, in a process of its own that imports that tree's
package and builds its kernels from that tree's sources, in the order
other, this, this, other. Every process makes the same seeded inputs and
times each case with CUDA events; the outputs of the two trees are
compared. The cases:

- the patch decoder's two instances (ops/decoder_cuda.py: pack_decoder
  once, then patch_decoder) at the IPDAE serving batch's shape (h2 [4096,
  1024], d 16, k 128);
- the patch encoder (ops/sa_cuda.py::patch_encoder) at [4096, 256, 3], knn
  16, D 16: float32; bf16 serving on seeded weights and on the same with
  the last layer calibrated as chip_smoke.py's spread_symbols does (about
  5000x); bf16 with its winners (the train step's [512, 256, 3]);
- the PPPF-AE stages (ops/pppf_sa_cuda.py::pppf_sa_fused, "pppf") at the
  serving batch's shapes (P = 1024), float32 and bf16, and bf16 with the
  BatchNorm scales doubled (chip_smoke.py's PPPF_BN_GAIN);
- PPPE's "pppe" stages (sa2, sa3 at 32 clouds), float32 and bf16.

Prints the card's name and power limit, then one line per case: each
turn's ms, and how far the two trees' outputs differ.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile

P, C, D, K = 4096, 1024, 16, 128
REPS = 20
SAMPLE = 1 << 20
CASES = ("patch_decoder_bf16", "patch_decoder", "patch_encoder", "patch_encoder_bf16",
         "patch_encoder_bf16 calibrated", "patch_encoder_bf16 winners",
         "pppf_sa_stage sa1", "pppf_sa_stage sa2", "pppf_sa_stage sa3",
         "pppf_sa_stage_bf16 sa1", "pppf_sa_stage_bf16 sa2", "pppf_sa_stage_bf16 sa3",
         "pppf_sa_stage_bf16 sa3 gain", "pppe_sa_stage sa2", "pppe_sa_stage sa3",
         "pppe_sa_stage_bf16 sa2", "pppe_sa_stage_bf16 sa3")
# (S, N, C, nsample, radius, widths after the input): PPPF-AE's stages at
# its serving batch (P = 1024) and PPPE's "pppe" stages (P = 32)
PPPF = {"sa1": (256, 256, 0, 32, 0.2, (3, 64, 64, 128)),
        "sa2": (128, 256, 128, 64, 0.4, (128, 128, 256)),
        "sa3": (32, 128, 256, 128, 0.8, (256, 512, 1024))}
PPPE = {"sa2": (128, 512, 192, 32, 0.0, (128, 128, 256)),
        "sa3": (32, 128, 256, 32, 0.0, (256, 256, 512))}


def _time(call) -> tuple:
    import torch

    out = call()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        call()
    t1.record()
    torch.cuda.synchronize()
    if isinstance(out, tuple):
        out = torch.cat([o.float().flatten() for o in out])
    out = out.flatten().cpu()
    # the whole output by its digest, its first SAMPLE entries as they are
    return (t0.elapsed_time(t1) / REPS, hashlib.sha256(out.numpy().tobytes()).hexdigest(),
            out[:SAMPLE].clone())


def worker(out_path: str) -> None:
    """Time CASES with this process's pcc_tpu_torch (the tree on
    PYTHONPATH) and save {case: (ms, output)} to out_path."""
    import torch

    from pcc_tpu_torch.ops.decoder_cuda import pack_decoder, patch_decoder
    from pcc_tpu_torch.ops.pppf_sa_cuda import bf16_layers, pppf_sa_fused
    from pcc_tpu_torch.ops.sa_cuda import bf16_wb, patch_encoder

    g = torch.Generator().manual_seed(22)

    def layer(n_in, n_out):
        w = (torch.rand((n_in, n_out), generator=g) * 2 - 1) * n_in ** -0.5
        return w.cuda(), (torch.rand(n_out, generator=g) * 0.2 - 0.1).cuda()

    h2 = torch.rand((P, C), generator=g).cuda()
    lat = torch.randint(-3, 4, (P, D), generator=g).float().cuda()
    w3r, b3r = layer(C, K * 128)
    mlp = [layer(a, b) for a, b in zip((128 + D, 128, 64, 32), (128, 64, 32, 3))]
    res = {}
    for case in CASES[:2]:
        bf16 = case.endswith("_bf16")
        packed = pack_decoder(w3r.t().contiguous(), b3r, mlp, bf16=bf16)
        res[case] = _time(lambda: patch_decoder(h2, lat, w3r, b3r, mlp, K, packed=packed,
                                                bf16=bf16))

    pts = ((torch.rand((4096, 256, 3), generator=g) * 2 - 1) * 0.4).cuda()
    sa = [layer(a, b) for a, b in zip((3, 32, 64), (32, 64, 128))]
    pn = [layer(a, b) for a, b in zip((131, 128, 256, 512), (128, 256, 512, D))]
    z = patch_encoder(pts, sa, pn, 16)
    scale = 1.5 / z.std(dim=0)
    cal = pn[:-1] + [(pn[-1][0] * scale, (pn[-1][1] - z.mean(dim=0)) * scale)]
    sa16, pn16, cal16 = bf16_wb(sa), bf16_wb(pn), bf16_wb(cal)
    p512 = pts[:512].contiguous()
    res["patch_encoder"] = _time(lambda: patch_encoder(pts, sa, pn, 16))
    res["patch_encoder_bf16"] = _time(lambda: patch_encoder(pts, sa16, pn16, 16, bf16=True))
    res["patch_encoder_bf16 calibrated"] = _time(
        lambda: patch_encoder(pts, sa16, cal16, 16, bf16=True))
    res["patch_encoder_bf16 winners"] = _time(
        lambda: patch_encoder(p512, sa, pn, 16, return_winners=True, bf16=True))

    def stage_layers(widths):
        out = []
        for a, b in zip(widths[:-1], widths[1:]):
            w, bias = layer(a, b)
            mean = ((torch.rand(b, generator=g) - 0.5) * 0.2).cuda()
            mul = torch.rand(b, generator=g) + 0.5
            mul = (mul * torch.where(torch.rand(b, generator=g) < 0.3, -1.0, 1.0)).cuda()
            beta = ((torch.rand(b, generator=g) - 0.3) * 0.5).cuda()
            out.append((w, bias, mean, mul, beta))
        return out

    for layout, shapes, p in (("pppf", PPPF, 1024), ("pppe", PPPE, 32)):
        for name, (S, N, Cf, ns, radius, widths) in shapes.items():
            xyz = torch.rand((p, N, 3), generator=g).cuda()
            new_xyz = xyz if S == N else xyz[:, torch.randint(0, N, (S,), generator=g)].contiguous()
            feat = (torch.rand((p, N, Cf), generator=g).to(torch.bfloat16).float().cuda()
                    if Cf else None)
            layers = stage_layers((Cf + 3,) + widths)
            kw = dict(nsample=ns, radius=radius, layout=layout)
            label = "pppf_sa_stage" if layout == "pppf" else "pppe_sa_stage"
            res[f"{label} {name}"] = _time(lambda: pppf_sa_fused(new_xyz, xyz, feat, layers, **kw))
            l16 = bf16_layers(layers)
            res[f"{label}_bf16 {name}"] = _time(
                lambda: pppf_sa_fused(new_xyz, xyz, feat, l16, bf16=True, **kw))
            if layout == "pppf" and name == "sa3":
                gained = [(w, b, m, mul * 2, beta) for w, b, m, mul, beta in l16]
                res[f"{label}_bf16 {name} gain"] = _time(
                    lambda: pppf_sa_fused(new_xyz, xyz, feat, gained, bf16=True, **kw))
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
        (_, da, a), (_, db, b) = runs[1][1][case], runs[0][1][case]
        share = float((a == b).double().mean())
        err = float((a - b).abs().max())
        print(f"{case}: other {' / '.join(f'{t:.4f}' for t in ms['other'])} ms, this "
              f"{' / '.join(f'{t:.4f}' for t in ms['this'])} ms; outputs "
              f"{'bit for bit' if da == db else 'NOT bit for bit'} (sha256); of the first "
              f"{a.numel()} entries {share:.5f} bit-equal, max |diff| {err:.3g} of "
              f"{float(b.abs().max()):.3g}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    elif len(sys.argv) == 2:
        main(sys.argv[1])
    else:
        sys.exit(__doc__)
