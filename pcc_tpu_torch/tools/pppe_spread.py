"""Where the PPPE train step's card and CPU results part: the same float32
step (PPPEConfig(N=512, latent_dim=32, L=7), seeded weights, two clouds
uniform in the unit cube, lam 1e-2) on an NVIDIA GPU and on the CPU, every
module's output and every gradient compared.

  python3 -m pcc_tpu_torch.tools.pppe_spread [--json PATH] [--blobs]

Forward hooks record each SA stage's output features, each stage conv's
pre-BatchNorm product, the global feature's conv, the encoder's latent and
the decoder's outputs; the table gives, module by module in call order,
max |card - CPU| / max |CPU|, and the same per parameter gradient after
the backward of the step's loss. The first module whose spread rises above
float32 rounding is the op that sets the gradients' spread. --blobs takes
clustered clouds instead of uniform ones. Prints the card's name and power
limit first, then the table, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from pcc_tpu_torch.config import PPPEConfig
from pcc_tpu_torch.models.layers import PointConv
from pcc_tpu_torch.models.pppe import estimate_bits_per_point_conditional, make_pppe_model
from pcc_tpu_torch.ops.chamfer import chamfer_distance

CFG = dict(N=512, latent_dim=32, L=7)
SEED = 11
LAM = 1e-2


def clouds(blobs: bool) -> np.ndarray:
    """Two clouds of CFG["N"] points in the unit cube, from a numpy seed:
    uniform, or (blobs) eight tight Gaussian clusters each."""
    rng = np.random.default_rng(SEED)
    N = CFG["N"]
    if not blobs:
        return rng.random((2, N, 3)).astype(np.float32)
    centres = rng.random((2, 8, 1, 3))
    pts = centres + rng.standard_normal((2, 8, N // 8, 3)) * 0.03
    return np.clip(pts.reshape(2, N, 3), 0, 1).astype(np.float32)


def run(device: str, batch: np.ndarray):
    """(outputs by module name, in call order; gradients by parameter name;
    loss) of one train-mode forward and backward on `device`."""
    model = make_pppe_model(PPPEConfig(**CFG), seed=SEED).to(device).train()
    outs = {}

    def hook(name, pick):
        def fn(module, args, out):
            outs[name] = (out if pick is None else out[pick]).detach().double().cpu()
        return fn

    for name, m in model.named_modules():
        if name in ("encoder", "decoder") or name.startswith("encoder.sa_modules.") \
                and name.count(".") == 2:
            # the encoder's latent, the decoder's fine cloud, a stage's features
            m.register_forward_hook(hook(name, 0 if name == "encoder" else 1))
        elif name.startswith("encoder.") and isinstance(m, PointConv):
            m.register_forward_hook(hook(name, None))        # a conv's product
    x = torch.from_numpy(batch).to(device)
    _, fine, cond, y_q = model(x)
    rate = torch.clamp(estimate_bits_per_point_conditional(model, y_q, cond), 0.0, 100.0)
    dist, _ = chamfer_distance(fine, x, fast_search=True)
    loss = dist + LAM * rate
    loss.backward()
    grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    return outs, grads, float(loss.detach())


def spread(a: torch.Tensor, b: torch.Tensor) -> float:
    big = float(b.abs().max())
    return float((a - b).abs().max()) / big if big else float(a.abs().max())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--json", default=None)
    p.add_argument("--blobs", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pppe_spread needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    batch = clouds(args.blobs)
    card, cpu = run("cuda", batch), run("cpu", batch)
    rows = [("output", k, spread(card[0][k], cpu[0][k])) for k in cpu[0]]
    rows += [("gradient", k, spread(card[1][k], cpu[1][k])) for k in cpu[1]]
    for kind, k, v in rows:
        print(f"{kind:8s} {k:60s} {v:.3g}")
    out = dict(clouds="blobs" if args.blobs else "uniform", loss=[card[2], cpu[2]],
               outputs={k: v for kind, k, v in rows if kind == "output"},
               gradients={k: v for kind, k, v in rows if kind == "gradient"})
    line = json.dumps(out)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
