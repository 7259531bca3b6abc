"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking for
CUDA where there is no card raises: the port never carries on quietly on
the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for `device`; for CUDA, checks that a card exists and
    turns TF32 off. Float32 products then run in full float32, which the
    integer probability model's exactness rests on (coding/iprob.py) and
    which keeps the float paths comparable with the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
