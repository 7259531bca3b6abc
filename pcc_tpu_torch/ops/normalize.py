"""Unit-cube normalization (reference pn_kit.py:47-66 semantics).

Centers the cloud on 0.5 and scales the longest bbox extent to (1 - margin),
with the operation order of pcc_tpu/ops/normalize.py so both packages
produce the same bits. The (center, longest) pair is the `.c.bin` header
stream (compress.py:148-152).
"""

from __future__ import annotations

import torch


def normalize(pc: torch.Tensor, margin: float = 0.01, values: torch.Tensor | None = None):
    """Normalize clouds along their point axis.

    Args:
      pc: [..., N, 3] float32.
      values: the clouds the normalized coordinates are computed from, where
        they are not pc's (the same points rounded otherwise:
        codec.py::upload_values); the bounding box is pc's.
    Returns:
      (pc01 [..., N, 3], center [..., 3], longest [...]).
    """
    mx = pc.amax(dim=-2)
    mn = pc.amin(dim=-2)
    center = (mx + mn) / 2.0
    longest = (mx - mn).amax(dim=-1)
    pc01 = ((pc if values is None else values) - center[..., None, :]) * (1.0 - margin) \
        / longest[..., None, None] + 0.5
    return pc01, center, longest


def denormalize(pc01: torch.Tensor, center: torch.Tensor,
                longest: torch.Tensor, margin: float = 0.01) -> torch.Tensor:
    """Exact inverse of `normalize` for one cloud (reference pn_kit.py:62-66)."""
    return (pc01 - 0.5) * longest / (1.0 - margin) + center
