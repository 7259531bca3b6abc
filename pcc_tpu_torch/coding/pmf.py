"""Rate estimate of the latent entropy model (counterpart of
pcc_tpu/coding/pmf.py::estimate_bits_from_pmf; reference pn_kit.py:439-450).

The differentiable code length that the training loss charges. The float
CDF mode's pmf -> cdf conversions are not ported: the port codes in the
integer CDF mode (coding/iprob.py).
"""

from __future__ import annotations

import torch


def estimate_bits_from_pmf(pmf: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Total code length estimate -sum log2 pmf[sym], each probability
    clamped below at 1e-3.

    Args:
      pmf: [..., L]; sym: [...] integer symbols in [0, L).
    """
    L = pmf.shape[-1]
    p = torch.gather(pmf.reshape(-1, L), 1, sym.reshape(-1, 1).long())[:, 0]
    # jnp.clip(p, 1e-3)'s gradient: half on a probability of exactly 1e-3
    return torch.sum(-torch.log2(torch.maximum(p, p.new_tensor(1e-3))))
