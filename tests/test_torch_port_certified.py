"""Certified rounding (csrc/certified.cuh) by its plain twin,
pcc_tpu_torch/ops/certified.py: the rule by which the bf16 encoder and the
bf16 "pppf" stage run their products on the tensor cores and still give the
outputs of the float32 k-order sums bit for bit. The kernels themselves
are held to their k-order replays on the card (tests/test_torch_port_cuda.py,
chip_smoke.py phases 28-29); here the rule and the layouts they rest on:

- every entry the rule does not flag is f(s_k), wherever in [s_k - E,
  s_k + E] the other sum lies, on random, cancelling and calibration-like
  rows (a last layer scaled about 5000x and shifted by its mean, as
  chip_smoke.py::spread_symbols does) and negative BatchNorm multipliers;
- E covers the float32 sum in other orders: reversed, pairwise, and in
  blocks of 16 with every addition truncated toward zero (the tensor cores'
  model);
- the weights' fragment layout (pack_frags) as mma.sync and the fix-ups
  read it;
- the bf16 k-order replay of the "pppf" stack, held to the plain bf16
  stage by the bf16 hold's figures.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pcc_tpu_torch.ops.bf16 import round_bf16
from pcc_tpu_torch.ops.certified import (STRESS_DEPTHS, STRESS_KINDS, bias_relu, bn_relu,
                                         bound_sums, cached_frags, certify, err_bound,
                                         flag_shares, model_ratio, model_sums, pack_frags,
                                         stress_rows)
from pcc_tpu_torch.ops.pppf_sa_cuda import bf16_layers, pppf_sa_plain, pppf_sa_points
from pcc_tpu_torch.ops.sa_cuda import fma_matmul
from test_torch_port_pppf import one_thread_per_worker  # noqa: F401

BF16_SHARE = 0.95         # the bf16 hold: entries bit-equal at least
BF16_TOL = 2.0 ** -7      # of the largest |entry|, every entry


def _rows(kind: str, g: torch.Generator, r: int, k: int, n: int):
    """(x [r, k], w [k, n] bf16 values, f) of a layer: post-relu inputs
    into a relu layer ("random"), rows whose sums nearly cancel
    ("cancelling"), a last layer scaled 5000x and shifted by its mean, no
    relu ("calibrated"), a BatchNorm stage layer with negative multipliers
    ("bn")."""
    x = round_bf16(torch.relu(torch.randn((r, k), generator=g)))
    w = round_bf16(torch.randn((k, n), generator=g) * k ** -0.5)
    b = round_bf16(torch.randn(n, generator=g) * 0.1)
    if kind == "cancelling":
        # every column sums to about 0 over rows that are nearly constant
        x = round_bf16(1 + 0.01 * torch.rand((r, k), generator=g))
        w = round_bf16(w - w.mean(dim=0))
        return x, w, bias_relu(b * 0.01)
    if kind == "calibrated":
        s = x.double() @ w.double()
        scale = 5000.0
        w = round_bf16(w * scale)
        shift = -(s.mean(dim=0) * scale).to(torch.float32)
        return x, w, lambda v: round_bf16(v + shift)
    if kind == "bn":
        mul = torch.rand(n, generator=g) * 1.5 + 0.25
        mul[::3] *= -1
        mean, beta = (torch.randn(n, generator=g) * 0.1 for _ in range(2))
        return x, w, bn_relu(b, mean, mul, beta)
    return x, w, bias_relu(b)


@pytest.mark.parametrize("kind", ["random", "cancelling", "calibrated", "bn"])
@pytest.mark.parametrize("k", [32, 131, 256])
def test_unflagged_entries_are_the_k_order_outputs(kind, k):
    """Wherever the tensor cores' sum lies within E of the k-order sum (its
    two ends, and random points between), every entry that certify does
    not flag is f(s_k) bit for bit."""
    g = torch.Generator().manual_seed(k)
    x, w, f = _rows(kind, g, 48, k, 40)
    s_k = fma_matmul(x, w)
    r = bound_sums(x, w)
    e = err_bound(r, k).double()
    want = f(s_k).view(torch.int32)
    flagged_any = 0.0
    for u in (-1.0, 1.0, None):
        step = (torch.rand(s_k.shape, generator=g, dtype=torch.float64) * 2 - 1
                if u is None else torch.full(s_k.shape, u, dtype=torch.float64))
        # s_k + step E, rounded toward s_k so that it stays within E
        t = s_k.double() + step * e
        s = t.to(torch.float32)
        s = torch.where((s.double() - s_k.double()).abs() > e,
                        torch.nextafter(s, s_k), s)
        assert bool(((s.double() - s_k.double()).abs() <= e).all())
        lo, flags = certify(s, r, k, f)
        assert torch.equal(lo.view(torch.int32)[~flags], want[~flags])
        flagged_any = max(flagged_any, float(flags.double().mean()))
    assert flagged_any < 1.0


def _chop(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero (24 significant bits)."""
    y = x64.to(torch.float32)
    over = y.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _orders(x: torch.Tensor, w: torch.Tensor) -> dict:
    """The float32 sums of x @ w in other orders than k-order."""
    p = x.double()[:, :, None] * w.double()[None]                   # [r, k, n], exact
    k = p.shape[1]
    rev = torch.zeros(p.shape[0], p.shape[2])
    for i in reversed(range(k)):
        rev = (rev.double() + p[:, i]).to(torch.float32)

    def pairwise(q):
        q = q.to(torch.float32)
        while q.shape[1] > 1:
            if q.shape[1] % 2:
                q = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
            q = (q[:, 0::2].double() + q[:, 1::2].double()).to(torch.float32)
        return q[:, 0]

    trunc = torch.zeros(p.shape[0], p.shape[2])
    blocks = torch.zeros(p.shape[0], p.shape[2])
    for b0 in range(0, k, 16):
        for i in range(b0, min(k, b0 + 16)):
            trunc = _chop(trunc.double() + p[:, i])
        blocks = _chop(blocks.double() + p[:, b0:b0 + 16].sum(dim=1))
    return dict(reversed=rev, pairwise=pairwise(p), truncated=trunc, blocks=blocks)


@pytest.mark.parametrize("kind", ["random", "cancelling", "calibrated"])
@pytest.mark.parametrize("k", [64, 259])
def test_bound_covers_other_summation_orders(kind, k):
    """|s - s_k| <= E for the sum reversed, pairwise, and in blocks of 16
    with every addition truncated toward zero (and each block added whole,
    truncated), E from the exact sums of bound_sums."""
    g = torch.Generator().manual_seed(100 + k)
    x, w, _ = _rows(kind, g, 16, k, 24)
    s_k = fma_matmul(x, w).double()
    e = err_bound(bound_sums(x, w), k).double()
    for name, s in _orders(x, w).items():
        gap = (s.double() - s_k).abs()
        assert bool((gap <= e).all()), (name, float((gap / e).max()))


def test_partial_sum_bound_flags_fewest():
    """At a layer of the encoder's shape (K = 256), the kernels' bound by
    the partial sums flags fewer entries than the bound linear in K, which
    flags fewer than Cauchy-Schwarz's: why the kernels take the first."""
    g = torch.Generator().manual_seed(7)
    x, w, f = _rows("random", g, 64, 256, 64)
    shares = flag_shares(x, w, f)
    assert 0 < shares["partial_sums"] < shares["linear"] < shares["cauchy_schwarz"] < 1


@pytest.mark.parametrize("kind", STRESS_KINDS)
def test_model_sums_plain_within_the_bound(kind):
    """model_sums on the CPU (the model itself: k16 blocks, every addition
    truncated) keeps |s_tc - s_k| <= E on the stress rows at every depth of
    the card's check, with s_k the k-order sum; the card's check
    (test_cert_model_holds_on_the_card, chip_smoke.py) holds the tensor
    cores to the same ratio."""
    for k in STRESS_DEPTHS:
        x, w = stress_rows(kind, k, seed=k)
        assert x.shape == (64, k) and w.shape == (k, 16)
        assert torch.equal(round_bf16(x), x) and torch.equal(round_bf16(w), w)
        s_tc, s_k, err = model_sums(x, w)
        assert torch.equal(s_k, fma_matmul(x, w))
        assert model_ratio(s_tc, s_k, err) <= 1.0


@pytest.mark.parametrize("k,n,align", [(32, 64, 16), (131, 128, 16), (7, 12, 16), (40, 48, 64)])
def test_pack_frags_layout(k, n, align):
    """pack_frags puts W[16 s + 2 t (+1)][8 j + g] in lane 4 g + t's b0 and
    the same at k + 8 in its b1 (n8 tile j, k16 step s), zeros past K and N;
    a column's 16 values of a k16 step are the lanes 4 g .. 4 g + 3's 32
    bytes, as the fix-ups read them."""
    g = torch.Generator().manual_seed(k * n)
    w = round_bf16(torch.randn((k, n), generator=g))
    frag = pack_frags(w, align)
    kp, np_ = (k + 15) // 16 * 16, (n + align - 1) // align * align
    assert frag.shape == (np_ // 8, kp // 16, 32, 2)
    wp = torch.zeros((kp, np_))
    wp[:k, :n] = w
    bits = frag.numpy().view(np.uint32)

    def half(v, h):
        bits16 = ((v >> (16 * h)) & 0xffff) << 16
        return np.array([bits16], dtype=np.uint32).view(np.float32)[0]

    for j in range(np_ // 8):
        for s in range(kp // 16):
            for lane in range(32):
                gg, t = lane // 4, lane % 4
                for reg, k0 in ((0, 16 * s + 2 * t), (1, 16 * s + 8 + 2 * t)):
                    v = int(bits[j, s, lane, reg])
                    assert half(v, 0) == wp[k0, 8 * j + gg]
                    assert half(v, 1) == wp[k0 + 1, 8 * j + gg]
            # the fix-ups' read: 8 words of lanes 4 g .. 4 g + 3, pairs in
            # the order b0, b1 of each lane
            for gg in range(8):
                words = bits[j, s, 4 * gg:4 * gg + 4].reshape(-1)
                order = [0, 2, 4, 6, 1, 3, 5, 7]          # pair p -> word
                col = [half(int(words[order[p]]), h) for p in range(8) for h in range(2)]
                assert col == wp[16 * s:16 * s + 16, 8 * j + gg].tolist()


def test_cached_frags_packs_once_per_weights():
    """cached_frags packs each weight once while it lives unchanged: the
    same tensors give the same packing, an in-place change packs again,
    weights under 16 deep give None, and the bf16 weights a model makes
    under torch.inference_mode (no version counter) are taken too."""
    g = torch.Generator().manual_seed(5)
    ws = [round_bf16(torch.randn((k, 32), generator=g)) for k in (3, 40)]
    first = cached_frags(ws)
    assert first[0] is None and torch.equal(first[1], pack_frags(ws[1]))
    assert cached_frags(ws)[1] is first[1]
    ws[1][0, 0] = 2.0
    again = cached_frags(ws)[1]
    assert again is not first[1] and torch.equal(again, pack_frags(ws[1]))
    with torch.inference_mode():
        w = round_bf16(torch.randn((64, 16), generator=g))
        flat = cached_frags([w, w], cat=True)
        assert cached_frags([w, w], cat=True) is flat
    assert torch.equal(flat, torch.cat([pack_frags(w).flatten()] * 2))


def _stage_layers(g, widths):
    layers = []
    for a, b in zip(widths[:-1], widths[1:]):
        w = (torch.rand((a, b), generator=g) * 2 - 1) * a ** -0.5
        mul = torch.rand(b, generator=g) * 1.5 + 0.25
        mul[::4] *= -1
        rest = [(torch.rand(b, generator=g) * 2 - 1) * 0.1 for _ in range(3)]
        layers.append((w, rest[0], rest[1], mul, rest[2]))
    return bf16_layers(layers)


@pytest.mark.parametrize("S,N,C,nsample,radius,widths",
                         [(16, 32, 13, 8, 0.4, (24, 40)), (12, 24, 0, 32, 0.3, (3, 20, 16)),
                          (8, 40, 29, 12, 0.5, (32, 16, 48))])
def test_pppf_bf16_replay_holds_to_the_plain_stage(S, N, C, nsample, radius, widths):
    """The bf16 k-order replay of the "pppf" stack (pppf_sa_points with
    replay and bf16: the bf16 kernel's arithmetic, which phase 29 holds the
    kernel to bit for bit) against pppf_sa_plain(bf16=True): at least
    BF16_SHARE of the entries bit-equal, every one within BF16_TOL of the
    largest, every one a bf16 value."""
    g = torch.Generator().manual_seed(S * N)
    P = 3
    xyz = torch.rand((P, N, 3), generator=g)
    new_xyz = xyz[:, torch.randint(0, N, (S,), generator=g)].contiguous()
    feat = round_bf16(torch.rand((P, N, C), generator=g)) if C else None
    layers = _stage_layers(g, (C + 3,) + widths)
    kw = dict(nsample=nsample, radius=radius)
    rep = pppf_sa_points(new_xyz, xyz, feat, layers, replay=True, bf16=True, **kw)
    ref = pppf_sa_plain(new_xyz, xyz, feat, layers, bf16=True, **kw)
    assert rep.shape == ref.shape
    assert torch.equal(round_bf16(rep), rep)
    assert float((rep == ref).double().mean()) >= BF16_SHARE
    assert float((rep - ref).abs().max()) <= BF16_TOL * float(ref.abs().max())
    with pytest.raises(ValueError, match="replay"):
        pppf_sa_points(new_xyz, xyz, feat, layers, bf16=True, **kw)


def test_cert_breakdown_variants_apply_to_the_sources():
    """Every variant of tools/cert_breakdown.py edits text that its kernel
    source holds, so that the tool builds on the card."""
    from pcc_tpu_torch.tools import cert_breakdown as cb
    from pcc_tpu_torch.tools.variants import edited

    for kernel, extra in (("patch_encoder_bf16", {"noselect": cb.NOSELECT, "nosa": cb.NOSA,
                                                  "nolast": cb.NOLAST}),
                          ("pppf_sa_stage_bf16", {})):
        for label, (name, alternatives) in cb._variants(kernel, extra).items():
            assert edited(name, alternatives) is not None, (kernel, label)
