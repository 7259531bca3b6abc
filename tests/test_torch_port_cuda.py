"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips, with the reason, where torch has no CUDA
device (the check runs inside the fixture, so every worker collects the
same tests). On a machine with a card:

  python -m pytest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from pcc_tpu_torch.codec import Codec, init_params
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops.decoder_cuda import pack_decoder, patch_decoder, patch_decoder_plain
from pcc_tpu_torch.coding.iprob_pppf import _qsel
from pcc_tpu_torch.ops import fps as fps_ops
from pcc_tpu_torch.ops.fps import fps_batch, fps_int_batch, fps_int_plain, fps_plain
from pcc_tpu_torch.ops.knn import select_nearest, sq_dists
from pcc_tpu_torch.ops.bf16 import round_bf16
from pcc_tpu_torch.ops.pppf_sa_cuda import (bf16_layers, pppe_kernel, pppe_plan, pppf_sa_bwd,
                                            pppf_sa_bwd_plain, pppf_sa_bwd_plain_bf16,
                                            pppf_sa_fused, pppf_sa_plain, pppf_sa_points,
                                            saved_views, stack_replay)
from pcc_tpu_torch.tools.holds import row_hold
from pcc_tpu_torch.ops.sa_cuda import _kernel_choices as _enc_choices
from pcc_tpu_torch.ops.sa_cuda import (bf16_wb, patch_encoder, patch_encoder_bwd,
                                       patch_encoder_bwd_plain, patch_encoder_plain,
                                       pointwise_plain, winners_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from pcc_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _wb(g, dims, dev):
    out = []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = a ** -0.5
        out.append((((torch.rand((a, b), generator=g) * 2 - 1) * bound).to(dev),
                    ((torch.rand(b, generator=g) * 2 - 1) * bound).to(dev)))
    return out


@pytest.mark.parametrize("B,N,S,twins", [(3, 1000, 16, False), (8, 8192, 64, False),
                                         (4, 4096, 64, True)])
def test_fps_kernel_bit_equal(dev, B, N, S, twins):
    """With twins every point has a duplicate: each pick is a tie that the
    block-wide argmax must give to the lowest index."""
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand((B, N, 3), generator=g)
    if twins:
        xyz[:, N // 2:] = xyz[:, :N // 2]
    xyz = xyz.to(dev)
    starts = torch.randint(0, N, (B,), generator=g).to(dev)
    before = cuda_lib.launches["fps"]
    out = fps_batch(xyz, S, starts)
    assert cuda_lib.launches["fps"] == before + 1
    assert torch.equal(out, fps_plain(xyz, S, starts))


def _fps_points(g, B, N, twins, grid_bits=None):
    """Uniform points (float32, or int32 grid coordinates in [0, 2^bits));
    with twins the second half repeats the first, so picks tie."""
    if grid_bits is None:
        x = torch.rand((B, N, 3), generator=g)
    else:
        x = torch.randint(0, 1 << grid_bits, (B, N, 3), generator=g, dtype=torch.int32)
    if twins:
        x[:, N - N // 2:] = x[:, :N // 2]
    return x


def _fps_case(dev, kind, B, N, npoint, twins, plan=None):
    """One launch of the float32 (kind "f32") or int32 ("i32") instance,
    by the launcher's plan or the given one, against its plain version;
    asserts that exactly one launch of that kernel was counted."""
    g = torch.Generator().manual_seed(B * 7919 + N * 31 + npoint)
    if kind == "f32":
        x = _fps_points(g, B, N, twins).to(dev)
        starts = torch.randint(0, N, (B,), generator=g, dtype=torch.int32).to(dev)
        want = fps_plain(x, npoint, starts)
        name, call = "fps", lambda: fps_batch(x, npoint, starts)
        if plan is not None:
            call = lambda: fps_ops._launch(x, npoint, starts, None, plan)  # noqa: E731
    else:
        q = _qsel(N)
        inf = 3 * 4 ** q + 1
        x = _fps_points(g, B, N, twins, grid_bits=q).to(dev)
        want = fps_int_plain(x, npoint, inf)
        name, call = "fps_int", lambda: fps_int_batch(x, npoint, inf)
        if plan is not None:
            call = lambda: fps_ops._launch(x, npoint, None, inf, plan)  # noqa: E731
    before = dict(cuda_lib.launches)
    got = call()
    after = dict(cuda_lib.launches)
    assert after[name] == before[name] + 1
    assert all(after[k] == before[k] for k in after if k != name)
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    assert torch.equal(got, want), f"{kind} [{B}, {N} -> {npoint}] plan {plan}"


# every shape of the users' paths (tests/test_torch_port_fps.py::PATH_SHAPES)
_FPS_PATH = [("f32", *s) for s in [
    (64, 8192, 64), (16, 8192, 64), (8, 8192, 64), (1024, 256, 128), (1024, 128, 32),
    (512, 256, 128), (512, 128, 32), (8, 64, 512), (8, 512, 128), (8, 128, 32),
    (128, 4, 512), (128, 512, 128), (128, 128, 32), (128, 512, 4),
    (32, 8192, 512), (32, 512, 128), (32, 128, 32),
    (4, 65536, 512), (2, 65536, 512), (1, 50000, 390), (1, 100000, 781)]] + [
    ("i32", 16, 64, 512), ("i32", 16, 512, 128), ("i32", 16, 128, 32)]


@pytest.mark.parametrize("kind,B,N,npoint", _FPS_PATH)
def test_fps_kernel_path_shapes(dev, kind, B, N, npoint):
    _fps_case(dev, kind, B, N, npoint, twins=False)


# edge cases: twins, saturation (npoint > N), N not a multiple of 32, B not a
# multiple of the clouds per block, one point, the largest cloud
_FPS_EDGES = [(5, 37, 50, False), (7, 200, 100, True), (3, 8192, 64, True),
              (2, 1000, 1100, False), (1, 1, 5, False), (9, 4, 9, True),
              (3, 16384, 16, False), (33, 513, 40, True), (130, 96, 96, True),
              (2, 16385, 40, True), (3, 131072, 24, True)]


@pytest.mark.parametrize("kind", ["f32", "i32"])
@pytest.mark.parametrize("B,N,npoint,twins", _FPS_EDGES)
def test_fps_kernel_edges(dev, kind, B, N, npoint, twins):
    _fps_case(dev, kind, B, N, npoint, twins)


@pytest.mark.parametrize("kind", ["f32", "i32"])
@pytest.mark.parametrize("N", [4, 37, 256, 512, 1000, 8192, 20000, 65536, 100000])
def test_fps_kernel_every_plan(dev, kind, N):
    """Every plan the launcher can pick at N (a warp per cloud with 1-8
    clouds a block, clusters of 1, 2, 4, 8 CTAs at every width, each CTA
    with the whole cloud or with its slice, points in registers or read
    from the slice) gives the plain version's picks, with twins, on 5
    clouds (not a multiple of the clouds per block)."""
    for plan in fps_ops.candidate_plans(N):
        _fps_case(dev, kind, 5, N, min(N + 3, 70), twins=True, plan=plan)


@pytest.mark.parametrize("case", ["points", "dtype_f32", "dtype_i32", "inf", "strided"])
def test_fps_kernel_rejects_unsupported(dev, case):
    x = torch.rand((2, 64, 3), device=dev)
    xi = torch.randint(0, 64, (2, 64, 3), dtype=torch.int32, device=dev)
    z = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        if case == "points":
            fps_batch(torch.rand((1, fps_ops.MAX_POINTS + 1, 3), device=dev), 4, z[:1])
        elif case == "dtype_f32":
            fps_batch(xi, 4, z)
        elif case == "dtype_i32":
            fps_int_batch(x, 4, 100)
        elif case == "inf":
            fps_int_batch(xi, 4, 0)
        else:
            fps_int_batch(xi.transpose(0, 1), 4, 100)


@pytest.mark.parametrize("P,N,knn,D", [(16, 256, 16, 16), (5, 32, 8, 4)])
def test_patch_encoder_kernel(dev, P, N, knn, D):
    g = torch.Generator().manual_seed(1)
    pts = ((torch.rand((P, N, 3), generator=g) * 2 - 1) * 0.4).to(dev)
    sa = _wb(g, [3, 32, 64, 128], dev)
    pn = _wb(g, [131, 128, 256, 512, D], dev)
    out = patch_encoder(pts, sa, pn, knn)
    torch.testing.assert_close(out, patch_encoder_plain(pts, sa, pn, knn),
                               atol=1e-5, rtol=0)
    assert torch.equal(patch_encoder(pts, sa, pn, knn), out)


def _flat(dp, dsa, dpn):
    return [dp] + [t for wb in list(dsa) + list(dpn) for t in wb]


@pytest.mark.parametrize("P,N,knn,D,twins", [(16, 256, 16, 16, False), (5, 32, 8, 4, False),
                                             (5, 32, 8, 4, True)])
def test_patch_encoder_bwd_kernel(dev, P, N, knn, D, twins):
    """Every output within 1e-4 of the largest entry of its plain version
    (float32 sums in another order), and two launches bitwise equal. With
    twins every point has a duplicate: every max is an exact tie, routed to
    the first winner by both."""
    g = torch.Generator().manual_seed(3)
    pts = (torch.rand((P, N, 3), generator=g) * 2 - 1) * 0.4
    if twins:
        pts[:, N // 2:] = pts[:, :N // 2]
    pts = pts.to(dev)
    sa = _wb(g, [3, 32, 64, 128], dev)
    pn = _wb(g, [131, 128, 256, 512, D], dev)
    cot = torch.randn((P, D), generator=g).to(dev)
    before = cuda_lib.launches["patch_encoder_bwd"]
    a = _flat(*patch_encoder_bwd(pts, cot, sa, pn, knn))
    assert cuda_lib.launches["patch_encoder_bwd"] == before + 1
    b = _flat(*patch_encoder_bwd_plain(pts, cot, sa, pn, knn))
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())
    again = _flat(*patch_encoder_bwd(pts, cot, sa, pn, knn))
    assert all(torch.equal(x, y) for x, y in zip(a, again))


@pytest.mark.parametrize("P,N,knn,D,twins", [(16, 256, 16, 16, False), (5, 32, 8, 4, True)])
def test_patch_encoder_winners_handover(dev, P, N, knn, D, twins):
    """The forward kernel's winners output leaves the latents bit for bit,
    equals the plain version's winners (first arg-max point per channel,
    also where twins make every max a tie), and the backward kernel on them
    equals the backward that gets them itself (one more forward launch)
    bit for bit, and the plain version on them within 1e-4."""
    g = torch.Generator().manual_seed(11)
    pts = (torch.rand((P, N, 3), generator=g) * 2 - 1) * 0.4
    if twins:
        pts[:, N // 2:] = pts[:, :N // 2]
    pts = pts.to(dev)
    sa = _wb(g, [3, 32, 64, 128], dev)
    pn = _wb(g, [131, 128, 256, 512, D], dev)
    cot = torch.randn((P, D), generator=g).to(dev)
    lat, win = patch_encoder(pts, sa, pn, knn, return_winners=True)
    assert win.dtype == torch.int32 and win.shape == (P, D)
    assert torch.equal(lat, patch_encoder(pts, sa, pn, knn))
    idx = select_nearest(sq_dists(pts, pts), knn)
    assert torch.equal(win.long(), winners_plain(pts, idx, pointwise_plain(pts, idx, sa, pn),
                                                 sa, pn))
    before = dict(cuda_lib.launches)
    a = _flat(*patch_encoder_bwd(pts, cot, sa, pn, knn, winners=win))
    assert cuda_lib.launches["patch_encoder_bwd"] == before["patch_encoder_bwd"] + 1
    assert cuda_lib.launches["patch_encoder"] == before["patch_encoder"]
    b = _flat(*patch_encoder_bwd(pts, cot, sa, pn, knn))
    assert cuda_lib.launches["patch_encoder"] == before["patch_encoder"] + 1
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = _flat(*patch_encoder_bwd_plain(pts, cot, sa, pn, knn, winners=win))
    for x, y in zip(a, c):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())


@pytest.mark.parametrize("N,knn,D", [(24, 8, 4), (32, 12, 4), (32, 8, 65)])
def test_patch_encoder_bwd_rejects_unsupported_shapes(dev, N, knn, D):
    g = torch.Generator().manual_seed(4)
    pts = torch.rand((2, N, 3), generator=g).to(dev)
    sa = _wb(g, [3, 32, 64, 128], dev)
    pn = _wb(g, [131, 128, 256, 512, D], dev)
    with pytest.raises(ValueError):
        patch_encoder_bwd(pts, torch.zeros((2, D), device=dev), sa, pn, knn)


def _decoder_case(dev, P, d, k, C=1024, seed=2):
    g = torch.Generator().manual_seed(seed)
    h2 = torch.rand((P, C), generator=g).to(dev)
    lat = torch.randint(-3, 4, (P, d), generator=g).float().to(dev)
    (w3r, b3r), = _wb(g, [C, k * 128], dev)
    mlp = _wb(g, [128 + d, 128, 64, 32, 3], dev)
    return h2, lat, w3r, b3r, mlp, k


# the kernel's tiles are 128 patch rows x one point's 128 channels, its
# latent steps 8 columns, its weight chunks 32: rows on both sides of a tile
# edge, one row, a ragged last tile; d below one step, two steps, the most
@pytest.mark.parametrize("P,d,k", [(70, 16, 128), (9, 4, 16)]
                         + [(P, d, k) for P in (1, 127, 129, 4100) for d in (4, 16, 64)
                            for k in (16, 128)])
def test_patch_decoder_kernel(dev, P, d, k):
    h2, lat, w3r, b3r, mlp, k = _decoder_case(dev, P, d, k)
    before = cuda_lib.launches["patch_decoder"]
    out = patch_decoder(h2, lat, w3r, b3r, mlp, k)
    assert cuda_lib.launches["patch_decoder"] == before + 1
    torch.testing.assert_close(out, patch_decoder_plain(h2, lat, w3r, b3r, mlp, k),
                               atol=1e-5, rtol=0)


def test_patch_decoder_repeatable_and_packed_once(dev):
    """Two launches bitwise equal; the weights packed by the caller
    (pack_decoder from the K-major expansion, as PatchAE prepares them) give
    the kernel's output bit for bit."""
    h2, lat, w3r, b3r, mlp, k = _decoder_case(dev, 515, 16, 128, seed=3)
    a = patch_decoder(h2, lat, w3r, b3r, mlp, k)
    assert torch.equal(a, patch_decoder(h2, lat, w3r, b3r, mlp, k))
    packed = pack_decoder(w3r.t().contiguous(), b3r, mlp)
    assert torch.equal(a, patch_decoder(h2, lat, w3r, b3r, mlp, k, packed=packed))


@pytest.mark.parametrize("case", ["d65", "C1000", "h2_misaligned", "weight_misaligned"])
def test_patch_decoder_rejects_unsupported(dev, case):
    d, C = (65, 1024) if case == "d65" else (16, 1000 if case == "C1000" else 1024)
    h2, lat, w3r, b3r, mlp, k = _decoder_case(dev, 40, d, 16, C=C)
    packed = None
    if case == "h2_misaligned":
        h2 = torch.empty(h2.numel() + 1, device=dev)[1:].view(h2.shape).copy_(h2)
    if case == "weight_misaligned":
        packed = pack_decoder(w3r.t().contiguous(), b3r, mlp)
        w = torch.empty(packed.w_hi.numel() + 1, device=dev)[1:].view(packed.w_hi.shape)
        packed = packed._replace(w_hi=w.copy_(packed.w_hi))
    before = cuda_lib.launches["patch_decoder"]
    with pytest.raises(ValueError):
        patch_decoder(h2, lat, w3r, b3r, mlp, k, packed=packed)
    assert cuda_lib.launches["patch_decoder"] == before


def test_train_step_card_matches_cpu(dev):
    """One train step at the CPU tests' TINY config on the card (FPS,
    encoder and encoder-backward kernels) and on the CPU port (their plain
    versions), from the same weights and FPS starts: loss to 1e-5
    relative, every gradient within 1e-5 of its largest entry on the CPU
    (the step leaves it in .grad), updated parameters to 1e-5."""
    from pcc_tpu_torch.train import build_train_step, create_train_state
    from pcc_tpu_torch.train.state import make_optimizer

    cfg = CodecConfig(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8)
    tx = make_optimizer(1e-3, 0.1, 10, 10)
    states = [create_train_state(0, cfg, tx, device=d) for d in ("cuda", "cpu")]
    rng = np.random.default_rng(5)
    batch = torch.from_numpy((rng.random((2, cfg.N, 3)) * 4 - 1).astype(np.float32))
    starts = torch.tensor([3, 100], dtype=torch.int32)
    step = build_train_step(cfg, tx, rate_mode="reference")
    before = cuda_lib.launches["patch_encoder_bwd"]
    _, card = step(states[0], batch.to(dev), starts.to(dev), 1e-2)
    assert cuda_lib.launches["patch_encoder_bwd"] == before + 1
    _, cpu = step(states[1], batch, starts, 1e-2)
    torch.testing.assert_close(card["loss"].cpu(), cpu["loss"], rtol=1e-5, atol=0)
    for (name, a), (_, b) in zip(states[0].named_parameters(), states[1].named_parameters()):
        err = float((a.grad.cpu() - b.grad).abs().max())
        assert err <= 1e-5 * float(b.grad.abs().max()), name
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=1e-5,
                                   msg=name)


def test_codec_card_streams_match_cpu(dev):
    """.s.bin/.c.bin from the card equal the CPU port's, and the CPU port
    decodes the card's .p.bin to the card encoder's symbols."""
    cfg = CodecConfig(N=1024, N0=256, K=64, d=8)
    ae, prob = init_params(0, cfg)
    card = Codec(cfg, ae, prob, batch_size=4, device="cuda")
    cpu = Codec(cfg, ae, prob, batch_size=4, device="cpu")
    rng = np.random.default_rng(0)
    clouds = [(rng.random((cfg.N, 3)) * 2 - 1).astype(np.float32) for _ in range(2)]
    a, b = card.compress_many(clouds), cpu.compress_many(clouds)
    for (_, sa_, ca), (_, sb, cb) in zip(a, b):
        assert sa_ == sb and ca == cb
    sym = card.encode_batch(np.stack(clouds), np.zeros(2, np.int32)).sym.cpu().numpy()
    from pcc_tpu_torch.coding.octree_host import (codes_to_points,
                                                  parse_octree_bits, unpack_bits)
    recs = np.stack([codes_to_points(*parse_octree_bits(unpack_bits(s)))
                     for _, s, _ in a])
    np.testing.assert_array_equal(cpu.decode_symbols(recs, [p for p, _, _ in a]), sym)


def _stage_layers(g, widths, dev, negative=True, share=0.5):
    """(W, b, mean, mul, bias) per layer with non-trivial BatchNorm
    statistics; with `negative` about `share` of the multipliers are below
    0."""
    out = []
    for a, b in zip(widths[:-1], widths[1:]):
        bound = a ** -0.5
        w = (torch.rand((a, b), generator=g) * 2 - 1) * bound
        bias = (torch.rand(b, generator=g) * 2 - 1) * bound
        mean = (torch.rand(b, generator=g) - 0.5) * 0.2
        mul = torch.rand(b, generator=g) + 0.5
        if negative and share == 0.5:
            mul = mul * (torch.randint(0, 2, (b,), generator=g) * 2 - 1)
        elif negative:
            mul = mul * torch.where(torch.rand(b, generator=g) < share, -1.0, 1.0)
        beta = (torch.rand(b, generator=g) - 0.3) * 0.5
        out.append(tuple(t.to(dev) for t in (w, bias, mean, mul, beta)))
    return out


# (P, S, N, C, nsample, radius, widths after the input): the three stage
# shapes of the PPPF encoder at full width and at the CPU tests' width, an
# odd P, nsample > N, a stage of one narrow layer
_STAGES = [
    (5, 256, 256, 0, 32, 0.2, (3, 64, 64, 128)),
    (3, 128, 256, 128, 64, 0.4, (128, 128, 128, 256)),
    (3, 32, 128, 256, 128, 0.8, (256, 256, 512, 1024)),
    (4, 64, 64, 0, 8, 0.2, (3, 16, 16, 32)),
    (4, 32, 64, 21, 16, 0.4, (24, 16, 32)),
    (7, 8, 32, 37, 32, 0.8, (40, 32, 48)),
    (2, 128, 32, 128, 64, 0.4, (128, 128, 128, 256)),
    (3, 5, 40, 0, 12, 0.3, (7,)),
]


@pytest.mark.parametrize("layout", ["pppf", "pppe"])
@pytest.mark.parametrize("P,S,N,C,nsample,radius,widths", _STAGES)
def test_pppf_sa_stage_kernel(dev, layout, P, S, N, C, nsample, radius, widths):
    """Within 1e-4 of the plain version's largest entry (float32 sums in
    another order; selection and mask are bit-equal), with negative
    BatchNorm multipliers."""
    g = torch.Generator().manual_seed(5)
    xyz = torch.rand((P, N, 3), generator=g).to(dev)
    new_xyz = xyz if S == N else xyz[:, torch.randint(0, N, (S,), generator=g)].contiguous()
    feat = torch.rand((P, N, C), generator=g).to(dev) if C else None
    layers = _stage_layers(g, (C + 3,) + tuple(widths), dev)
    before = cuda_lib.launches["pppf_sa_stage"]
    out = pppf_sa_fused(new_xyz, xyz, feat, layers, nsample=nsample, radius=radius,
                        layout=layout)
    assert cuda_lib.launches["pppf_sa_stage"] == before + 1
    ref = pppf_sa_plain(new_xyz, xyz, feat, layers, nsample=nsample, radius=radius,
                        layout=layout)
    assert out.shape == ref.shape == (P, S, widths[-1])
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_pppf_sa_stage_all_slots_outside_radius(dev):
    """Queries far from every point: each slot reads point 0's row whole, so
    every query of a patch gives that row's activation."""
    g = torch.Generator().manual_seed(6)
    xyz = torch.rand((3, 64, 3), generator=g).to(dev)
    new_xyz = (xyz[:, :16] + 5.0).contiguous()
    feat = torch.rand((3, 64, 20), generator=g).to(dev)
    layers = _stage_layers(g, (23, 32, 64), dev)
    out = pppf_sa_fused(new_xyz, xyz, feat, layers, nsample=16, radius=0.2)
    ref = pppf_sa_plain(new_xyz, xyz, feat, layers, nsample=16, radius=0.2)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(out, out[:, :1].expand_as(out))


def _ulps(got, want):
    """The entries of got that differ from want, and those by more than one ulp."""
    diff = (got - want).abs()
    ulp = torch.nextafter(want.abs(), torch.tensor(float("inf"), device=want.device)) - want.abs()
    return int((diff > 0).sum()), int((diff > ulp).sum())


# (case, P, S, N, C, nsample, radius, widths after the input) for the
# per-point "pppf" kernel: many masked slots (point 0 joins the sets);
# nsample > N (64 of 32 points); nsample = N (sa3 at full width); a quarter
# of the BatchNorm scales negative; one query whose ball holds only point 0
_POINT_CASES = [
    ("masked", 4, 64, 128, 13, 32, 0.08, (32, 64)),
    ("ns_gt_n", 3, 16, 32, 5, 64, 0.5, (16, 16, 24)),
    ("ns_eq_n", 2, 32, 128, 256, 128, 0.8, (256, 256, 512, 1024)),
    ("quarter_negative", 3, 128, 256, 0, 32, 0.2, (64, 64, 128)),
    ("only_point0", 3, 8, 64, 7, 16, 0.05, (16, 32)),
]


@pytest.mark.parametrize("case,P,S,N,C,nsample,radius,widths", _POINT_CASES)
def test_pppf_sa_stage_per_point(dev, case, P, S, N, C, nsample, radius, widths):
    """The "pppf" kernel evaluates each point once and takes each query's
    max over its point set: within 1e-4 of the per-slot plain version's
    largest entry, and bit for bit the per-point replay of its arithmetic
    (stack_replay on the points, then the max over each ball_query set), but
    for at most one ulp where the float64 emulation of a fused multiply-add
    double-rounds; two launches bitwise equal."""
    g = torch.Generator().manual_seed(8)
    xyz = torch.rand((P, N, 3), generator=g)
    new_xyz = xyz[:, torch.randint(0, N, (S,), generator=g)].clone()
    if case == "only_point0":
        # point 0 alone within the radius of query 0
        xyz[:, 1:] += 3 * radius * (xyz[:, 1:] - xyz[:, :1]).sign()
        new_xyz[:, 0] = xyz[:, 0]
    xyz, new_xyz = xyz.to(dev), new_xyz.contiguous().to(dev)
    feat = torch.rand((P, N, C), generator=g).to(dev) if C else None
    layers = _stage_layers(g, (C + 3,) + tuple(widths), dev,
                           share=0.25 if case == "quarter_negative" else 0.5)
    kw = dict(nsample=nsample, radius=radius)
    before = cuda_lib.launches["pppf_sa_stage"]
    out = pppf_sa_fused(new_xyz, xyz, feat, layers, **kw)
    assert cuda_lib.launches["pppf_sa_stage"] == before + 1
    ref = pppf_sa_plain(new_xyz, xyz, feat, layers, **kw)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    differ, beyond = _ulps(out, pppf_sa_points(new_xyz, xyz, feat, layers, replay=True, **kw))
    assert beyond == 0, (differ, beyond)
    assert torch.equal(pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), out)
    if case == "only_point0":
        rows = xyz[:, :1] if feat is None else torch.cat([feat[:, :1], xyz[:, :1]], dim=-1)
        assert torch.equal(out[:, 0], stack_replay(rows, layers)[-1][:, 0])
    if case == "masked":
        assert bool((out[:, 1:] != out[:, :1]).any())


# PPPE's sa2 and sa3 (models/pppe.py): 128 of 512 points with 192
# features, 32 of 128 with 256; nsample 32, radius 0, the "pppe" layout;
# then clouds 100 away from the origin, and sa3's widths without features
_PPPE_STAGES = [(32, 128, 512, 192, (128, 128, 256), 0.0),
                (32, 32, 128, 256, (256, 256, 512), 0.0),
                (5, 128, 512, 192, (128, 128, 256), 0.0), (3, 32, 128, 256, (256, 256, 512), 0.0),
                (5, 128, 512, 192, (128, 128, 256), 100.0), (4, 32, 128, 0, (256, 256, 512), 0.0)]


@pytest.mark.parametrize("P,S,N,C,widths,offset", _PPPE_STAGES)
def test_pppf_sa_stage_kernel_at_pppe_widths(dev, P, S, N, C, widths, offset):
    """The "pppe" layout at PPPE's own widths (195 and 259 input channels,
    not multiples of 4): within 1e-4 of the plain version's largest entry,
    two launches bitwise equal, and its selection bit-equal, read through
    the kernel: with one-hot features of the N points and one identity
    layer each query's output is the indicator of the set of points its
    slots read. Far from the origin the first layer's xyz part still comes
    from the centred coordinates."""
    g = torch.Generator().manual_seed(S)
    xyz = (torch.rand((P, N, 3), generator=g) + offset).to(dev)
    new_xyz = xyz[:, torch.randperm(N, generator=g)[:S]].contiguous()
    feat = torch.randn((P, N, C), generator=g).to(dev) if C else None
    layers = _stage_layers(g, (C + 3,) + tuple(widths), dev, share=0.25)
    kw = dict(nsample=32, radius=0.0, layout="pppe")
    before = cuda_lib.launches["pppf_sa_stage"]
    out = pppf_sa_fused(new_xyz, xyz, feat, layers, **kw)
    assert cuda_lib.launches["pppf_sa_stage"] == before + 1
    ref = pppf_sa_plain(new_xyz, xyz, feat, layers, **kw)
    assert out.shape == ref.shape == (P, S, widths[-1])
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), out)
    W = N + 3
    ident = [(torch.eye(W, device=dev),) + tuple(
        torch.full((W,), v, device=dev) for v in (0.0, 0.0, 1.0, 0.0))]
    onehot = torch.eye(N, device=dev).expand(P, N, N).contiguous()
    picked = pppf_sa_fused(new_xyz, xyz, onehot, ident, **kw)[..., 3:]
    idx = select_nearest(sq_dists(new_xyz, xyz), 32)
    assert torch.equal(picked, torch.zeros_like(picked).scatter_(2, idx, 1.0))


def test_pppe_encoder_card_matches_cpu(dev):
    """The PPPE encoder at full width (N = 8192, latent 256) on two clouds,
    card vs CPU port, with live BatchNorm statistics and the latent head
    spread over the bins: three FPS and two "pppe" stage launches, latents
    within 1e-4 of their largest entry."""
    from pcc_tpu_torch.config import PPPEConfig
    from pcc_tpu_torch.models.pppe import make_pppe_model

    cfg = PPPEConfig()
    models = [make_pppe_model(cfg, seed=3) for _ in range(2)]
    g = torch.Generator().manual_seed(4)
    sd = dict(models[0].state_dict())
    for key in [k for k in sd if k.endswith(".running_mean")]:
        stem, n = key[:-len("running_mean")], sd[key].shape[0]
        sd[stem + "running_mean"] = torch.randn(n, generator=g) * 0.1
        sd[stem + "running_var"] = torch.rand(n, generator=g) + 0.5
        sd[stem + "weight"] = (torch.rand(n, generator=g) + 0.5) * torch.where(
            torch.rand(n, generator=g) < 0.25, -1.0, 1.0)
    sd["encoder.global_conv.3.weight"] = sd["encoder.global_conv.3.weight"] * 60.0
    for m in models:
        m.load_state_dict(sd)
    card = models[0].to(dev)
    x = (torch.rand((2, cfg.N, 3), generator=g) * 3 - 1)
    before = dict(cuda_lib.launches)
    with torch.no_grad():
        lat_card = card.encoder(x.to(dev))[0].cpu()
        lat_cpu = models[1].encoder(x)[0]
    after = dict(cuda_lib.launches)
    assert after["fps"] - before["fps"] == 3
    assert after["pppf_sa_stage"] - before["pppf_sa_stage"] == 2
    assert float((lat_card - lat_cpu).abs().max()) <= 1e-4 * float(lat_cpu.abs().max())


def test_normals_at_eval_batch_size(dev):
    """estimate_normals on 16 clouds of 8192 points, eval_batch's chunk at
    the reference's size (131072 eigenproblems, more than one eigh call
    takes): finite unit normals; the first cloud's against the CPU port,
    |n . n'| above 0.99 for all but a few near-degenerate points."""
    from pcc_tpu_torch.ops.normals import estimate_normals

    g = torch.Generator().manual_seed(8)
    pc = torch.rand((16, 8192, 3), generator=g)
    card = estimate_normals(pc.to(dev)).cpu()
    assert torch.isfinite(card).all()
    torch.testing.assert_close(card.norm(dim=-1), torch.ones(16, 8192), rtol=0, atol=1e-5)
    cos = (card[0] * estimate_normals(pc[:1])[0]).sum(-1).abs()
    assert float((cos < 0.99).float().mean()) <= 1e-3


def test_eval_batch_card_matches_cpu(dev):
    """metrics.eval_batch on the card vs the CPU port: D1 within 1e-3 dB,
    D2 within 0.05 dB (PCA normals from cuSOLVER vs LAPACK, on uniform
    random clouds, whose 30-NN neighbourhoods have no plane and so nearly
    equal small eigenvalues), the uniformity coefficient within 1e-3 and
    the chamfer within 1e-5, relative."""
    from pcc_tpu_torch.metrics import eval_batch

    rng = np.random.default_rng(6)
    origs = rng.random((3, 3000, 3)).astype(np.float32)
    recons = (origs[:, rng.permutation(3000)[:2500]]
              + rng.standard_normal((3, 2500, 3)).astype(np.float32) * 0.01)
    card = eval_batch(origs, recons, chunk=2)
    cpu = eval_batch(origs, recons, chunk=2, device="cpu")
    for a, b in zip(card, cpu):
        assert a["p2point_psnr"] == pytest.approx(b["p2point_psnr"], abs=1e-3)
        assert a["p2plane_psnr"] == pytest.approx(b["p2plane_psnr"], abs=0.05)
        assert a["uc"] == pytest.approx(b["uc"], rel=1e-3)
        assert a["chamfer"] == pytest.approx(b["chamfer"], rel=1e-5)


@pytest.mark.parametrize("case", ["points", "layers", "width", "feat", "layout", "cpu_layer",
                                  "pppe_middle", "pppe_smem"])
def test_pppf_sa_stage_rejects_unsupported(dev, case):
    """pppe_middle: a middle layer past the slot kernel's widest pass (1024
    columns) and past the per-slot kernel's smallest tile (8 rows of both
    activation buffers in shared memory); pppe_smem: a first layer past both
    too (test_pppe_tiles launches the widest of each kernel that fit). No
    launch."""
    g = torch.Generator().manual_seed(7)
    N = 2048 if case == "points" else 32
    xyz = torch.rand((2, N, 3), generator=g).to(dev)
    feat = torch.rand((2, 16 if case == "feat" else N, 5), generator=g).to(dev)
    widths = {"layers": (8,) * 8, "width": (8, 70000), "pppe_middle": (16, 7300, 8),
              "pppe_smem": (7300, 8)}.get(case, (8, 16))
    layers = _stage_layers(g, (8,) + widths, dev)
    if case == "cpu_layer":
        layers[0] = tuple(t.cpu() for t in layers[0])
    layout = "pppe" if case.startswith("pppe") else {"layout": "other"}.get(case, "pppf")
    if layout == "pppe":
        assert pppe_kernel([8, *widths], N, 8, 8) is None
    before = cuda_lib.launches["pppf_sa_stage"]
    with pytest.raises(ValueError):
        pppf_sa_fused(xyz[:, :8].contiguous(), xyz, feat, layers, nsample=8, radius=0.4,
                      layout=layout)
    assert cuda_lib.launches["pppf_sa_stage"] == before


@pytest.mark.parametrize("widths,plan", [((16, 384, 8), (2, 16)), ((16, 1024, 8), (1, 16)),
                                         ((1288, 8), (1, 16)), ((16, 1032, 8), None),
                                         ((1289, 8), None), ((16, 1536, 8), None),
                                         ((16, 7200, 8), None), ((7200, 8), None)])
def test_pppe_tiles(dev, widths, plan):
    """The "pppe" kernel's narrower tiles, as ops/pppf_sa_cuda.py::pppe_plan
    predicts the launcher picks them (a middle layer 384 and 1024 wide; the
    widest first layer whose 32-row tile fits), and past them (plan None: a
    middle layer 1032, 1536 and 7200 wide, a first layer of 1289 and 7200,
    which raised before the per-slot route came back) the per-slot kernel,
    up to the widest whose smallest tile fits (test_pppf_sa_stage_rejects_
    unsupported's pppe cases lie past it): within 1e-4 of the plain
    version's largest entry, two launches bitwise equal."""
    g = torch.Generator().manual_seed(8)
    xyz = torch.rand((2, 32, 3), generator=g).to(dev)
    feat = torch.rand((2, 32, 5), generator=g).to(dev)
    layers = _stage_layers(g, (8,) + widths, dev)
    got = pppe_plan([8, *widths], 32, 8, 8)
    assert pppe_kernel([8, *widths], 32, 8, 8) == ("slots" if plan else "per_slot")
    assert (got and (got["wm"], got["nt"])) == plan
    kw = dict(nsample=8, radius=0.0, layout="pppe")
    new_xyz = xyz[:, :8].contiguous()
    out = pppf_sa_fused(new_xyz, xyz, feat, layers, **kw)
    ref = pppf_sa_plain(new_xyz, xyz, feat, layers, **kw)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), out)


def _bwd_flat(dxyz, dfeat, dl):
    return [dxyz] + ([] if dfeat is None else [dfeat]) + [t for lay in dl for t in lay]


# (P, S, N, C, nsample, radius, widths after the input, ties): the three
# PPPF-AE stages at full width, the CPU tests' widths, nsample > N, most
# slots beyond the radius, exact ties between distinct points (every point
# duplicated; or features duplicated and the first layer blind to xyz, so
# that equal activations lie at different distances, where the first
# winner in selection order depends on the slots' order even with
# nsample = N), more patches than one block's tile holds, one narrow layer
_BWD_STAGES = [
    (5, 256, 256, 0, 32, 0.2, (3, 64, 64, 128), None),
    (3, 128, 256, 128, 64, 0.4, (128, 128, 128, 256), None),
    (3, 32, 128, 256, 128, 0.8, (256, 256, 512, 1024), None),
    (4, 64, 64, 0, 8, 0.2, (3, 16, 16, 32), None),
    (4, 32, 64, 21, 16, 0.4, (24, 16, 32), None),
    (2, 128, 32, 128, 64, 0.4, (128, 128, 128, 256), None),
    (3, 16, 64, 20, 16, 0.05, (32, 64), None),
    (4, 32, 64, 21, 16, 0.4, (24, 16, 32), "twins"),
    (3, 16, 32, 6, 32, 2.0, (16, 24), "blind"),
    (40, 16, 64, 5, 16, 0.3, (16, 24), None),
    (3, 5, 40, 0, 12, 0.3, (7,), None),
]


@pytest.mark.parametrize("P,S,N,C,nsample,radius,widths,ties", _BWD_STAGES)
def test_pppf_sa_stage_bwd_kernel(dev, P, S, N, C, nsample, radius, widths, ties):
    """Every output within 1e-4 of the plain version's largest entry
    (float32 sums in another order; both route each max to the first slot on
    the same replayed activations), two launches bitwise equal, and the
    autograd Function on the kernels."""
    from pcc_tpu_torch.ops.pppf_sa_cuda import pppf_sa_trainable

    g = torch.Generator().manual_seed(8)
    xyz = torch.rand((P, N, 3), generator=g)
    feat = torch.rand((P, N, C), generator=g) if C else None
    if ties == "twins":
        xyz[:, N // 2:] = xyz[:, :N // 2]
    if ties is not None and feat is not None:
        feat[:, N // 2:] = feat[:, :N // 2]
    xyz = xyz.to(dev)
    feat = None if feat is None else feat.to(dev)
    new_xyz = xyz if S == N else xyz[:, torch.randint(0, N, (S,), generator=g)].contiguous()
    layers = _stage_layers(g, (C + 3,) + tuple(widths), dev)
    if ties == "blind":
        layers[0][0][C:] = 0.0
    gout = torch.randn((P, S, widths[-1]), generator=g).to(dev)
    before = cuda_lib.launches["pppf_sa_stage_bwd"]
    a = _bwd_flat(*pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, nsample=nsample,
                               radius=radius))
    assert cuda_lib.launches["pppf_sa_stage_bwd"] == before + 1
    b = _bwd_flat(*pppf_sa_bwd_plain(new_xyz, xyz, feat, gout, layers, nsample=nsample,
                                     radius=radius))
    assert float(b[1 if ties == "blind" else 0].abs().max()) > 0   # blind: dxyz is 0
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())
    again = _bwd_flat(*pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, nsample=nsample,
                                   radius=radius))
    assert all(torch.equal(x, y) for x, y in zip(a, again))

    x = xyz.clone().requires_grad_(True)
    lays = [tuple(t.clone().requires_grad_(True) for t in lay) for lay in layers]
    out = pppf_sa_trainable(x if S == N else new_xyz, x, feat, lays, nsample=nsample,
                            radius=radius)
    assert torch.equal(out, pppf_sa_fused(new_xyz, xyz, feat, layers, nsample=nsample,
                                          radius=radius))
    out.backward(gout)
    assert torch.equal(x.grad, a[0])
    assert torch.equal(lays[-1][4].grad, a[-1]) and lays[0][2].grad is None


# (case, P, S, N, C, nsample, radius, widths after the input) where the
# backward's tiles are stressed: P * N rows not a multiple of any tile (the
# backward's 16 / 32 / 64 rows, the weight gradient's 32-row stages and its
# splits); cin = 3; widths that are not multiples of 4 or 8; nsample >= N;
# every slot outside the radius; exact ties between twin points; widths
# over several 64-wide weight-gradient tiles with a ragged last one
_BWD_TILING = [
    ("odd_rows", 3, 12, 37, 5, 16, 0.5, (24, 40)),
    ("cin3", 5, 24, 50, 0, 12, 0.3, (64, 64, 72)),
    ("odd_widths", 3, 16, 48, 6, 8, 0.4, (13, 7, 21)),
    ("ns_ge_n", 4, 8, 24, 2, 32, 0.6, (20, 12)),
    ("outside", 3, 16, 64, 20, 16, 0.2, (32, 48)),
    ("twins", 4, 32, 64, 21, 16, 0.4, (24, 16, 33)),
    ("wide", 6, 32, 128, 131, 32, 0.8, (140, 70, 200)),
]


@pytest.mark.parametrize("case,P,S,N,C,nsample,radius,widths", _BWD_TILING)
def test_pppf_sa_stage_bwd_tiling(dev, case, P, S, N, C, nsample, radius, widths):
    """Every output within 1e-4 of the plain version's largest entry and two
    launches bitwise equal, where the tensor-core tiles, the split-K sums
    and the routing's channel chunks have ragged edges; the forward's store
    mode leaves its output and the backward bit for bit. With every slot
    outside the radius, all slots read point 0, so no other point gets a
    gradient."""
    g = torch.Generator().manual_seed(10)
    xyz = torch.rand((P, N, 3), generator=g)
    feat = torch.rand((P, N, C), generator=g) if C else None
    if case == "twins":
        xyz[:, N // 2:] = xyz[:, :N // 2]
        feat[:, N // 2:] = feat[:, :N // 2]
    new_xyz = xyz[:, torch.randint(0, N, (S,), generator=g)].clone()
    if case == "outside":
        new_xyz += 5.0
    xyz, new_xyz = xyz.to(dev), new_xyz.contiguous().to(dev)
    feat = None if feat is None else feat.to(dev)
    layers = _stage_layers(g, (C + 3,) + tuple(widths), dev)
    gout = torch.randn((P, S, widths[-1]), generator=g).to(dev)
    kw = dict(nsample=nsample, radius=radius)
    before = cuda_lib.launches["pppf_sa_stage_bwd"]
    out = pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, **kw)
    assert cuda_lib.launches["pppf_sa_stage_bwd"] == before + 1
    a = _bwd_flat(*out)
    b = _bwd_flat(*pppf_sa_bwd_plain(new_xyz, xyz, feat, gout, layers, **kw))
    assert float(b[0].abs().max()) > 0
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())
    again = _bwd_flat(*pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, **kw))
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    # the forward's store mode: the same output, and the backward on what it
    # stored the same as the one that selects and replays
    fwd, saved = pppf_sa_fused(new_xyz, xyz, feat, layers, save=True, **kw)
    assert saved is not None
    assert torch.equal(fwd, pppf_sa_fused(new_xyz, xyz, feat, layers, **kw))
    stored = _bwd_flat(*pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, saved=saved, **kw))
    assert all(torch.equal(x, y) for x, y in zip(a, stored))
    if case == "outside":
        assert not bool(out[0][:, 1:].any()) and not bool(out[1][:, 1:].any())


@pytest.mark.parametrize("case", ["points", "layers", "cotangent", "cpu_layer", "wide"])
def test_pppf_sa_stage_bwd_rejects_unsupported(dev, case):
    g = torch.Generator().manual_seed(9)
    N = 2048 if case == "points" else 32
    xyz = torch.rand((2, N, 3), generator=g).to(dev)
    widths = {"layers": (8,) * 8, "wide": (8, 8000, 8000)}.get(case, (8, 16))
    layers = _stage_layers(g, (3,) + widths, dev)
    if case == "cpu_layer":
        layers[0] = tuple(t.cpu() for t in layers[0])
    cout = 15 if case == "cotangent" else widths[-1]
    gout = torch.zeros((2, 8, cout), device=dev)
    with pytest.raises(ValueError):
        pppf_sa_bwd(xyz[:, :8].contiguous(), xyz, None, gout, layers, nsample=8, radius=0.4)


def _chamfer_pair(g, P, k, K, case, dev):
    """Clouds x [P, k, 3], y [P, K, 3]: random; "ties": y's second half
    repeats its first, and x's first points sit on repeated keys; "self":
    y is x, each odd point one float32 step from the even one before it,
    so that expansions of a pair fall on either side of 0; "hub": y's first
    point at the origin, the rest at least 10 away, x within 1 of it, so
    that every point of x gathers at y's point 0."""
    x = torch.rand((P, k, 3), generator=g) * 2 - 1
    y = torch.rand((P, K, 3), generator=g) * 2 - 1
    if case == "ties":
        y[:, K // 2:] = y[:, :K // 2]
        x[:, :4] = y[:, K // 2:K // 2 + 4]
    elif case == "self":
        x = x + 3.0
        x[:, 1::2] = torch.nextafter(x[:, 0:k - 1:2], torch.tensor(float("inf")))
        y = x.clone()
    elif case == "hub":
        x = x * 0.5
        y = y + 12.0
        y[:, 0] = 0.0
    return x.to(dev), y.to(dev)


# (P, k, K, case): k * K = 2^19, k = 8 against 65536 keys, tied keys, an
# identical cloud, ragged tiles; the N = 8192 shapes (the candidate side in
# several chunks, merged), a candidate side that splits unevenly (8192 + 37),
# ties across chunks (y's halves 4133 apart), an identical cloud of 8229
# points, and one point of y gathered by all 16384 points of x (the
# backward's longest segment)
_CHAMFER = [(4, 512, 1024, "random"), (2, 8, 65536, "random"), (3, 1024, 512, "ties"),
            (5, 256, 256, "self"), (33, 8, 16, "random"), (7, 100, 37, "random"),
            (2, 8192, 16384, "random"), (2, 700, 8229, "random"), (2, 1300, 8266, "ties"),
            (1, 8229, 8229, "self"), (2, 16384, 8192, "hub")]


@pytest.mark.parametrize("P,k,K,case", _CHAMFER)
def test_chamfer_fwd_kernel(dev, P, k, K, case):
    """Indices bit-equal to the plain version, distances to float32
    rounding; with the launcher's plan."""
    g = torch.Generator().manual_seed(20)
    x, y = _chamfer_pair(g, P, k, K, case, dev)
    from pcc_tpu_torch.ops.chamfer_cuda import chamfer_fwd, chamfer_fwd_plain

    before = cuda_lib.launches["chamfer_fwd"]
    got = chamfer_fwd(x, y)
    assert cuda_lib.launches["chamfer_fwd"] == before + 1
    want = chamfer_fwd_plain(x, y)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    if case == "hub":
        assert bool((got[2] == 0).all())


@pytest.mark.parametrize("P,k,K,case", [(2, 700, 8229, "random"), (3, 1024, 512, "ties"),
                                        (1, 1100, 1100, "self")])
def test_chamfer_fwd_every_plan(dev, P, k, K, case):
    """Every (queries per thread, chunk) the forward takes: each plan's
    outputs bit for bit the launcher's, the indices the plain version's."""
    from pcc_tpu_torch.ops.chamfer_cuda import candidate_plans, chamfer_fwd, chamfer_fwd_plain

    g = torch.Generator().manual_seed(24)
    x, y = _chamfer_pair(g, P, k, K, case, dev)
    ref = chamfer_fwd(x, y)
    want = chamfer_fwd_plain(x, y)
    assert torch.equal(ref[2], want[2]) and torch.equal(ref[3], want[3])
    plans = candidate_plans(P, k, K)
    assert len(plans) > 1
    for plan in plans:
        got = chamfer_fwd(x, y, plan=plan)
        assert all(torch.equal(u, v) for u, v in zip(got, ref)), plan


@pytest.mark.parametrize("P,k,K,case", _CHAMFER)
def test_chamfer_bwd_kernel(dev, P, k, K, case):
    """dx, dy within 1e-5 of the plain version's largest entry (its
    scatter sums with atomics, in another order); two launches bitwise
    equal; chamfer_min_dists launches each kernel once and its backward is
    the kernel."""
    from pcc_tpu_torch.ops.chamfer_cuda import (chamfer_bwd, chamfer_bwd_plain, chamfer_fwd,
                                                chamfer_min_dists)

    g = torch.Generator().manual_seed(21)
    x, y = _chamfer_pair(g, P, k, K, case, dev)
    _, _, ixy, iyx = chamfer_fwd(x, y)
    gx = torch.randn((P, k), generator=g).to(dev)
    gy = torch.randn((P, K), generator=g).to(dev)
    a = chamfer_bwd(x, y, ixy, iyx, gx, gy)
    for u, v in zip(a, chamfer_bwd_plain(x, y, ixy, iyx, gx, gy)):
        assert float((u - v).abs().max()) <= 1e-5 * float(v.abs().max())
    again = chamfer_bwd(x, y, ixy, iyx, gx, gy)
    assert all(torch.equal(u, v) for u, v in zip(a, again))
    xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    before = dict(cuda_lib.launches)
    dists = chamfer_min_dists(xr, yr)
    assert cuda_lib.launches["chamfer_fwd"] == before["chamfer_fwd"] + 1
    torch.autograd.backward(dists, [gx, gy])
    assert cuda_lib.launches["chamfer_bwd"] == before["chamfer_bwd"] + 1
    assert torch.equal(xr.grad, a[0]) and torch.equal(yr.grad, a[1])


def test_chamfer_bwd_sums_in_ascending_order(dev):
    """Each point's gathers are summed in ascending order of the gathering
    point, from zero, one rounding per operation: bit for bit a float32
    running sum in that order, with every point of x gathered at y's point
    0 (one segment of 4000 terms) and x's own nearest points random."""
    from pcc_tpu_torch.ops.chamfer_cuda import chamfer_bwd

    g = torch.Generator().manual_seed(25)
    P, k, K = 1, 4000, 600
    x, y = _chamfer_pair(g, P, k, K, "hub", dev)
    ixy = torch.zeros((P, k), dtype=torch.int32, device=dev)
    iyx = torch.randint(0, k, (P, K), generator=g, dtype=torch.int32).to(dev)
    gx = torch.randn((P, k), generator=g).to(dev)
    gy = torch.randn((P, K), generator=g).to(dev)
    _, dy = chamfer_bwd(x, y, ixy, iyx, gx, gy)
    e = (2.0 * (x[0] - y[0, 0])) * gx[0, :, None]            # [k, 3], the gathers at y0
    acc = torch.zeros(3, device=dev)
    for j in range(k):
        acc = acc + e[j]
    direct = (2.0 * (y[0, 0] - x[0, iyx[0, 0].long()])) * gy[0, 0]
    assert torch.equal(dy[0, 0], direct - acc)


@pytest.mark.parametrize("case", ["few", "many", "clouds", "dtype", "strided", "cpu_y",
                                  "cotangent"])
def test_chamfer_kernels_reject_unsupported(dev, case):
    """Outside the kernels' domain (fewer than 8 points, more than
    MAX_POINTS), unequal cloud counts, float64, non-contiguous, mixed
    devices, a wrong cotangent: the wrappers raise."""
    from pcc_tpu_torch.ops.chamfer_cuda import MAX_POINTS, chamfer_bwd, chamfer_fwd

    k, K = {"few": (7, 64), "many": (8, MAX_POINTS + 1)}.get(case, (16, 32))
    P = 1 if case == "many" else 2
    x, y = torch.rand((P, k, 3), device=dev), torch.empty((P, K, 3), device=dev)
    if case == "clouds":
        y = y[:1]
    elif case == "dtype":
        x = x.double()
    elif case == "strided":
        x = torch.rand((2, 3, k), device=dev).transpose(1, 2)
    elif case == "cpu_y":
        y = y.cpu()
    with pytest.raises(ValueError):
        if case == "cotangent":
            ixy = torch.zeros((2, k), dtype=torch.int32, device=dev)
            iyx = torch.zeros((2, K), dtype=torch.int32, device=dev)
            chamfer_bwd(x, y, ixy, iyx, torch.zeros((2, k + 1), device=dev),
                        torch.zeros((2, K), device=dev))
        else:
            chamfer_fwd(x, y)


@pytest.mark.parametrize("P,N,knn", [(5, 32, 8), (5, 32, 16), (64, 256, 16), (64, 256, 8),
                                     (6, 1024, 16), (4, 1024, 8)])
def test_sa_fused_kernel(dev, P, N, knn):
    """Features within 1e-5 of the plain version; SetAbstraction(fused=True)
    launches the kernel."""
    from pcc_tpu_torch.models.layers import SetAbstraction
    from pcc_tpu_torch.ops.sa_cuda import sa_fused, sa_fused_plain

    g = torch.Generator().manual_seed(22)
    pts = ((torch.rand((P, N, 3), generator=g) * 2 - 1) * 0.4).to(dev)
    sa = _wb(g, [3, 32, 64, 128], dev)
    out = sa_fused(pts, sa, knn)
    torch.testing.assert_close(out, sa_fused_plain(pts, sa, knn), atol=1e-5, rtol=0)
    assert torch.equal(sa_fused(pts, sa, knn), out)
    module = SetAbstraction(knn=knn, fused=True).to(dev)
    with torch.no_grad():
        for conv, (w, b) in zip(module.convs(), sa):
            conv.weight.copy_(w.t().reshape(conv.weight.shape))
            conv.bias.copy_(b)
        before = cuda_lib.launches["sa_fused"]
        assert torch.equal(module(pts), out)
    assert cuda_lib.launches["sa_fused"] == before + 1


@pytest.mark.parametrize("N,knn,widths", [(24, 8, (32, 64, 128)), (32, 12, (32, 64, 128)),
                                          (1040, 16, (32, 64, 128)), (32, 8, (32, 64, 64)),
                                          (32, 8, (32, 64, 128, "grad"))])
def test_sa_fused_rejects_unsupported(dev, N, knn, widths):
    from pcc_tpu_torch.ops.sa_cuda import sa_fused

    g = torch.Generator().manual_seed(23)
    pts = torch.rand((2, N, 3), generator=g).to(dev)
    want_grad = widths[-1] == "grad"
    sa = _wb(g, [3] + [w for w in widths if w != "grad"], dev)
    if want_grad:
        sa[0][0].requires_grad_(True)
    with pytest.raises(RuntimeError if want_grad else ValueError):
        sa_fused(pts, sa, knn)


@pytest.mark.parametrize("N,d_a", [(2048, 16), (8192, 8)])
def test_attr_codec_card_vs_cpu(dev, N, d_a):
    """The attribute codec (attrib.AttrCodec) on the card and on the CPU
    port, same weights and coloured clouds: .s.bin and .c.bin byte-equal,
    each decodes the other's .p.bin and .a.bin to the encoded symbols,
    decoded clouds within 1e-5 of their extent and colours within one
    level; one compress and one decompress batch launch fps and
    patch_encoder, then patch_decoder, once each."""
    from pcc_tpu_torch.attrib import AttrCodec, init_attr_params

    cfg = CodecConfig(N=N)
    ae_sd, prob_sd = init_params(3, cfg)
    attr_sd, attr_prob_sd = init_attr_params(4, cfg, d_a)
    params = {"ae": ae_sd, "prob": prob_sd, "attr": attr_sd, "attr_prob": attr_prob_sd}
    rng = np.random.default_rng(5)
    pcs = [(rng.random((N, 3)) * 2 - 1).astype(np.float32) for _ in range(2)]
    rgbs = [np.clip((0.5 + 0.4 * np.sin(2 * p)) * 255, 0, 255).astype(np.uint8) for p in pcs]
    card = AttrCodec(cfg, params, d_a=d_a, device="cuda")
    cpu = AttrCodec(cfg, params, d_a=d_a, device="cpu")
    before = dict(cuda_lib.launches)
    c_streams = card.compress_many(pcs, rgbs)
    c_out = card.decompress_many(c_streams)
    assert {k: cuda_lib.launches[k] - before[k] for k in before
            if cuda_lib.launches[k] != before[k]} == dict(fps=1, patch_encoder=1,
                                                          patch_decoder=1)
    p_streams = cpu.compress_many(pcs, rgbs)
    for (_, cs, cc, _), (_, ps, pc_, _) in zip(c_streams, p_streams):
        assert cs == ps and cc == pc_
    p_out = cpu.decompress_many(c_streams)
    for (a, ra), (b, rb) in zip(c_out, p_out):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
        assert np.abs(ra.astype(int) - rb.astype(int)).max() <= 1
    # each side decodes the other's streams to the symbols the other encoded
    from pcc_tpu_torch.coding.octree_host import codes_to_points, parse_octree_bits, unpack_bits

    for enc, dec, streams in ((card, cpu, c_streams), (cpu, card, p_streams)):
        res = enc.encode_batch(np.stack(pcs), np.stack(rgbs), np.zeros(2, np.int32))
        recs = np.stack([codes_to_points(*parse_octree_bits(unpack_bits(s[1])))
                         for s in streams])
        sym, asym = dec.decode_symbols(recs, [s[0] for s in streams], [s[3] for s in streams])
        np.testing.assert_array_equal(sym, res.sym.cpu().numpy())
        np.testing.assert_array_equal(asym, res.asym.cpu().numpy())


def test_pppe_train_step_card_vs_cpu(dev, record_property):
    """One PPPE train step (train/steps_pppe.py) on the card and on the CPU
    port from the same seeded weights and clouds: fps 2 (sa2, sa3: at N =
    512 sa1's centroids are the points), chamfer_fwd and chamfer_bwd once;
    loss to 1e-5 relative, the decoder's gradients within 3e-3 of each
    tensor's largest entry, the encoder's (through batch statistics) within
    0.15 (5.5e-2 measured on an H100 on these uniform clouds, on sa3's
    second layer's weight: about 3x, as chip_smoke.py's bounds; its phase
    22 reads 2.7e-3 on its synthetic clouds and holds them to 2e-2),
    parameters within lr / 4 where the gradient's rounding cannot have
    turned Adam's first update (chip_smoke.py::compare_train_states' rule);
    a NaN batch leaves the card's state bit for bit. The encoder's largest
    relative difference goes into the junit XML as encoder_grad_rel_err."""
    from pcc_tpu_torch.config import PPPEConfig
    from pcc_tpu_torch.train.steps_pppe import (build_pppe_train_step, create_pppe_state,
                                                make_pppe_optimizer)

    cfg = PPPEConfig(N=512, latent_dim=32)
    tx = make_pppe_optimizer(1e-3)
    x = torch.from_numpy(np.random.default_rng(6).random((2, cfg.N, 3)).astype(np.float32))
    card, cpu = (create_pppe_state(0, cfg, tx, device=d) for d in ("cuda", "cpu"))
    step = build_pppe_train_step(tx)
    before = dict(cuda_lib.launches)
    _, a = step(card, x.to(dev), 1e-2)
    torch.cuda.synchronize()
    assert {k: cuda_lib.launches[k] - before[k] for k in before
            if cuda_lib.launches[k] != before[k]} == dict(fps=2, chamfer_fwd=1, chamfer_bwd=1)
    _, b = step(cpu, x, 1e-2)
    assert abs(float(a["loss"]) - float(b["loss"])) <= 1e-5 * abs(float(b["loss"]))
    named = list(cpu.model.named_parameters())
    top = max(float(q.grad.abs().max()) for _, q in named if q.grad is not None)
    enc = {}
    for (name, p), (_, q) in zip(card.model.named_parameters(), named):
        if q.grad is None:
            assert p.grad is None
            continue
        err, big = float((p.grad.cpu() - q.grad).abs().max()), float(q.grad.abs().max())
        if big < 1e-3 * top:                # zero in exact arithmetic
            assert err <= 1e-3 * top, name
            continue
        if name.startswith("encoder."):
            enc[name] = err / big
        else:
            assert err <= 3e-3 * big, name
        sure = (q.grad.abs() > 1e-3 * big) & (q.grad.abs() > 2 * (p.grad.cpu() - q.grad).abs())
        assert float((p.detach().cpu() - q.detach())[sure].abs().max()) <= 1e-3 / 4, name
    worst = max(enc, key=enc.get)
    record_property("encoder_grad_rel_err", f"{enc[worst]:.4g} ({worst})")
    assert enc[worst] <= 0.15, (worst, enc[worst])
    saved = [t.clone() for t in (card.params, card.stats, card.mu, card.nu, card.count)]
    bad = x.clone()
    bad[0, 3, 1] = float("nan")
    _, aux = step(card, bad.to(dev), 1e-2)
    assert bool(aux["skipped"])
    for s, t in zip(saved, (card.params, card.stats, card.mu, card.nu, card.count)):
        assert torch.equal(s, t)


# ----------------------------------------------------- the bf16 instances --

BF16_SHARE = 0.95         # entries bit-equal to the plain version at least
BF16_TOL = 2.0 ** -7      # of the output's largest |entry|


def _hold_bf16(out, ref):
    """The bf16 kernels against their plain versions: at least BF16_SHARE
    of the entries bit-equal (float32 sums in another order move a bf16
    rounding now and then), every entry within BF16_TOL of the largest
    |entry|, every entry bf16-exact."""
    assert out.shape == ref.shape
    assert torch.equal(out.to(torch.bfloat16).float(), out)
    assert float((out == ref).double().mean()) >= BF16_SHARE
    assert float((out - ref).abs().max()) <= BF16_TOL * float(ref.abs().max())


def _enc_replay(pts, sa, pn, knn):
    """The bf16 encoder's latents by the replay of its k-order arithmetic
    (_kernel_choices in bf16) on at most REPLAY patches."""
    p = pts[:REPLAY]
    rows = torch.arange(p.shape[1], device=p.device).expand(p.shape[:2]).contiguous()
    return _enc_choices(p, select_nearest(sq_dists(p, p), knn), rows, sa, pn,
                        bf16=True)[-1].amax(dim=1)


def _calibrated(pts, sa, pn, knn):
    """pn with its last layer scaled and shifted per channel so that the
    float32 latents over these patches have mean 0 and spread 1.5, as
    chip_smoke.py::spread_symbols calibrates it (about 5000x at the path's
    weights): nearly every sum of that layer cancels."""
    z = patch_encoder(pts, sa, pn, knn)
    scale = 1.5 / z.std(dim=0)
    w, b = pn[-1]
    return pn[:-1] + [(w * scale, (b - z.mean(dim=0)) * scale)]


REPLAY = 64   # patches the bf16 kernels are replayed on, bit for bit


# (P, N, knn, D): tiny, a ragged patch count, the path's patches and widths
@pytest.mark.parametrize("P,N,knn,D", [(5, 32, 8, 4), (37, 256, 16, 16), (4096, 256, 16, 16)])
def test_patch_encoder_bf16_kernel(dev, P, N, knn, D):
    """The bf16 encoder: held to its plain version (_hold_bf16), to the
    replay of its arithmetic (_kernel_choices in bf16) on 16 patches, and two
    launches bitwise equal; bit for bit that replay on up to REPLAY patches
    (its products on the tensor cores, certified), also with the last layer
    calibrated."""
    g = torch.Generator().manual_seed(21)
    pts = ((torch.rand((P, N, 3), generator=g) * 2 - 1) * 0.4).to(dev)
    # the bf16 encoder's weights: bf16 values (as PatchAE.encoder_weights
    # keeps them)
    sa = bf16_wb(_wb(g, [3, 32, 64, 128], dev))
    pn = bf16_wb(_wb(g, [131, 128, 256, 512, D], dev))
    before = dict(cuda_lib.launches)
    out = patch_encoder(pts, sa, pn, knn, bf16=True)
    assert cuda_lib.launches["patch_encoder_bf16"] == before["patch_encoder_bf16"] + 1
    assert cuda_lib.launches["patch_encoder"] == before["patch_encoder"]
    _hold_bf16(out, patch_encoder_plain(pts, sa, pn, knn, bf16=True))
    p = pts[:16]
    rows = torch.arange(N, device=dev).expand(p.shape[:2]).contiguous()
    replay = _enc_choices(p, select_nearest(sq_dists(p, p), knn), rows, sa, pn,
                          bf16=True)[-1].amax(dim=1)
    assert float((out[:16] == replay).double().mean()) >= 0.999
    assert torch.equal(patch_encoder(pts, sa, pn, knn, bf16=True), out)
    assert torch.equal(out[:REPLAY], _enc_replay(pts, sa, pn, knn))
    pn_cal = bf16_wb(_calibrated(pts, sa, pn, knn))
    cal = patch_encoder(pts, sa, pn_cal, knn, bf16=True)
    assert torch.equal(cal[:REPLAY], _enc_replay(pts, sa, pn_cal, knn))


@pytest.mark.parametrize("P,N,knn,D", [(512, 256, 16, 16), (16, 256, 16, 16), (5, 32, 8, 4)])
def test_patch_encoder_bf16_winners(dev, P, N, knn, D):
    """The bf16 encoder with its winners (bf16 training): one launch, its
    latent bit for bit the serving instance's on the rounded weights, its
    winners those of the backward's replay (float32 biases) bit for bit
    the plain version's, two launches bitwise equal; the latent bit for bit
    the replay of its arithmetic, and the same with the last layer
    calibrated."""
    g = torch.Generator().manual_seed(25)
    pts = ((torch.rand((P, N, 3), generator=g) * 2 - 1) * 0.4).to(dev)
    sa, pn = _wb(g, [3, 32, 64, 128], dev), _wb(g, [131, 128, 256, 512, D], dev)
    before = dict(cuda_lib.launches)
    lat, win = patch_encoder(pts, sa, pn, knn, return_winners=True, bf16=True)
    assert cuda_lib.launches["patch_encoder_bf16"] == before["patch_encoder_bf16"] + 1
    assert torch.equal(lat, patch_encoder(pts, bf16_wb(sa), bf16_wb(pn), knn, bf16=True))
    p = slice(0, min(P, 32))
    plain_lat, plain_win = patch_encoder_plain(pts[p], sa, pn, knn, return_winners=True,
                                               bf16=True)
    assert torch.equal(win[p], plain_win)
    _hold_bf16(lat[p], plain_lat)
    again = patch_encoder(pts, sa, pn, knn, return_winners=True, bf16=True)
    assert torch.equal(again[0], lat) and torch.equal(again[1], win)
    assert torch.equal(lat[:REPLAY], _enc_replay(pts, bf16_wb(sa), bf16_wb(pn), knn))
    pn_cal = _calibrated(pts, sa, pn, knn)
    lat, win = patch_encoder(pts, sa, pn_cal, knn, return_winners=True, bf16=True)
    assert torch.equal(lat[:REPLAY], _enc_replay(pts, bf16_wb(sa), bf16_wb(pn_cal), knn))
    assert torch.equal(win[p], patch_encoder_plain(pts[p], sa, pn_cal, knn, return_winners=True,
                                                   bf16=True)[1])


# the bf16 backward kernel against its plain version, of each output's
# largest entry: tests/test_torch_port_train_bf16.py's TOL_ENC (float32 sums
# in another order, which now and then moves one bf16 rounding of a
# cotangent; measured 1.9e-4 at [6, 32, 3], 3.2e-6 at [512, 256, 3])
TOL_BWD_BF16 = 2.0 ** -11


@pytest.mark.parametrize("P,N,knn,D", [(512, 256, 16, 16), (6, 32, 8, 8), (5, 48, 16, 4)])
def test_patch_encoder_bwd_bf16_kernel(dev, P, N, knn, D):
    """The bf16 backward (patch_encoder_bwd_bf16) on the bf16 forward's
    winners: one launch of its own counter, every output within
    TOL_BWD_BF16 of the plain version's largest entry, two launches
    bitwise equal; without winners the wrapper takes them from one launch
    of the bf16 forward, and the outputs are the same bit for bit."""
    g = torch.Generator().manual_seed(26)
    pts = ((torch.rand((P, N, 3), generator=g) * 2 - 1) * 0.4).to(dev)
    sa, pn = _wb(g, [3, 32, 64, 128], dev), _wb(g, [131, 128, 256, 512, D], dev)
    cot = torch.randn((P, D), generator=g).to(dev)
    _, win = patch_encoder(pts, sa, pn, knn, return_winners=True, bf16=True)
    before = dict(cuda_lib.launches)
    out = patch_encoder_bwd(pts, cot, sa, pn, knn, winners=win, bf16=True)
    assert cuda_lib.launches["patch_encoder_bwd_bf16"] == before["patch_encoder_bwd_bf16"] + 1
    assert cuda_lib.launches["patch_encoder_bwd"] == before["patch_encoder_bwd"]
    ref = patch_encoder_bwd_plain(pts, cot, sa, pn, knn, winners=win, bf16=True)
    flat = lambda o: [o[0]] + [t for wb in list(o[1]) + list(o[2]) for t in wb]  # noqa: E731
    for a, b in zip(flat(out), flat(ref)):
        assert float((a - b).abs().max()) <= TOL_BWD_BF16 * float(b.abs().max())
    again = patch_encoder_bwd(pts, cot, sa, pn, knn, winners=win, bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(flat(out), flat(again)))
    found = patch_encoder_bwd(pts, cot, sa, pn, knn, bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(flat(out), flat(found)))


@pytest.mark.parametrize("shape", [(1, 512, 128), (512, 128, 128), (512, 128, 3), (8, 64, 512),
                                   (1, 64, 2048), (32, 16, 3), (1, 100, 5), (100, 7, 5),
                                   (1, 1, 7), (33, 33, 2), (4, 128, 32, 16), (3, 40, 50, 8),
                                   (8, 32, 128, 64), (300, 5)])
def test_bf16_reduce_kernel(dev, shape):
    """bf16_reduce (XLA's bf16 reduction tree) bit for bit its plain
    version, one launch a level, on grids of one to three dimensions."""
    from pcc_tpu_torch.ops.bf16 import _reduce_level, bf16_reduce, bf16_reduce_plain

    g = torch.Generator().manual_seed(27)
    x = round_bf16(torch.randn(shape, generator=g)).to(dev)
    levels, dims = 0, shape[:-1]
    while int(np.prod(dims)) > 1:
        dims = tuple(n for w, p, n in _reduce_level(dims))
        levels += 1
    before = cuda_lib.launches["bf16_reduce"]
    out = bf16_reduce(x)
    assert cuda_lib.launches["bf16_reduce"] == before + levels
    assert torch.equal(out.cpu(), bf16_reduce_plain(x.cpu()))


# tiles are 128 patch rows x 2 points: the path's shape; P past a tile,
# one row; k odd (a tile's second point past k) and one point; d below one
# k16 step, the most
@pytest.mark.parametrize("P,d,k", [(9, 4, 16), (129, 16, 128), (4096, 16, 128), (4100, 4, 127),
                                   (300, 64, 3), (1, 16, 1)])
def test_patch_decoder_bf16_kernel(dev, P, d, k):
    """The bf16 decoder (.bf16 wgmma, h2 and the expansion weights from
    shared memory) on its own weight layout: held to its plain version, two
    launches bitwise equal; the float32 layout or instance is refused."""
    h2, lat, w3r, b3r, mlp, k = _decoder_case(dev, P, d, k, seed=22)
    packed = pack_decoder(w3r.t().contiguous(), b3r, mlp, bf16=True)
    assert packed.bf16 and packed.w_lo is packed.w_hi
    before = dict(cuda_lib.launches)
    out = patch_decoder(h2, lat, w3r, b3r, mlp, k, packed=packed, bf16=True)
    assert cuda_lib.launches["patch_decoder_bf16"] == before["patch_decoder_bf16"] + 1
    assert cuda_lib.launches["patch_decoder"] == before["patch_decoder"]
    _hold_bf16(out, patch_decoder_plain(h2, lat, w3r, b3r, mlp, k, bf16=True))
    assert torch.equal(patch_decoder(h2, lat, w3r, b3r, mlp, k, packed=packed, bf16=True), out)
    with pytest.raises(ValueError, match="other instance"):
        patch_decoder(h2, lat, w3r, b3r, mlp, k, packed=packed)


# the three PPPF-AE stages at full width (a slice of the path's P = 1024),
# the CPU tests' widths, nsample > N, one narrow layer
_BF16_STAGES = [
    (64, 256, 256, 0, 32, 0.2, (3, 64, 64, 128)),
    (64, 128, 256, 128, 64, 0.4, (128, 128, 128, 256)),
    (64, 32, 128, 256, 128, 0.8, (256, 256, 512, 1024)),
    (4, 32, 64, 21, 16, 0.4, (24, 16, 32)),
    (7, 8, 32, 37, 32, 0.8, (40, 32, 48)),
    (3, 5, 40, 0, 12, 0.3, (7,)),
]


@pytest.mark.parametrize("P,S,N,C,nsample,radius,widths", _BF16_STAGES)
def test_pppf_sa_stage_bf16_kernel(dev, P, S, N, C, nsample, radius, widths):
    """The bf16 "pppf" stage: held to its plain version, two launches
    bitwise equal, with negative BatchNorm multipliers and bf16 features;
    bit for bit the bf16 replay of its arithmetic (its products on the
    tensor cores, certified) on up to REPLAY patches, also with the
    BatchNorm scales multiplied by 2 (chip_smoke.py's PPPF_BN_GAIN, which
    spreads the feature between patches)."""
    g = torch.Generator().manual_seed(23)
    xyz = torch.rand((P, N, 3), generator=g).to(dev)
    new_xyz = xyz if S == N else xyz[:, torch.randint(0, N, (S,), generator=g)].contiguous()
    feat = (torch.rand((P, N, C), generator=g).to(torch.bfloat16).float().to(dev)
            if C else None)
    layers = bf16_layers(_stage_layers(g, (C + 3,) + tuple(widths), dev))
    kw = dict(nsample=nsample, radius=radius, bf16=True)
    before = dict(cuda_lib.launches)
    out = pppf_sa_fused(new_xyz, xyz, feat, layers, **kw)
    assert cuda_lib.launches["pppf_sa_stage_bf16"] == before["pppf_sa_stage_bf16"] + 1
    assert cuda_lib.launches["pppf_sa_stage"] == before["pppf_sa_stage"]
    _hold_bf16(out, pppf_sa_plain(new_xyz, xyz, feat, layers, **kw))
    assert torch.equal(pppf_sa_fused(new_xyz, xyz, feat, layers, **kw), out)
    sl = slice(0, REPLAY)
    f = None if feat is None else feat[sl]
    pts = dict(nsample=nsample, radius=radius, replay=True, bf16=True)
    assert torch.equal(out[sl], pppf_sa_points(new_xyz[sl], xyz[sl], f, layers, **pts))
    gained = [(w, b, mean, mul * 2, beta) for w, b, mean, mul, beta in layers]
    out = pppf_sa_fused(new_xyz, xyz, feat, gained, **kw)
    assert torch.equal(out[sl], pppf_sa_points(new_xyz[sl], xyz[sl], f, gained, **pts))


# (P, N, knn): tiny, ragged patch counts, the largest patch, the path's
# [4096, 256] patches at knn 16
@pytest.mark.parametrize("P,N,knn", [(5, 32, 8), (5, 32, 16), (37, 256, 16), (64, 256, 8),
                                     (6, 1024, 16), (4096, 256, 16)])
def test_sa_fused_bf16_kernel(dev, P, N, knn):
    """SetAbstraction alone in bf16: held to its plain version (_hold_bf16),
    two launches bitwise equal, the same bits on the float32 weights as on
    bf16_wb's (the kernel rounds each weight and bias as it loads it);
    SetAbstraction(compute_dtype="bfloat16", fused=True) launches it once
    and no float32 instance. The float32 instance's output, the control,
    fails the hold where the rounding shows (not at 5 patches of 32
    points, whose few entries may all sit on bf16 values by chance)."""
    from pcc_tpu_torch.models.layers import SetAbstraction
    from pcc_tpu_torch.ops.sa_cuda import sa_fused, sa_fused_plain

    g = torch.Generator().manual_seed(26)
    pts = ((torch.rand((P, N, 3), generator=g) * 2 - 1) * 0.4).to(dev)
    sa = _wb(g, [3, 32, 64, 128], dev)
    sa16 = bf16_wb(sa)
    before = dict(cuda_lib.launches)
    out = sa_fused(pts, sa16, knn, bf16=True)
    assert cuda_lib.launches["sa_fused_bf16"] == before["sa_fused_bf16"] + 1
    assert cuda_lib.launches["sa_fused"] == before["sa_fused"]
    ref = sa_fused_plain(pts, sa, knn, bf16=True)
    _hold_bf16(out, ref)
    assert torch.equal(sa_fused(pts, sa16, knn, bf16=True), out)
    assert torch.equal(sa_fused(pts, sa, knn, bf16=True), out)
    if P * N >= 4096:
        f32 = sa_fused(pts, sa, knn)
        assert (float((f32 == ref).double().mean()) < BF16_SHARE
                or float((f32 - ref).abs().max()) > BF16_TOL * float(ref.abs().max()))
    module = SetAbstraction(knn=knn, fused=True, compute_dtype="bfloat16").to(dev).eval()
    with torch.no_grad():
        for conv, (w, b) in zip(module.convs(), sa):
            conv.weight.copy_(w.t().reshape(conv.weight.shape))
            conv.bias.copy_(b)
        before = dict(cuda_lib.launches)
        assert torch.equal(module(pts), out)
    assert cuda_lib.launches["sa_fused_bf16"] == before["sa_fused_bf16"] + 1
    assert cuda_lib.launches["sa_fused"] == before["sa_fused"]


# (P, S, N, C, widths after the input, route): PPPE's sa2 and sa3 at the
# serving batch, ragged patch and query counts, no features, a single
# layer, odd widths, and the per-slot route (a 1536-wide middle layer, as
# chip_smoke.py's phase 20; a first layer too wide for the slot kernel)
_PPPE_BF16 = [(32, 128, 512, 192, (128, 128, 256), "slots"),
              (32, 32, 128, 256, (256, 256, 512), "slots"),
              (5, 37, 300, 192, (128, 128, 256), "slots"),
              (3, 32, 128, 0, (256, 256, 512), "slots"),
              (7, 13, 40, 21, (24,), "slots"),
              (4, 9, 33, 5, (12, 20, 36), "slots"),
              (5, 128, 512, 192, (128, 1536, 256), "per_slot"),
              (2, 8, 32, 5, (1300, 8), "per_slot")]


@pytest.mark.parametrize("P,S,N,C,widths,route", _PPPE_BF16)
def test_pppe_sa_stage_bf16_kernel(dev, P, S, N, C, widths, route):
    """The bf16 "pppe" stage on both routes: held to its plain version
    (_hold_bf16) with negative BatchNorm multipliers and bf16 features, one
    pppe_sa_stage_bf16 launch and no float32 one, two launches bitwise
    equal; the float32 instance's output, the control, fails the hold at
    PPPE's widths."""
    g = torch.Generator().manual_seed(27)
    xyz = torch.rand((P, N, 3), generator=g).to(dev)
    new_xyz = xyz[:, torch.randperm(N, generator=g)[:S]].contiguous()
    feat = round_bf16(torch.randn((P, N, C), generator=g)).to(dev) if C else None
    layers = bf16_layers(_stage_layers(g, (C + 3,) + tuple(widths), dev, share=0.25))
    assert pppe_kernel([C + 3, *widths], N, S, 32) == route
    kw = dict(nsample=32, radius=0.0, layout="pppe")
    before = dict(cuda_lib.launches)
    out = pppf_sa_fused(new_xyz, xyz, feat, layers, bf16=True, **kw)
    assert cuda_lib.launches["pppe_sa_stage_bf16"] == before["pppe_sa_stage_bf16"] + 1
    assert cuda_lib.launches["pppf_sa_stage"] == before["pppf_sa_stage"]
    ref = pppf_sa_plain(new_xyz, xyz, feat, layers, bf16=True, **kw)
    _hold_bf16(out, ref)
    assert torch.equal(pppf_sa_fused(new_xyz, xyz, feat, layers, bf16=True, **kw), out)
    if P >= 32:
        f32 = pppf_sa_fused(new_xyz, xyz, feat, layers, **kw)
        assert (float((f32 == ref).double().mean()) < BF16_SHARE
                or float((f32 - ref).abs().max()) > BF16_TOL * float(ref.abs().max()))


@pytest.mark.parametrize("P,S,N,C,nsample,radius,widths", _BF16_STAGES[:2] + [
    (7, 12, 40, 13, 12, 0.3, (16, 24, 40)), (5, 16, 32, 0, 40, 0.5, (3, 8, 20))])
def test_pppf_sa_stage_bwd_bf16_kernel(dev, P, S, N, C, nsample, radius, widths):
    """The bf16 store mode: the serving output bit for bit, the rounded
    inputs stored. The bf16 stage backward on what it stored: held to its
    plain version on the same stored forward (every weight gradient within
    1e-4 of its largest |entry|: float32 sums in another order, and the
    tensor cores' accumulation; the row gradients row by row by
    tools/holds.py::row_hold, since a float32 sum in another order flips
    the bf16 rounding of a slot's cotangent now and then), two
    launches bitwise equal, and the same bits where the backward replays
    the forward itself (ragged widths, nsample beyond N)."""
    g = torch.Generator().manual_seed(25)
    xyz = torch.rand((P, N, 3), generator=g).to(dev)
    new_xyz = xyz if S == N else xyz[:, torch.randint(0, N, (S,), generator=g)].contiguous()
    feat = (torch.rand((P, N, C), generator=g).to(torch.bfloat16).float().to(dev)
            if C else None)
    layers = bf16_layers(_stage_layers(g, (C + 3,) + tuple(widths), dev))
    gout = round_bf16(torch.randn((P, S, widths[-1]), generator=g)).to(dev)
    kw = dict(nsample=nsample, radius=radius, bf16=True)
    before = dict(cuda_lib.launches)
    out, saved = pppf_sa_fused(new_xyz, xyz, feat, layers, save=True, **kw)
    assert cuda_lib.launches["pppf_sa_stage_bf16_save"] == before["pppf_sa_stage_bf16_save"] + 1
    assert saved is not None
    assert torch.equal(out, pppf_sa_fused(new_xyz, xyz, feat, layers, **kw))
    _, xs, _ = saved_views(saved, P, S, N, nsample, [C + 3] + list(widths))
    assert all(torch.equal(round_bf16(x), x) for x in xs)
    res = pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, saved=saved, **kw)
    assert cuda_lib.launches["pppf_sa_stage_bwd_bf16"] == before["pppf_sa_stage_bwd_bf16"] + 1
    a = _bwd_flat(*res)
    b = _bwd_flat(*pppf_sa_bwd_plain_bf16(new_xyz, xyz, feat, gout, layers, nsample=nsample,
                                          radius=radius, saved=saved))
    assert float(b[0].abs().max()) > 0
    rows = 2 if C else 1
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape
        if i < rows:
            fails, fig = row_hold(x, y)
            assert not fails, (fails, fig)
        else:
            assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())
    again = _bwd_flat(*pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, saved=saved, **kw))
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    replayed = _bwd_flat(*pppf_sa_bwd(new_xyz, xyz, feat, gout, layers, **kw))
    assert all(torch.equal(x, y) for x, y in zip(a, replayed))


@pytest.mark.parametrize("case", ["pppe", "pppe_middle", "sa_points", "sa_knn", "bwd_slots",
                                  "bwd_points", "enc_points", "enc_knn", "enc_n1040", "enc_d65",
                                  "dec_d65", "dec_c1000", "dec_cpu"])
def test_bf16_instances_reject_unsupported(dev, case):
    """Shapes outside an instance's domain raise before any launch: the
    bf16 "pppe" stage's widths past the per-slot kernel's smallest tile (a
    first layer and a middle layer 7300 wide), SetAbstraction's N % 16 and
    knn, the stage backward's nsample <= 254, the encoder and its
    backward's N % 16, the bf16 encoder's knn in (8, 16), N <= 1024 and
    D <= 64, the decoder's d <= 64 and C % 64 (its k = 64 stages)."""
    g = torch.Generator().manual_seed(24)
    before = dict(cuda_lib.launches)
    with pytest.raises(ValueError):
        if case.startswith("pppe"):
            xyz = torch.rand((2, 32, 3), generator=g).to(dev)
            feat = torch.rand((2, 32, 5), generator=g).to(dev)
            widths = (7300, 8) if case == "pppe" else (16, 7300, 8)
            assert pppe_kernel([8, *widths], 32, 8, 8) is None
            layers = bf16_layers(_stage_layers(g, (8,) + widths, dev))
            pppf_sa_fused(xyz[:, :8].contiguous(), xyz, feat, layers, nsample=8, radius=0.0,
                          layout="pppe", bf16=True)
        elif case.startswith("sa_"):
            from pcc_tpu_torch.ops.sa_cuda import sa_fused

            pts = torch.rand((2, 24 if case == "sa_points" else 32, 3), generator=g).to(dev)
            sa_fused(pts, bf16_wb(_wb(g, [3, 32, 64, 128], dev)), 8 if case == "sa_points" else 12,
                     bf16=True)
        elif case == "bwd_slots":
            xyz = torch.rand((2, 32, 3), generator=g).to(dev)
            layers = bf16_layers(_stage_layers(g, (3, 16, 8), dev))
            pppf_sa_bwd(xyz[:, :8].contiguous(), xyz, None, torch.zeros((2, 8, 8), device=dev),
                        layers, nsample=300, radius=0.4, bf16=True)
        elif case in ("bwd_points", "enc_points", "enc_knn", "enc_n1040", "enc_d65"):
            N = {"enc_n1040": 1040, "enc_knn": 32, "enc_d65": 32}.get(case, 24)
            pts = torch.rand((2, N, 3), generator=g).to(dev)
            D = 65 if case == "enc_d65" else 4
            sa, pn = _wb(g, [3, 32, 64, 128], dev), _wb(g, [131, 128, 256, 512, D], dev)
            if case.startswith("enc"):
                patch_encoder(pts, bf16_wb(sa), bf16_wb(pn), 12 if case == "enc_knn" else 8,
                              bf16=True)
            else:
                patch_encoder_bwd(pts, torch.zeros((2, 4), device=dev), sa, pn, 8,
                                  winners=torch.zeros((2, 4), dtype=torch.int32, device=dev),
                                  bf16=True)
        else:
            h2, lat, w3r, b3r, mlp, k = _decoder_case(dev, 40, 65 if case == "dec_d65" else 16,
                                                      16, C=1000 if case == "dec_c1000" else 1024)
            if case == "dec_cpu":
                mlp[0] = tuple(t.cpu() for t in mlp[0])
            patch_decoder(h2, lat, w3r, b3r, mlp, k, bf16=True)
    assert cuda_lib.launches == before
