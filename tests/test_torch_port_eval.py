"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: evaluation, on the CPU.

Clouds from a numpy seed go through pcc_tpu.metrics and the port's
metrics.py: D1/D2 PSNR within 1e-3 dB, the uniformity coefficient and the
normalized chamfer within rtol 1e-5 (float32 sums in another order), the
colour PSNR likewise; identical clouds give infinite D1 and D2 on both
sides; file normals, the batched and the per-file functions agree as
tests/test_metrics.py holds them in pcc_tpu. The PCA normals are held by
|n . n'| >= 1 - 1e-5 in float64 (eigenvector signs are free, and where the
two smallest eigenvalues nearly coincide LAPACK may turn the vector in
their plane). The PLY readers give equal arrays, the CSV writer gives
pandas' bytes, and the eval CLI's CSV and averages line are held to
pcc_tpu's: header, filenames, point counts and bpp byte-equal, the other
fields within the tolerances above.
"""

import csv
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcc_tpu.metrics as jm
from pcc_tpu.io.ply import read_point_cloud_attr as j_read_attr
from pcc_tpu.io.ply import read_point_cloud_normals as j_read_normals
from pcc_tpu.io.ply import save_point_cloud as j_save
from pcc_tpu.ops.normals import estimate_normals as j_estimate_normals
import pcc_tpu_torch.metrics as tm
from pcc_tpu_torch.io import (read_point_cloud, read_point_cloud_attr,
                              read_point_cloud_normals, save_point_cloud)
from pcc_tpu_torch.io.table import write_csv
from pcc_tpu_torch.ops.normals import estimate_normals

PSNR_DB = 1e-3
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    """numpy's BLAS and torch on one thread each for this module: several
    test workers share the cores, and their thread pools, each as wide as
    the machine, slow one another down many times over."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:                 # torch alone is limited then
        threadpool_limits = None
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if threadpool_limits is None:
            yield
        else:
            with threadpool_limits(limits=1, user_api="blas"):
                yield
    finally:
        torch.set_num_threads(n)


def _pairs(seed, B=5, N=700, M=600, noise=0.01):
    """B originals [N, 3] and recons [M, 3]: each original's points drawn
    (with repeats where M > N), jittered."""
    rng = np.random.default_rng(seed)
    origs = rng.random((B, N, 3)).astype(np.float32)
    recons = np.stack([origs[i, rng.choice(N, M, replace=M > N)]
                       + rng.standard_normal((M, 3)).astype(np.float32) * noise
                       for i in range(B)])
    return origs, recons


def _assert_metrics(got: dict, want: dict):
    for k in ("p2point_psnr", "p2plane_psnr"):
        assert got[k] == pytest.approx(want[k], abs=PSNR_DB), k
    for k in ("uc", "chamfer"):
        if k in want:
            assert got[k] == pytest.approx(want[k], rel=RTOL), k


@pytest.mark.parametrize("N,M,chunk", [(700, 600, 2), (600, 700, 16), (300, 300, 4)])
def test_eval_batch_matches_pcc_tpu(N, M, chunk):
    """The batched metrics, chunked and padded by repetition as pcc_tpu
    chunks them."""
    origs, recons = _pairs(N + M, N=N, M=M)
    want = jm.eval_batch(origs, recons, chunk=chunk)
    got = tm.eval_batch(origs, recons, chunk=chunk, device="cpu")
    assert len(got) == len(want) == origs.shape[0]
    for g, w in zip(got, want):
        _assert_metrics(g, w)


def test_per_file_metrics_match_pcc_tpu():
    origs, recons = _pairs(3, B=2)
    for o, r in zip(origs, recons):
        _assert_metrics(tm.compute_p2point_p2plane_psnr(o, r, device="cpu"),
                        jm.compute_p2point_p2plane_psnr(o, r))
        assert tm.calc_uc(o, r, device="cpu") == pytest.approx(jm.calc_uc(o, r), rel=RTOL)
        assert tm.normalized_chamfer(o, r, device="cpu") == pytest.approx(
            jm.normalized_chamfer(o, r), rel=RTOL)


def test_uc_caps_k_at_the_smaller_cloud():
    """K = min(1024, N_in, N_out): clouds smaller than 1024 points."""
    origs, recons = _pairs(4, B=1, N=200, M=150)
    assert tm.calc_uc(origs[0], recons[0], device="cpu") == pytest.approx(
        jm.calc_uc(origs[0], recons[0]), rel=RTOL)


def test_identical_clouds_give_infinite_psnr():
    pc = np.random.default_rng(5).random((300, 3)).astype(np.float32)
    for out in (tm.compute_p2point_p2plane_psnr(pc, pc, device="cpu"),
                jm.compute_p2point_p2plane_psnr(pc, pc),
                tm.eval_batch(pc[None], pc[None], device="cpu")[0],
                jm.eval_batch(pc[None], pc[None])[0]):
        assert out["p2point_psnr"] == float("inf")
        assert out["p2plane_psnr"] == float("inf")
    assert tm.normalized_chamfer(pc, pc, device="cpu") == pytest.approx(0.0, abs=1e-9)
    assert tm.calc_uc(pc, pc, device="cpu") == pytest.approx(1.0, rel=1e-4)


def test_file_normals_override_matches_pcc_tpu():
    """Normals carried by the input file replace the estimate, on both
    sides."""
    origs, recons = _pairs(6, B=1)
    normals = np.random.default_rng(7).standard_normal(origs[0].shape).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    got = tm.compute_p2point_p2plane_psnr(origs[0], recons[0], normals=normals, device="cpu")
    want = jm.compute_p2point_p2plane_psnr(origs[0], recons[0], normals=normals)
    _assert_metrics(got, want)
    est = tm.compute_p2point_p2plane_psnr(origs[0], recons[0], device="cpu")
    assert got["p2point_psnr"] == est["p2point_psnr"]
    assert got["p2plane_psnr"] != est["p2plane_psnr"]


def test_eval_batch_matches_per_file():
    """The batched metrics equal the per-file functions (pcc_tpu's
    tests/test_metrics.py::test_eval_batch_matches_per_file, on the port)."""
    origs, recons = _pairs(11)
    batched = tm.eval_batch(origs, recons, chunk=2, device="cpu")
    for i, b in enumerate(batched):
        _assert_metrics(b, tm.compute_p2point_p2plane_psnr(origs[i], recons[i], device="cpu"))
        assert b["uc"] == pytest.approx(tm.calc_uc(origs[i], recons[i], device="cpu"),
                                        rel=RTOL)
        assert b["chamfer"] == pytest.approx(
            tm.normalized_chamfer(origs[i], recons[i], device="cpu"), rel=RTOL)


@pytest.mark.parametrize("N,chunk", [(300, 2048), (500, 128)])
def test_normals_match_pcc_tpu_in_float64(N, chunk):
    """The PCA normals, the query axis whole and in chunks, in float64."""
    pc = np.random.default_rng(N).random((N, 3))
    with jax.enable_x64(True):
        want = np.asarray(j_estimate_normals(jnp.asarray(pc, jnp.float64), chunk=chunk))
    got = estimate_normals(torch.from_numpy(pc)[None], chunk=chunk)[0].numpy()
    assert got.dtype == np.float64 and got.shape == (N, 3)
    assert np.abs((got * want).sum(-1)).min() >= 1 - 1e-5
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-12)


def test_color_psnr_matches_pcc_tpu():
    origs, recons = _pairs(8, B=1)
    rng = np.random.default_rng(9)
    rgb_in = rng.integers(0, 256, (origs.shape[1], 3)).astype(np.uint8)
    rgb_out = rng.integers(0, 256, (recons.shape[1], 3)).astype(np.uint8)
    assert tm.compute_color_psnr(origs[0], rgb_in, recons[0], rgb_out, device="cpu") == \
        pytest.approx(jm.compute_color_psnr(origs[0], rgb_in, recons[0], rgb_out), rel=RTOL)
    assert tm.compute_color_psnr(origs[0], rgb_in, origs[0], rgb_in, device="cpu") == \
        float("inf")


@pytest.mark.parametrize("attrs", ["none", "rgb", "normals", "both"])
def test_ply_readers_equal_pcc_tpu(tmp_path, attrs):
    rng = np.random.default_rng(12)
    pc = rng.random((40, 3)).astype(np.float32)
    kw = {}
    if attrs in ("rgb", "both"):
        kw["rgb"] = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    if attrs in ("normals", "both"):
        kw["normals"] = rng.standard_normal((40, 3)).astype(np.float32)
    a = j_save(pc, "a.ply", path=str(tmp_path), **kw)
    b = save_point_cloud(pc, "b.ply", path=str(tmp_path), **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for got, want in ((read_point_cloud_attr(a), j_read_attr(a)),
                      (read_point_cloud_normals(a), j_read_normals(a))):
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_ply_readers_ascii_with_faces(tmp_path):
    """An ascii file with upper-case XYZ, colours, normals and a face list
    after the vertices."""
    path = tmp_path / "a.ply"
    path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 3\nproperty float X\nproperty float Y\n"
        "property float Z\nproperty float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "element face 1\nproperty list uchar int vertex_indices\nend_header\n"
        "0 0 0 0 0 1 255 0 0\n1 0 0 0 0 1 0 255 0\n0 1 0.5 0 1 0 0 0 255\n3 0 1 2\n")
    for got, want in ((read_point_cloud_attr(str(path)), j_read_attr(str(path))),
                      (read_point_cloud_normals(str(path)), j_read_normals(str(path)))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(read_point_cloud(str(path)), j_read_attr(str(path))[0])


def test_write_csv_is_pandas_bytes(tmp_path):
    """The CSV writer against pandas.DataFrame.to_csv: the unnamed index
    column, float reprs, inf, NaN as an empty field, integers, a column
    name with a space, a field that needs quotes."""
    pd = pytest.importorskip("pandas")
    rows = {"filename": ["a.ply", "b,c.ply", "d.ply"],
            "x": [43.871, float("inf"), 1e-05],
            "n": [8192, 16384, 7],
            "chamfer_distance": [0.00017512345678901234, 1.0, 2.5e-10],
            "uniformity coefficient": [2.93, 0.1, 3.0],
            "color_psnr": [float("nan"), 25.92, float("nan")]}
    write_csv(str(tmp_path / "t.csv"), rows)
    pd.DataFrame(rows).to_csv(str(tmp_path / "p.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "p.csv").read_bytes()
    write_csv(str(tmp_path / "t0.csv"), {"filename": [], "bpp": []})
    pd.DataFrame({"filename": [], "bpp": []}).to_csv(str(tmp_path / "p0.csv"))
    assert (tmp_path / "t0.csv").read_bytes() == (tmp_path / "p0.csv").read_bytes()


# ------------------------------------------------------------------ the CLI --

EXACT_COLUMNS = ("", "filename", "n_points_input", "n_points_output", "bpp", "attr_bpp")


def compare_eval_csv(got_path, want_path):
    """Hold a port eval CSV to pcc_tpu's: the header line byte-equal, the
    EXACT_COLUMNS fields byte-equal, the PSNR columns within PSNR_DB (plus
    the rounding to 3 decimals both sides apply), the other columns within
    RTOL (plus that rounding for the uniformity coefficient)."""
    with open(got_path) as f:
        got_lines = f.read().splitlines()
    with open(want_path) as f:
        want_lines = f.read().splitlines()
    assert got_lines[0] == want_lines[0]
    assert len(got_lines) == len(want_lines)
    header = next(csv.reader([want_lines[0]]))
    for g_row, w_row in zip(csv.reader(got_lines[1:]), csv.reader(want_lines[1:])):
        for col, g, w in zip(header, g_row, w_row):
            if col in EXACT_COLUMNS or w in ("", "inf"):
                assert g == w, col
            elif col.endswith("PSNR") or col == "color_psnr":
                assert float(g) == pytest.approx(float(w), abs=PSNR_DB + 1e-3), col
            elif col == "uniformity coefficient":
                assert float(g) == pytest.approx(float(w), rel=RTOL, abs=1e-3), col
            else:
                assert float(g) == pytest.approx(float(w), rel=RTOL), col


def compare_averages(got: str, want: str):
    """The printed averages lines: the same labels, each number within the
    tolerance of its column (the chamfer printed to 8 decimals, the others
    to 3)."""
    line = re.compile(r"([A-Za-z][A-Za-z0-9 !]*?): (-?[0-9.e+-]+|inf)")
    g, w = line.findall(got), line.findall(want)
    assert [k for k, _ in g] == [k for k, _ in w] and g
    for (k, gv), (_, wv) in zip(g, w):
        tol = 2e-8 if "chamfer" in k else 2e-3
        assert float(gv) == pytest.approx(float(wv), abs=tol), k


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """Inputs, compressed stand-ins and decoded clouds for the eval CLI:
    one cloud with estimated normals, one with file normals, one with RGB
    and a .a.bin stream, one input without a decoded cloud (skipped)."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(21)
    for i in range(4):
        pc = rng.random((300, 3)).astype(np.float32)
        kw = {}
        if i == 1:
            kw["normals"] = rng.standard_normal((300, 3)).astype(np.float32)
        if i == 2:
            kw["rgb"] = rng.integers(0, 256, (300, 3)).astype(np.uint8)
        j_save(pc, f"t{i}.ply", path=str(root / "in"), **kw)
        os.makedirs(root / "comp", exist_ok=True)
        for n, ext in enumerate((".s.bin", ".p.bin", ".c.bin")):
            (root / "comp" / f"t{i}.ply{ext}").write_bytes(b"x" * (17 + 5 * i + n))
        if i == 2:
            (root / "comp" / f"t{i}.ply.a.bin").write_bytes(b"y" * 33)
        if i == 3:
            continue
        rec = pc[rng.permutation(300)[:256]] + rng.standard_normal((256, 3)).astype(
            np.float32) * 0.01
        j_save(rec, f"t{i}.ply.bin.ply", path=str(root / "decomp"),
               rgb=rng.integers(0, 256, (256, 3)).astype(np.uint8) if i == 2 else None)
    return root


def _run_eval(module, root, out, capsys, extra=()):
    module.main(["--input_glob", str(root / "in" / "*.ply"), "--compressed_path",
                 str(root / "comp"), "--decompressed_path", str(root / "decomp"),
                 "--output_file", str(root / out), *extra])
    return next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Done!"))


def test_eval_cli_matches_pcc_tpu(eval_tree, capsys):
    from pcc_tpu.cli import eval as j_eval
    from pcc_tpu_torch.cli import eval as t_eval

    want = _run_eval(j_eval, eval_tree, "want.csv", capsys)
    got = _run_eval(t_eval, eval_tree, "got.csv", capsys, ("--device", "cpu"))
    compare_eval_csv(eval_tree / "got.csv", eval_tree / "want.csv")
    compare_averages(got, want)
    assert "color PSNR" in got


def test_eval_cli_geometry_only_schema(eval_tree, tmp_path, capsys):
    """Without .a.bin streams the CSV keeps the reference's eight columns."""
    from pcc_tpu.cli import eval as j_eval
    from pcc_tpu_torch.cli import eval as t_eval

    os.rename(eval_tree / "comp" / "t2.ply.a.bin", tmp_path / "a.bin")
    try:
        want = _run_eval(j_eval, eval_tree, "want_g.csv", capsys)
        got = _run_eval(t_eval, eval_tree, "got_g.csv", capsys, ("--device", "cpu"))
    finally:
        os.rename(tmp_path / "a.bin", eval_tree / "comp" / "t2.ply.a.bin")
    compare_eval_csv(eval_tree / "got_g.csv", eval_tree / "want_g.csv")
    compare_averages(got, want)
    with open(eval_tree / "got_g.csv") as f:
        assert f.readline().rstrip("\n").split(",")[-1] == "uniformity coefficient"
