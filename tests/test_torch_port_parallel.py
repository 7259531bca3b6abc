"""PyTorch port (pcc_tpu_torch) on two ranks vs one device and vs pcc_tpu's
sharded programs, on the CPU: parallel/mesh.py's launcher runs the cases
on two gloo processes for the whole module (`runs`, which starts
everything at once), and every test below reads what they returned.

  (a) the IPDAE step in both rate modes at lam = 1: loss, aux (fbpp, bpp,
      true_fbpp: "reference" divides by the global B twice), every
      gradient and the updated parameters against the one-device step of
      the global batch and against pcc_tpu's build_sharded_train_step on a
      two-device mesh (the same weights, batch and FPS starts);
  (b) the PPPF-AE warm-up and fused steps against the one-device steps and
      the warm-up against pcc_tpu's pppf_forward on the two-device mesh
      (batch statistics over the global batch), and the PN++ backbone's
      train-mode BatchNorm in float64;
  (c) the PPPE step in float64 against the one-device step and pcc_tpu's
      pppe_forward on the mesh: the rate's global mean before its clip
      (MAX_RATE set between the two shards' rates), then a NaN in one
      rank's cloud, which both ranks skip, the state bit for bit unchanged;
  (d) after two steps of each family every parameter, running statistic
      and Adam moment bit-equal across the ranks;
  (e) two-rank compress_many (AE and PPPF-AE, and AE in bf16 as
      compress --devices 2 --bf16 runs it) byte-equal to one device's,
      decoded by pcc_tpu's integer model and range coder, and two-rank
      decompress_many bit for bit one device's; the CLIs with --devices 2;
  (f) the CLIs' refusals (--devices above the visible cards, a batch not
      divisible by --devices);
  (g) the multi-host worker (parallel/dcn.py): two processes, one loss;
  (h) a launch whose worker raises raises in the parent.
The workers import this module: JAX is imported inside the tests only.
Gradient bars are the train tests': 1e-5 of each tensor's largest entry in
float32, tighter in float64.
"""

import copy
import functools
import glob
import hashlib
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pcc_tpu_torch.codec import Codec
from pcc_tpu_torch.config import CodecConfig, PPPEConfig
from pcc_tpu_torch.io import save_point_cloud
from pcc_tpu_torch.parallel import mesh
from pcc_tpu_torch.train import create_train_state
from pcc_tpu_torch.train.state import make_optimizer
from pcc_tpu_torch.train.steps import RATE_MODES
from pcc_tpu_torch.train.steps_pppe import create_pppe_state, make_pppe_optimizer

W = 2
LAM = 1.0
AE_KW = dict(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8)
PPPF_KW = dict(N=64, N0=64, ALPHA=2, K=32, d=4, L=7, model="PPPF-AE")
PPPF_CODEC_KW = dict(N=64, K=32, d=4, L=7, model="PPPF-AE")
AE, PPPF, PPPF_CODEC = CodecConfig(**AE_KW), CodecConfig(**PPPF_KW), CodecConfig(**PPPF_CODEC_KW)
AE_BF16 = CodecConfig(**AE_KW, compute_dtype="bfloat16")   # compress / decompress --bf16
PPPE_KW = dict(N=256, latent_dim=16, L=7)
PPPE = PPPEConfig(**PPPE_KW)
PNPP_KW = dict(points=64, sa1_mlp=(16, 16, 32), sa2_mlp=(32, 32, 32, 64), sa3_mlp=(64, 64, 128),
               feature_dim=128)
B_AE, B_PPPF, B_PPPE = 4, 2, 2
PPPE_LR, PPPE_LAM = 5e-4, 0.5


# ------------------------------------------------- what every rank runs --

def _np(tensors):
    return [t.detach().cpu().numpy().copy() for t in tensors]


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes: equal digests, bit-equal tensors."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def _record(state, aux, keep=None):
    """One step's aux and the digest of the state (parameters, running
    statistics, Adam moments); with `keep` (a parameter-name filter) also
    those parameters and their gradients by name, and the running
    statistics."""
    named = state.named_parameters()
    stats = [b for m in (state.ae, state.prob) for n, b in m.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    adam = [state.optimizer.state[p][k] for _, p in named for k in ("exp_avg", "exp_avg_sq")]
    rec = dict(aux=_aux(aux), digest=_digest([p for _, p in named] + stats + adam))
    if keep is not None:
        rec.update(params={n: p.detach().numpy().copy() for n, p in named if keep(n)},
                   grads={n: p.grad.numpy().copy() for n, p in named if keep(n)},
                   stats=_np(stats))
    return rec


def _sd(arrays):
    """A state_dict from its numpy arrays (the inputs travel to the ranks as
    numpy: a pickled tensor would be moved to shared memory under a reader
    in another thread)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy().copy() if isinstance(tree, torch.Tensor) else tree


def _aux(aux):
    return {k: float(v) for k, v in aux.items()}


def _ae_steps(inp, rate_mode):
    """IPDAE steps from inp's weights on its global batches and starts (two
    in rate mode "reference", one in "fixed"): each step's record
    (_record), the first with every parameter and gradient."""
    tx = make_optimizer(1e-3, 0.1, 100, 100)
    state = create_train_state(0, AE, tx, device="cpu")
    state.ae.load_state_dict(_sd(inp["ae_sd"]))
    state.prob.load_state_dict(_sd(inp["prob_sd"]))
    step = mesh.build_sharded_train_step(AE, tx, rate_mode=rate_mode)
    out = []
    steps = zip(inp["batches"], inp["starts"])
    for i, (batch, starts) in enumerate(list(steps)[:2 if rate_mode == "reference" else 1]):
        _, aux = step(state, torch.from_numpy(batch), torch.from_numpy(starts), LAM)
        out.append(_record(state, aux, keep=(lambda n: True) if i == 0 else None))
    return out


def _pppf_steps(inp, replicas: bool):
    """The PPPF-AE warm-up step and the fused step, each from inp's weights
    on the first batch (records with the autoencoder's parameters and
    gradients); with `replicas`, also the fused step after the warm-up
    step, on the second batch."""
    tx = make_optimizer(1e-3, 0.1, 100, 100)

    def fresh():
        state = create_train_state(0, PPPF, tx, device="cpu")
        state.ae.load_state_dict(_sd(inp["ae_sd"]))
        state.prob.load_state_dict(_sd(inp["prob_sd"]))
        return state

    def step(state, fused, i):
        step_fn = mesh.build_sharded_pppf_train_step(PPPF, tx, rate_mode="reference", fused=fused)
        _, aux = step_fn(state, torch.from_numpy(inp["batches"][i]),
                         torch.from_numpy(inp["starts"][i]), LAM)
        return _record(state, aux, keep=(lambda n: n.startswith("ae.")) if i == 0 else None)

    warm = fresh()
    out = dict(warmup=step(warm, False, 0), fused=step(fresh(), True, 0))
    if replicas:
        out["two_steps"] = step(warm, True, 1)
    return out


def _pnpp_bn(inp):
    """The PN++ backbone (narrow widths) in train mode, float64: output,
    every parameter's gradient (summed over the ranks) and the running
    statistics."""
    from pcc_tpu_torch.models.pppf import PointNetPP

    model = PointNetPP(**PNPP_KW).double().train()
    model.load_state_dict(_sd(inp["sd"]))
    x = torch.from_numpy(mesh.shard_batch(inp["x"]))
    _, feat = model(x)
    (feat * torch.from_numpy(mesh.shard_batch(inp["g"]))).sum().backward()
    mesh.all_reduce_grads(model.parameters())
    stats = [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]
    return dict(out=feat.detach().numpy(), grads=_np([p.grad for p in model.parameters()]),
                stats=_np(stats))


def _pppe_steps(inp):
    """Three PPPE steps in float64 with MAX_RATE at inp's clip: a plain one,
    one on a batch with a NaN (in the second rank's shard), a plain one;
    per step the aux, the state's digest and Adam's count, and after the
    first the rank's own gradients and the state (parameters, running
    statistics, Adam moments)."""
    from pcc_tpu_torch.train import steps_pppe

    tx = make_pppe_optimizer(PPPE_LR)
    state = create_pppe_state(0, PPPE, tx, device="cpu", dtype=torch.float64)
    state.model.load_state_dict(_sd(inp["sd"]))
    step = mesh.build_sharded_pppe_train_step(tx)
    saved, steps_pppe.MAX_RATE = steps_pppe.MAX_RATE, inp["max_rate"]
    out = []
    try:
        for i, batch in enumerate(inp["batches"]):
            _, aux = step(state, torch.from_numpy(batch), PPPE_LAM)
            flat = [state.params, state.stats, state.mu, state.nu, state.count, state.step]
            out.append(dict(aux=_aux(aux), digest=_digest(flat), count=int(state.count)))
            if i == 0:
                out[0].update(state=_np(flat[:4]), grads=_np(
                    [p.grad for _, p in state.named_parameters() if p.grad is not None]))
    finally:
        steps_pppe.MAX_RATE = saved
    return out


def _codec_cases(inp):
    """compress_many -> decompress_many of each family's codec (the PPPF
    integer model calibrated on 2 skeletons, as the port's codec tests do)."""
    from pcc_tpu_torch import codec as p_codec
    from pcc_tpu_torch.coding.iprob_pppf import convert_pppf_prob_params
    from pcc_tpu_torch.coding.octree_host import codes_to_points, parse_octree_bits, unpack_bits

    convert = p_codec.convert_pppf_prob_params
    p_codec.convert_pppf_prob_params = functools.partial(convert_pppf_prob_params, n_calib=2)
    out = {}
    try:
        for fam, cfg in (("ae", AE), ("pppf", PPPF_CODEC), ("ae_bf16", AE_BF16)):
            c = inp["ae" if fam == "ae_bf16" else fam]
            codec = Codec(cfg, _sd(c["ae_sd"]), _sd(c["prob_sd"]), batch_size=c["batch_size"],
                          device="cpu")
            streams = codec.compress_many(c["clouds"], c["starts"])
            recs = np.stack([codes_to_points(*parse_octree_bits(unpack_bits(s)))
                             for _, s, _ in streams])
            out[fam] = dict(streams=streams, decoded=codec.decompress_many(streams),
                            sym=codec.decode_symbols(recs, [p for p, _, _ in streams]))
    finally:
        p_codec.convert_pppf_prob_params = convert
    return out


def _cli_runs(inp):
    """The CLIs with --devices 2 --device cpu, as a user runs them, one
    after the other: each spawns its two workers (cli/_common.py::
    maybe_launch)."""
    from pcc_tpu_torch.cli import compress, decompress, train, train_pppe_pcd_ae

    for main, argv in ((train.main, inp["train"]), (train_pppe_pcd_ae.main, inp["train_pppe"]),
                       (train_pppe_pcd_ae.main, inp["train_pppe_bf16"]),
                       (compress.main, inp["compress"]), (decompress.main, inp["decompress"])):
        main(argv + ["--devices", str(W)])


def _rank_cases(inp, which):
    """The PPPF-AE steps (`which` "pppf"), or every other case, on this
    rank of a process group."""
    if which == "pppf":
        return {"pppf": _pppf_steps(inp["pppf"], replicas=True)}
    return {**{f"ae_{mode}": _ae_steps(inp["ae"], mode) for mode in RATE_MODES},
            "pnpp_bn": _pnpp_bn(inp["pnpp_bn"]), "pppe": _pppe_steps(inp["pppe"]),
            "codec": _codec_cases(inp["codec"])}


# ------------------------------------------------------- the test side --

@pytest.fixture(scope="module")
def one_thread():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
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


def _live_stats(state, seed):
    """tests/test_torch_port_pppf.py::_live_stats (not imported: that module
    imports JAX, and the launches start before this module's JAX work): a
    copy of a state_dict with non-trivial BatchNorm entries from a numpy
    seed: running means around 0, variances in [0.5, 1.5], scales in [0.5,
    1.5] with about a quarter negative, small biases."""
    rng = np.random.default_rng(seed)
    out = dict(state)
    for key in state:
        if not key.endswith(".running_mean"):
            continue
        stem, n = key[:-len("running_mean")], state[key].shape[0]
        sign = np.where(rng.random(n) < 0.25, -1.0, 1.0)
        for name, val in (("running_mean", rng.standard_normal(n) * 0.1),
                          ("running_var", rng.random(n) + 0.5),
                          ("weight", (rng.random(n) + 0.5) * sign),
                          ("bias", (rng.random(n) - 0.3) * 0.2)):
            out[stem + name] = torch.from_numpy(val.astype(np.float32))
    return out


def _pppe_state_dict(seed):
    """tests/test_torch_port_pppe.py::_test_state: seeded PPPE weights, live
    BatchNorm statistics, the latent head scaled to spread over the L
    bins."""
    from pcc_tpu_torch.models.pppe import make_pppe_model

    sd = _live_stats(make_pppe_model(PPPE, seed=seed).state_dict(), seed)
    sd["encoder.global_conv.3.weight"] = sd["encoder.global_conv.3.weight"] * 60.0
    sd["encoder.global_conv.3.bias"] = torch.full((PPPE.latent_dim,), 3.0)
    return sd


def _pppf_state_dicts():
    """tests/test_torch_port_train_pppf.py's setup: seeded weights, live
    BatchNorm statistics, the decoder's last layer 30 times larger."""
    state = create_train_state(0, PPPF, make_optimizer(1e-3, 0.1, 100, 100), device="cpu")
    state.ae.load_state_dict(_live_stats(state.ae.state_dict(), 3))
    state.prob.load_state_dict(_live_stats(state.prob.state_dict(), 4))
    with torch.no_grad():
        state.ae.decoder.mlp2[4].weight.mul_(30.0)
        state.ae.decoder.mlp2[4].bias.mul_(30.0)
    return copy.deepcopy(state.ae.state_dict()), copy.deepcopy(state.prob.state_dict())


def _pppe_rates(sd, batch):
    """Each cloud's rate (the mean -log2 pmf over its points) of the PPPE
    model in train mode on the global batch, float64."""
    from pcc_tpu_torch.models.pppe import make_pppe_model

    model = make_pppe_model(PPPE).double().train()
    model.load_state_dict(sd)
    with torch.no_grad():
        _, _, cond, y_q = model(torch.from_numpy(batch))
        _, _, pmf = model.prob(y_q, cond)
        idx0 = torch.clamp(y_q[:, 0, :].long(), 0, pmf.shape[1] - 1)
        p = torch.gather(pmf, 1, idx0[:, None, :])[:, 0]
        return (-torch.log2(torch.clamp_min(p, 1e-9))).mean(dim=1).numpy()


def _clouds(rng, n, N, scale=4.0):
    return (rng.random((n, N, 3)) * scale - scale / 4).astype(np.float32)


def _make_inputs(tmp):
    """Every case's inputs, the same for the ranks and the one-device runs;
    FPS starts as pcc_tpu's steps draw them (jax.random.randint of the
    step's key over the global batch)."""
    import jax
    import jax.numpy as jnp

    from pcc_tpu_torch.codec import init_params

    rng = np.random.default_rng(21)
    keys = [jax.random.key(31), jax.random.key(32)]
    inp, jax_side = {}, {"keys": keys}

    def starts(B, N):
        return [np.asarray(jax.random.randint(k, (B,), 0, N, dtype=jnp.int32)) for k in keys]

    ae_sd, prob_sd = init_params(5, AE)
    inp["ae"] = dict(ae_sd=ae_sd, prob_sd=prob_sd, batches=list(_clouds(rng, 2 * B_AE, AE.N)
                                                                   .reshape(2, B_AE, AE.N, 3)),
                     starts=starts(B_AE, AE.N))
    ae_sd, prob_sd = _pppf_state_dicts()
    inp["pppf"] = dict(ae_sd=ae_sd, prob_sd=prob_sd,
                       batches=list(_clouds(rng, 2 * B_PPPF, PPPF.N).reshape(2, B_PPPF, PPPF.N, 3)),
                       starts=starts(B_PPPF, PPPF.N))

    from pcc_tpu_torch.models.layers import torch_dense_init_
    from pcc_tpu_torch.models.pppf import PointNetPP

    pnpp = PointNetPP(**PNPP_KW)
    torch_dense_init_(pnpp, torch.Generator().manual_seed(8))
    inp["pnpp_bn"] = dict(sd={k: v.double() if v.is_floating_point() else v
                              for k, v in _live_stats(pnpp.state_dict(), 7).items()},
                          x=rng.random((4, 128, 3)), g=rng.standard_normal((4, 128)))

    # PPPE: the second shard's clouds spread three times wider, so the two
    # shards' rates differ; the clip sits between the global mean and the
    # larger shard's rate: a mean of per-shard clips would be lower
    sd = _pppe_state_dict(5)
    batches = [rng.random((B_PPPE, PPPE.N, 3)) for _ in range(3)]
    for b in batches:
        b[B_PPPE // 2:] *= 3.0
    rates = _pppe_rates(sd, batches[0]).reshape(W, -1).mean(axis=1)
    max_rate = float((rates.mean() + rates.max()) / 2)
    batches[1] = batches[0].copy()
    batches[1][-1, 17, 2] = np.nan
    inp["pppe"] = dict(sd=sd, batches=batches, max_rate=max_rate, rates=rates)

    # codecs: 5 clouds in batches of 4, so the second batch's shards are 1 and 0
    codec = {}
    ae_sd, prob_sd = init_params(6, AE)
    codec["ae"] = dict(ae_sd=ae_sd, prob_sd=prob_sd, batch_size=4,
                       clouds=list(_clouds(rng, 5, AE.N)), starts=[0, 17, 200, 3, 99])
    ae_sd, prob_sd = init_params(7, PPPF_CODEC)
    codec["pppf"] = dict(ae_sd=ae_sd, prob_sd=prob_sd, batch_size=2,
                         clouds=list(_clouds(rng, 2, PPPF_CODEC.N)), starts=[0, 5])
    inp["codec"] = codec

    # CLIs: 3 clouds, the AE train CLI 2 steps at batch 2, PPPE 2 steps at
    # batch 2, compress -> decompress
    data = os.path.join(tmp, "in")
    for i, pc in enumerate(_clouds(rng, 3, 256)):
        save_point_cloud(pc, f"c{i}.ply", path=data)
    small = ["--N0", "64", "--K", "32", "--d", "4", "--device", "cpu"]
    inp["cli"] = dict(
        train=["--train_glob", os.path.join(data, "*.ply"), "--model_save_folder",
               os.path.join(tmp, "ae"), "--N", "256", "--batch_size", "2", "--max_steps", "2",
               "--step_window", "1", "--lamda", "1", "--rate_loss_enable_step", "0"] + small,
        train_pppe=["--train_glob", os.path.join(data, "*.ply"), "--model_save_folder",
                    os.path.join(tmp, "pppe"), "--N", "256", "--K", "16", "--batch_size", "2",
                    "--max_steps", "2", "--step_window", "1", "--device", "cpu"],
        train_pppe_bf16=["--train_glob", os.path.join(data, "*.ply"), "--model_save_folder",
                         os.path.join(tmp, "pppe16"), "--N", "256", "--K", "16",
                         "--batch_size", "2", "--max_steps", "1", "--step_window", "1",
                         "--bf16", "--device", "cpu"],
        compress=[os.path.join(data, "*.ply"), os.path.join(tmp, "comp"),
                  os.path.join(tmp, "ae")] + small,
        decompress=[os.path.join(tmp, "comp"), os.path.join(tmp, "dec"),
                    os.path.join(tmp, "ae")] + small)
    return _numpy(inp), jax_side


def _j_ipdae(inp, jax_side, jm):
    """pcc_tpu's build_sharded_train_step on the two-device mesh `jm`, from
    the same weights, on the first batch with the first key: rate mode ->
    (aux, the updated parameters in the port's order)."""
    import jax

    from pcc_tpu.config import CodecConfig as JCodecConfig
    from pcc_tpu.parallel import build_sharded_train_step, replicate, shard_batch
    from pcc_tpu.train.state import TrainState
    from pcc_tpu.train.state import make_optimizer as j_make_optimizer
    from pcc_tpu_torch.codec import make_models
    from pcc_tpu_torch.weights import from_jax_params, to_jax_params

    ae_vars, prob_vars = to_jax_params(_sd(inp["ae_sd"]), _sd(inp["prob_sd"]))
    params = {"ae": ae_vars, "prob": prob_vars}
    out = {}
    for mode in RATE_MODES:
        tx = j_make_optimizer(1e-3, 0.1, 100, 100)
        step = build_sharded_train_step(JCodecConfig(**AE_KW), tx, jm, rate_mode=mode)
        state = TrainState(params=params, opt_state=tx.init(params), step=0)
        with jm:
            new, aux = step(replicate(jm, state), shard_batch(jm, inp["batches"][0]),
                            replicate(jm, jax_side["keys"][0]), LAM)
        ae_m, prob_m = make_models(AE)
        for m, sd in zip((ae_m, prob_m), from_jax_params(*jax.tree.map(
                np.asarray, (new.params["ae"], new.params["prob"])))):
            m.load_state_dict(sd)
        out[mode] = ({k: float(v) for k, v in aux.items()},
                     _np(list(ae_m.parameters()) + list(prob_m.parameters())))
    return out


def _j_pppf_warmup(inp, jax_side, jm):
    """pcc_tpu's pppf_forward in training (its warm-up step's forward) on
    the first batch sharded over `jm`: (loss, aux, the updated running
    statistics in the port's buffer order)."""
    import jax

    from pcc_tpu.config import CodecConfig as JCodecConfig
    from pcc_tpu.parallel import replicate, shard_batch
    from pcc_tpu.train.steps_pppf import pppf_forward
    from pcc_tpu_torch.codec import make_models
    from pcc_tpu_torch.weights import from_jax_params, to_jax_params

    ae_vars, prob_vars = to_jax_params(_sd(inp["ae_sd"]), _sd(inp["prob_sd"]))
    params = {"ae": ae_vars["params"], "prob": prob_vars["params"]}
    stats = {"ae": ae_vars["batch_stats"], "prob": prob_vars["batch_stats"]}
    fwd = jax.jit(functools.partial(pppf_forward, cfg=JCodecConfig(**PPPF_KW),
                                    rate_mode="reference"))
    with jm:
        loss, (aux, new) = fwd(replicate(jm, params), replicate(jm, stats),
                               shard_batch(jm, inp["batches"][0]),
                               replicate(jm, jax_side["keys"][0]), LAM)
    new = jax.tree.map(np.asarray, new)
    ae_m, prob_m = make_models(PPPF)
    for m, sd in zip((ae_m, prob_m), from_jax_params(
            {"params": ae_vars["params"], "batch_stats": new["ae"]},
            {"params": prob_vars["params"], "batch_stats": new["prob"]})):
        m.load_state_dict(sd)
    stats = [b for m in (ae_m, prob_m) for n, b in m.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    return float(loss), {k: float(v) for k, v in aux.items()}, _np(stats)


def _j_pppe(inp, jm):
    """pcc_tpu's pppe_forward (max_rate at the test's clip) in float64 on
    the first batch sharded over `jm`, its chunked chamfer search in its
    one-chunk form (tests/test_torch_port_train_pppe.py): (loss, aux, the
    updated running statistics in the port's flat order)."""
    import jax
    import jax.numpy as jnp

    import pcc_tpu.ops.chamfer as j_chamfer
    from pcc_tpu.config import PPPEConfig as JPPPEConfig
    from pcc_tpu.parallel import replicate, shard_batch
    from pcc_tpu.train.steps_pppe import pppe_forward
    from pcc_tpu_torch.models.pppe import make_pppe_model
    from pcc_tpu_torch.weights import from_jax_params, to_jax_params
    from test_torch_port_train_pppe import _nn_expansion_one_chunk

    mp = pytest.MonkeyPatch()
    mp.setattr(j_chamfer, "_nn_expansion", _nn_expansion_one_chunk)
    try:
        with jax.enable_x64(True):
            v = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                             to_jax_params(_sd(inp["sd"]))[0])
            fwd = jax.jit(functools.partial(pppe_forward, cfg=JPPPEConfig(**PPPE_KW),
                                            max_rate=inp["max_rate"]))
            with jm:
                loss, (aux, new) = fwd(replicate(jm, {"ae": v["params"]}),
                                       replicate(jm, {"ae": v["batch_stats"]}),
                                       shard_batch(jm, inp["batches"][0]), PPPE_LAM)
            loss, aux, new = jax.tree.map(np.asarray, (loss, aux, new["ae"]))
    finally:
        mp.undo()
    model = make_pppe_model(PPPE)
    model.load_state_dict(from_jax_params({"params": v["params"], "batch_stats": new}, None)[0])
    stats = [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]
    return float(loss), {k: float(val) for k, val in aux.items()}, _np(stats)


def _j_bundles(inp):
    """pcc_tpu's integer probability models of the codec cases' weights
    (the PPPF one calibrated on 2 skeletons, as the port's)."""
    from pcc_tpu.coding.iprob import convert_prob_params
    from pcc_tpu.coding.iprob_pppf import convert_pppf_prob_params
    from pcc_tpu_torch.weights import to_jax_params

    out = {}
    for family, cfg in (("ae", AE), ("pppf", PPPF_CODEC)):
        _, prob_vars = to_jax_params(_sd(inp[family]["ae_sd"]), _sd(inp[family]["prob_sd"]))
        out[family] = (convert_pppf_prob_params(prob_vars, cfg.d, cfg.L, n_calib=2, S=cfg.S)
                       if family == "pppf" else convert_prob_params(prob_vars, cfg.d, cfg.L))
    return out


def _thread(fn):
    """Start fn() on a thread; the returned callable joins it and returns
    fn's result or raises its exception."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised on join
            box["err"] = e

    th = threading.Thread(target=run)
    th.start()

    def join():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    return join


def _one_device_cases(inp, which):
    """The ranks' PPPF-AE steps (`which` "pppf") or their other cases on one
    device, without a process group, where the sharded builders and the
    codec run the single-device code on the global batch (in a process of
    their own, beside the ranks)."""
    torch.set_num_threads(1)
    if which == "pppf":
        return {"pppf": _pppf_steps(inp["pppf"], replicas=False)}
    return {**{f"ae_{m}": _ae_steps(inp["ae"], m) for m in RATE_MODES},
            "pnpp_bn": _pnpp_bn(inp["pnpp_bn"]), "pppe": _pppe_steps(inp["pppe"]),
            "codec": _codec_cases(inp["codec"])}


def _dcn_workers():
    """Two pcc_tpu_torch.parallel.dcn workers on the CPU (gloo, a tcp://
    rendezvous on a free port), started; returns the Popen objects."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, "-m", "pcc_tpu_torch.parallel.dcn", "--process_id", str(i),
         "--num_processes", str(W), "--coordinator", f"127.0.0.1:{port}", "--device", "cpu"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(W)]


def _fails_on_rank_1():
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if mesh.rank() == 1:
        raise ValueError("rank 1 fails")
    mesh.global_sum(torch.ones(1))


def _launch_error():
    """The exception of a launch whose rank 1 fails (None if it did not
    raise)."""
    try:
        mesh.launch(W, _fails_on_rank_1, device="cpu", timeout=120)
    except Exception as e:  # the test reads it
        return e
    return None


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """Everything the module's tests read, run at once: the two ranks'
    results (two launches, each on a thread: the PPPF-AE steps, the rest),
    the CLIs with --devices 2 (on a thread), a launch whose worker fails (on
    a thread), the multi-host workers, the same cases on one device
    (_one_device_cases, in two processes), and pcc_tpu's sharded programs
    and integer models (in this process)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from pcc_tpu.parallel import make_mesh

    tmp = str(tmp_path_factory.mktemp("ranks"))
    inp, jax_side = _make_inputs(tmp)
    ranks = [_thread(functools.partial(mesh.launch, W, _rank_cases, inp, which, device="cpu",
                                       timeout=600)) for which in ("pppf", "rest")]
    clis = _thread(lambda: _cli_runs(inp["cli"]))
    launch_error = _thread(_launch_error)
    dcn = _dcn_workers()
    try:
        with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
            one = [pool.submit(_one_device_cases, inp, which) for which in ("pppf", "rest")]
            jm = make_mesh(W)
            j = {"ae": _j_ipdae(inp["ae"], jax_side, jm),
                 "pppf": _j_pppf_warmup(inp["pppf"], jax_side, jm),
                 "pppe": _j_pppe(inp["pppe"], jm)}
            j["bundles"] = _j_bundles(inp["codec"])
            clis()
            by_rank = [{**a, **b} for a, b in zip(*(r() for r in ranks))]
            return dict(inp=inp, tmp=tmp, ranks=by_rank, j=j, launch_error=launch_error(),
                        one={k: v for f in one for k, v in f.result(timeout=600).items()},
                        dcn=[p.communicate(timeout=300)[0] for p in dcn])
    finally:
        for p in dcn:
            p.kill()


def _close(got, want, rel, what, floor=0.0):
    """Each array within rel of its reference's largest entry, or of
    `floor` where that is smaller."""
    assert len(got) == len(want) > 0, what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i)
        err, top = np.abs(a - b).max(), max(np.abs(b).max(), floor)
        assert err <= rel * top, (what, i, err, top)


def _bit_equal(a, b, what):
    assert len(a) == len(b) > 0, what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {i}")


@pytest.mark.parametrize("rate_mode", RATE_MODES)
def test_ipdae_step_matches_one_device(runs, rate_mode):
    """Two ranks against one device on the global batch: aux to 1e-6
    relative, every gradient within 1e-5 of its largest entry, the updated
    parameters to 2e-6 (2e-3 * lr: Adam's first update is lr * g / (|g| +
    eps), which follows g's last bits where |g| is near eps)."""
    want = runs["one"][f"ae_{rate_mode}"][0]
    for r in range(W):
        got = runs["ranks"][r][f"ae_{rate_mode}"][0]
        assert set(got["aux"]) == {"loss", "chamfer", "fbpp", "bpp", "true_fbpp"}
        for k, v in want["aux"].items():
            np.testing.assert_allclose(got["aux"][k], v, rtol=1e-6, err_msg=k)
        assert list(got["grads"]) == list(want["grads"])
        _close(list(got["grads"].values()), list(want["grads"].values()), 1e-5, "grads")
        for n, b in want["params"].items():
            np.testing.assert_allclose(got["params"][n], b, atol=2e-6, rtol=0, err_msg=n)


@pytest.mark.parametrize("rate_mode", RATE_MODES)
def test_ipdae_step_matches_pcc_tpu_sharded(runs, rate_mode):
    """Two ranks against pcc_tpu's sharded step over a two-device mesh:
    loss and aux to 1e-6 relative (fbpp, bpp and true_fbpp carry the global
    B: a rank that divided by its own would be off W or W^2 times), the
    updated parameters to 2e-6."""
    j_aux, j_params = runs["j"]["ae"][rate_mode]
    got = runs["ranks"][0][f"ae_{rate_mode}"][0]
    for k in ("loss", "chamfer", "fbpp", "bpp", "true_fbpp"):
        np.testing.assert_allclose(got["aux"][k], j_aux[k], rtol=1e-6, err_msg=k)
    assert got["aux"]["fbpp"] > 0
    for a, b in zip(got["params"].values(), j_params):
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)


@pytest.mark.parametrize("kind", ["warmup", "fused"])
def test_pppf_step_matches_one_device(runs, kind):
    """The PPPF-AE warm-up step (every stage on batch statistics) and the
    fused step (the encoder's BatchNorm frozen), each from the same
    weights, two ranks against one device, as
    test_warmup_step_matches_pcc_tpu and test_fused_step_matches_frozen_
    batchnorm hold the port to pcc_tpu: the chamfer to 1e-5 relative; the
    gradients that no float32 batch statistic reaches (the decoder's and
    dec_proj's; in the fused step every autoencoder gradient) within 1e-5
    of their largest entry, and after the warm-up step the decoder's and
    dec_proj's parameters to 2e-6; the running statistics within 1e-4 of
    their largest entry (the float32 batch statistics are good to about
    1e-2 at this size, ROADMAP.md §3, and a step moves the running ones by
    1 - 0.99 of them). The rate and the gradients through batch statistics
    are held in float64 by test_pnpp_batchnorm_float64."""
    want = runs["one"]["pppf"][kind]
    keep = [n for n in want["grads"]
            if kind == "fused" or n.startswith(("ae.decoder.", "ae.dec_proj."))]
    assert len(keep) == (64 if kind == "fused" else 14)
    for r in range(W):
        got = runs["ranks"][r]["pppf"][kind]
        np.testing.assert_allclose(got["aux"]["chamfer"], want["aux"]["chamfer"], rtol=1e-5)
        _close([got["grads"][n] for n in keep], [want["grads"][n] for n in keep], 1e-5, "grads")
        if kind == "warmup":
            for n in keep:
                np.testing.assert_allclose(got["params"][n], want["params"][n], atol=2e-6,
                                           rtol=0, err_msg=n)
        _close(got["stats"], want["stats"], 1e-4, "running statistics")


def test_pppf_warmup_matches_pcc_tpu_sharded(runs):
    """The two ranks' warm-up step against pcc_tpu's pppf_forward (what its
    sharded PPPF-AE step differentiates) over a two-device mesh: the
    chamfer to 1e-5 relative (test_warmup_step_matches_pcc_tpu's bar); the
    autoencoder's updated running statistics within 1e-4 of their largest
    entry, as against one device; the probability model's within 1e-2
    (2.6e-3 measured): at N = 64 it sees S = 4 skeleton points, which its
    stages pad to 512, 128 and 32 centroids with copies, so its float32
    fast variances cancel (ROADMAP.md §3), and each package's differently."""
    _, j_aux, j_stats = runs["j"]["pppf"]
    got = runs["ranks"][0]["pppf"]["warmup"]
    np.testing.assert_allclose(got["aux"]["chamfer"], j_aux["chamfer"], rtol=1e-5)
    n_ae = sum(n.endswith(("running_mean", "running_var"))
               for n in _sd(runs["inp"]["pppf"]["ae_sd"]))
    _close(got["stats"][:n_ae], j_stats[:n_ae], 1e-4, "autoencoder's running statistics")
    _close(got["stats"][n_ae:], j_stats[n_ae:], 1e-2, "probability model's running statistics")


def test_pnpp_batchnorm_float64(runs):
    """flax's train-mode BatchNorm over the global batch in the PN++
    backbone, float64, two ranks against one device: the features within
    1e-12 of their largest entry, every gradient (summed over the ranks)
    within 1e-10 of its largest entry or of 1 where that is smaller (a
    conv bias before a BatchNorm has a gradient of 0 up to rounding), the
    running statistics within 1e-12."""
    want = runs["one"]["pnpp_bn"]
    outs = [runs["ranks"][r]["pnpp_bn"] for r in range(W)]
    _close([np.concatenate([o["out"] for o in outs])], [want["out"]], 1e-12, "features")
    for got in outs:
        _close(got["grads"], want["grads"], 1e-10, "grads", floor=1.0)
        _close(got["stats"], want["stats"], 1e-12, "running statistics")


def test_pppe_step_matches_one_device(runs):
    """The first PPPE step in float64, two ranks against one device: loss,
    dist and rate to 1e-12 relative; the rate is the global mean, left
    unclipped by MAX_RATE, which one shard's rate exceeds (a mean of
    per-shard clips would be lower); the ranks' gradients summed within
    1e-10 of the one device's largest entry, or of 1 where that is smaller
    (a conv bias before a BatchNorm has a gradient of 0 up to rounding);
    parameters, running statistics and Adam moments within 1e-10."""
    inp = runs["inp"]["pppe"]
    rates, m = inp["rates"], inp["max_rate"]
    assert rates.min() < m < rates.max() and rates.mean() < m
    want = runs["one"]["pppe"][0]
    for k, v in want["aux"].items():
        for r in range(W):
            np.testing.assert_allclose(runs["ranks"][r]["pppe"][0]["aux"][k], v, rtol=1e-12,
                                       err_msg=k)
    got = runs["ranks"][0]["pppe"][0]
    np.testing.assert_allclose(got["aux"]["rate"], rates.mean(), rtol=1e-9)
    assert np.minimum(rates, m).mean() < got["aux"]["rate"] - 1e-3
    summed = [a + b for a, b in zip(runs["ranks"][0]["pppe"][0]["grads"],
                                    runs["ranks"][1]["pppe"][0]["grads"])]
    _close(summed, want["grads"], 1e-10, "grads", floor=1.0)
    _close(got["state"], want["state"], 1e-10, "state")


def test_pppe_nan_on_one_rank_skips_both(runs):
    """A NaN in a cloud of the second rank's shard: the global loss is not
    finite, both ranks skip the step, and each rank's whole state
    (parameters, running statistics, Adam moments and count, step) is bit
    for bit what it was; the next step updates again."""
    for r in range(W):
        steps = runs["ranks"][r]["pppe"]
        assert steps[1]["aux"]["skipped"] and not np.isfinite(steps[1]["aux"]["loss"])
        assert steps[1]["digest"] == steps[0]["digest"], f"rank {r}: the state moved"
        assert not steps[2]["aux"]["skipped"] and steps[2]["count"] == 2


def test_pppe_step_matches_pcc_tpu_sharded(runs):
    """The first PPPE step's loss, dist and rate against pcc_tpu's
    pppe_forward over a two-device mesh in float64 (its own float32 casts
    set the bar, tests/test_torch_port_train_pppe.py: 1e-7 relative), and
    the running statistics within 1e-7 of their largest entry."""
    j_loss, j_aux, j_stats = runs["j"]["pppe"]
    got = runs["ranks"][0]["pppe"][0]
    np.testing.assert_allclose(got["aux"]["loss"], j_loss, rtol=1e-7)
    for k in ("dist", "rate"):
        np.testing.assert_allclose(got["aux"][k], j_aux[k], rtol=1e-7, err_msg=k)
    flat = np.concatenate([s.reshape(-1) for s in j_stats])
    _close([got["state"][1]], [flat], 1e-7, "running statistics")


@pytest.mark.parametrize("family", ["ae_reference", "pppf", "pppe"])
def test_replicas_bit_equal_after_two_steps(runs, family):
    """After two steps of each family (PPPF-AE: a warm-up step, then a
    fused one; PPPE: a NaN-skipped step between two) every parameter,
    running statistic and Adam moment is bit for bit the same on both
    ranks: their digests are equal."""
    a, b = (runs["ranks"][r][family]["two_steps"] if family == "pppf"
            else runs["ranks"][r][family][-1] for r in range(W))
    assert a["digest"] == b["digest"]


@pytest.mark.parametrize("family", ["ae", "pppf", "ae_bf16"])
def test_streams_match_one_device(runs, family):
    """compress_many on two ranks: every rank holds every cloud's streams,
    byte-equal to one device's (the last batch of the AE case has shards of
    1 and 0 clouds); decompress_many on two ranks returns one device's
    clouds bit for bit. ae_bf16: the AE case's weights and clouds in bf16,
    as compress / decompress --devices 2 --bf16 code them."""
    want = runs["one"]["codec"][family]
    for r in range(W):
        got = runs["ranks"][r]["codec"][family]
        assert got["streams"] == want["streams"]
        _bit_equal(got["decoded"], want["decoded"], "decoded")


@pytest.mark.parametrize("family", ["ae", "pppf", "ae_bf16"])
def test_streams_decode_in_pcc_tpu(runs, family):
    """pcc_tpu's integer probability model (converted from the same float
    weights; its numpy spec, bit-exact with its device program) and its
    range coder read the two ranks' .p.bin back to the port's own
    symbols."""
    from pcc_tpu.coding import rangecoder as j_rc
    from pcc_tpu.coding.iprob import iprob_pmf_weights_np, weights_to_cdf_rows
    from pcc_tpu.coding.iprob_pppf import pppf_pmf_weights_np
    from pcc_tpu.coding.octree_host import codes_to_points, parse_octree_bits, unpack_bits

    streams = runs["ranks"][0]["codec"][family]["streams"]
    recs = np.stack([codes_to_points(*parse_octree_bits(unpack_bits(s))) for _, s, _ in streams])
    weights = pppf_pmf_weights_np if family == "pppf" else iprob_pmf_weights_np
    bundle = runs["j"]["bundles"]["ae" if family == "ae_bf16" else family]
    cdfs = weights_to_cdf_rows(weights(bundle, recs))
    sym = runs["ranks"][0]["codec"][family]["sym"]
    for j, (p, _, _) in enumerate(streams):
        np.testing.assert_array_equal(j_rc.decode_quantized_cdf(cdfs[j], p).reshape(
            sym[j].shape), sym[j])


def test_clis_with_two_devices(runs):
    """The CLIs with --devices 2 --device cpu, each spawning its two
    workers: the AE train CLI's checkpoint loads in pcc_tpu, the PPPE train
    CLI wrote its latest checkpoint and dataset_norm.pkl (also with --bf16:
    a float32 checkpoint of finite parameters), and compress ->
    decompress with the trained weights wrote (on rank 0) the streams and
    clouds of one device's codec, byte for byte and bit for bit."""
    from pcc_tpu.train.checkpoint import load_inference_params as j_load_inference_params
    from pcc_tpu_torch.io import read_point_cloud
    from pcc_tpu_torch.weights import load_inference_params

    tmp = runs["tmp"]
    ae, prob = j_load_inference_params(os.path.join(tmp, "ae"))
    assert ae is not None and prob is not None
    for folder in ("pppe", "pppe16"):
        assert {os.path.basename(f) for f in glob.glob(os.path.join(tmp, folder, "*.pkl"))} >= {
            "ae_latest.pkl", "optimizer_latest.pkl", "global_latest.pkl", "dataset_norm.pkl"}
    def leaves(tree):
        if isinstance(tree, dict):
            return [a for v in tree.values() for a in leaves(v)]
        return [np.asarray(tree)]

    with open(os.path.join(tmp, "pppe16", "ae_latest.pkl"), "rb") as f:
        arrays = leaves(pickle.load(f))
    assert arrays and all(a.dtype == np.float32 and np.isfinite(a).all() for a in arrays)
    files = sorted(glob.glob(os.path.join(tmp, "in", "*.ply")))
    codec = Codec(CodecConfig(N0=64, K=32, d=4), *load_inference_params(os.path.join(tmp, "ae")),
                  device="cpu")
    streams = codec.compress_many([read_point_cloud(f) for f in files])
    decoded = codec.decompress_many(streams)
    for f, blobs, pc in zip(files, streams, decoded):
        name = os.path.basename(f)
        for ext, blob in zip((".p.bin", ".s.bin", ".c.bin"), blobs):
            with open(os.path.join(tmp, "comp", name + ext), "rb") as fi:
                assert fi.read() == blob, name + ext
        np.testing.assert_array_equal(
            read_point_cloud(os.path.join(tmp, "dec", name + ".bin.ply")), pc)


def _cli_argvs(tmp):
    """One small argv per CLI (the files exist, so each reaches its
    --devices check)."""
    save_point_cloud(np.random.default_rng(0).random((256, 3)).astype(np.float32), "c.ply",
                     path=tmp)
    open(os.path.join(tmp, "x.s.bin"), "wb").close()
    glob_ = os.path.join(tmp, "*.ply")
    train = ["--train_glob", glob_, "--model_save_folder", os.path.join(tmp, "m")]
    return {"train AE": ("train", train),
            "train PPPF-AE": ("train", train + ["--model", "PPPF-AE"]),
            "train_pppe_pcd_ae": ("train_pppe_pcd_ae", train),
            "compress": ("compress", [glob_, os.path.join(tmp, "c"), os.path.join(tmp, "m")]),
            "decompress": ("decompress", [tmp, os.path.join(tmp, "d"), os.path.join(tmp, "m")])}


@pytest.mark.parametrize("cli", ["train AE", "train PPPF-AE", "train_pppe_pcd_ae", "compress",
                                 "decompress"])
def test_cli_refuses_more_devices_than_visible(tmp_path, cli):
    """--devices 2 with --device cuda where no card is visible: refused with
    pcc_tpu's message, before any process starts."""
    import importlib

    module, argv = _cli_argvs(str(tmp_path))[cli]
    main = importlib.import_module(f"pcc_tpu_torch.cli.{module}").main
    with pytest.raises(SystemExit, match="--devices 2 requested but only 0 device"):
        main(argv + ["--devices", "2", "--device", "cuda"])


@pytest.mark.parametrize("cli", ["train AE", "train_pppe_pcd_ae"])
def test_cli_refuses_batch_not_divisible(tmp_path, cli):
    """--batch_size 3 with --devices 2: refused with pcc_tpu's message."""
    import importlib

    module, argv = _cli_argvs(str(tmp_path))[cli]
    main = importlib.import_module(f"pcc_tpu_torch.cli.{module}").main
    with pytest.raises(SystemExit, match="--batch_size 3 must be divisible by --devices 2"):
        main(argv + ["--devices", "2", "--device", "cpu", "--batch_size", "3"])


def test_launch_raises_when_a_worker_fails(runs):
    """A worker's exception reaches the parent, with its traceback, and no
    worker is left running (rank 0 was waiting in a collective)."""
    err = runs["launch_error"]
    assert isinstance(err, RuntimeError)
    assert "worker 1 of 2 failed" in str(err) and "rank 1 fails" in str(err)


def test_dcn_two_processes_one_loss(runs):
    """Two pcc_tpu_torch.parallel.dcn workers on the CPU (gloo, tcp://
    rendezvous): both report the same finite loss, bit for bit (the sum
    over the ranks is computed once and handed to both)."""
    losses = []
    for i, out in enumerate(runs["dcn"]):
        line = [ln for ln in out.splitlines() if ln.startswith(f"dcn worker {i}/{W}: loss=")]
        assert line, f"worker {i} failed:\n{out[-3000:]}"
        losses.append(line[-1].split("loss=")[1])
    assert losses[0] == losses[1] and np.isfinite(float(losses[0]))
