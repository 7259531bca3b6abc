"""The fused IPDAE patch encoder, its backward and SetAbstraction alone
(counterpart of pcc_tpu/ops/sa_pallas.py: TPU kernels _encoder_kernel,
entry patch_encoder_fused, _encoder_bwd_kernel, entry
patch_encoder_trainable, and _sa_kernel, entry sa_fused).

`patch_encoder` launches the CUDA kernel csrc/patch_encoder.cu on CUDA
tensors and runs `patch_encoder_plain`, the same function in plain
PyTorch, on CPU tensors: per [N, 3] patch, knn-nearest-neighbour grouping,
the SetAbstraction MLP with a max over neighbours, the concat with xyz, the
PointNet MLP and a max over points -> the pre-spread latent [P, D].
Neighbour selection is bit-equal between the two; the MLP sums run in
another order, so latents agree to float32 rounding. With bf16=True the
bf16 instance of the kernel runs (launch counter "patch_encoder_bf16"),
rounding where pcc_tpu's bf16 encoder kernel rounds (sa_pallas.py:163-210):
every weight and bias (the caller's, once: `bf16_wb`), the centred
neighbours and xyz, every layer's output. In bf16 training it also gives
the winners of pcc_tpu's bf16 backward, whose replay of the forward rounds
the weights but adds the float32 biases (sa_pallas.py:297-314): see
`patch_encoder`.

`patch_encoder_bwd` is its gradient against a cotangent [P, D]: the CUDA
kernel csrc/patch_encoder_bwd.cu on CUDA tensors, `patch_encoder_bwd_plain`
(autograd through plain products, with the kernel's relu and max choices)
on CPU tensors. Both route each latent channel's gradient through its
winner, the first point that reaches the channel's max over points:
`patch_encoder(..., return_winners=True)` returns them beside the latent
(the forward kernel computes them in its fold), and `patch_encoder_bwd(...,
winners=...)` takes them.
With bf16=True the bf16 instance of the backward kernel runs (launch
counter "patch_encoder_bwd_bf16"), with pcc_tpu's rounding points
(sa_pallas.py:288-470): the replayed forward as above, every input
gradient a product of the bf16-rounded cotangent and weight, every weight
gradient a float32 product of the stored activations (the patch points and
the centred neighbours unrounded).
`patch_encoder_trainable` is the differentiable encoder that training
calls: forward `patch_encoder` with its winners, backward
`patch_encoder_bwd` on them, in either dtype.

`sa_fused` is the encoder's first half alone, SetAbstraction [P, N, 3] ->
[P, N, 128] (pcc_tpu's TPU kernel _sa_kernel, entry sa_fused): the CUDA
kernel csrc/sa_fused.cu, the encoder's selection (csrc/encoder_common.cuh::
knn_of) with layers 2 and 3 on the tensor cores, on CUDA tensors;
`sa_fused_plain` on CPU tensors. Like pcc_tpu's, it has no backward. With
bf16=True its bf16 instance runs (launch counter "sa_fused_bf16"; the plain
version `sa_fused_plain(..., bf16=True)`), rounding where _sa_kernel rounds
(sa_pallas.py:63-80): every weight and bias, the centred neighbours before
layer 1 and every layer's relu output; products and bias adds float32. The
kernels' design notes (what bounds them on an H100, what they do about
that) are at the top of their sources.
"""

from __future__ import annotations

import ctypes

import torch

from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops.bf16 import round_bf16
from pcc_tpu_torch.ops.certified import cached_frags
from pcc_tpu_torch.ops.knn import knn_gather, select_nearest, sq_dists
from pcc_tpu_torch.ops.tf32_mma import wgrad_part_floats

_ARGTYPES = ([cuda_lib.PTR, cuda_lib.INT, cuda_lib.INT, cuda_lib.INT]
             + [cuda_lib.PTR] * 14 + [cuda_lib.INT] + [cuda_lib.PTR] * 3)
_BWD_ARGTYPES = ([cuda_lib.PTR] * 3 + [cuda_lib.INT, cuda_lib.INT, cuda_lib.INT]
                 + [cuda_lib.PTR] * 14 + [cuda_lib.INT] + [cuda_lib.PTR] * 4
                 + [ctypes.c_longlong, cuda_lib.PTR])
_BF16_ARGTYPES = _ARGTYPES + [cuda_lib.PTR] * 8   # + the replay's 7 biases, the packed weights
_SA_ARGTYPES = ([cuda_lib.PTR, cuda_lib.INT, cuda_lib.INT, cuda_lib.INT]
                + [cuda_lib.PTR] * 8)
SA_WIDTHS = (3, 32, 64, 128)
PN_WIDTHS = (131, 128, 256, 512)        # then D
KNN_SUPPORTED = (8, 16)
MAX_POINTS = 1024
MAX_D = 64
ENC_Q = 16          # csrc/encoder_common.cuh: kEncQ, the backward's winners per group
PLAIN_CHUNK = 256   # patches per pass of the plain versions (bounds their memory)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def bf16_wb(wb) -> list:
    """[(w, b)] with every weight and bias rounded to bf16 (the bf16
    encoder kernel's `load`, pcc_tpu's sa_pallas.py): the weights the bf16
    encoder takes."""
    return [(round_bf16(w), round_bf16(b)) for w, b in wb]


def replay_wb(wb) -> list:
    """[(w, b)] with the weights rounded to bf16 and the biases as they are:
    the operands of pcc_tpu's bf16 backward kernel, whose replay of the
    forward casts each weight but adds the float32 bias (`dense_fwd`,
    sa_pallas.py:305-314) and whose input gradients take the rounded weights
    (`matmul`, :316-317)."""
    return [(round_bf16(w), b) for w, b in wb]


def sa_features(p: torch.Tensor, idx: torch.Tensor, sa_wb, bf16: bool = False) -> torch.Tensor:
    """SetAbstraction in plain PyTorch: [c, N, 3] patches and their
    neighbour indices [c, N, knn] -> the centred neighbours through the
    relu MLP, max over neighbours [c, N, 128]. bf16: the centred neighbours
    and every layer's output rounded to bf16 (sa_wb already bf16-exact)."""
    rnd = round_bf16 if bf16 else _identity
    h = rnd(knn_gather(p, idx) - p[:, :, None, :])
    for w, b in sa_wb:
        h = rnd(torch.relu(h @ w + b))
    return h.amax(dim=2)


def pointwise_plain(p: torch.Tensor, idx: torch.Tensor, sa_wb, pn_wb,
                    bf16: bool = False) -> torch.Tensor:
    """The encoder before its max over points, in plain PyTorch: [c, N, 3]
    patches and their neighbour indices [c, N, knn] -> [c, N, D]. bf16: xyz
    and every layer's output rounded to bf16 as well (weights bf16-exact)."""
    rnd = round_bf16 if bf16 else _identity
    x = torch.cat([rnd(p), sa_features(p, idx, sa_wb, bf16)], dim=-1)  # [c, N, 131]
    for i, (w, b) in enumerate(pn_wb):
        x = x @ w + b
        if i < len(pn_wb) - 1:
            x = torch.relu(x)
        x = rnd(x)
    return x


def patch_encoder_plain(patches: torch.Tensor, sa_wb, pn_wb, knn: int,
                        chunk: int = PLAIN_CHUNK, return_winners: bool = False,
                        bf16: bool = False):
    """[P, N, 3] f32 -> [P, D]. sa_wb / pn_wb: lists of ([in, out] weight,
    [out] bias) tensors. Runs `chunk` patches at a time to bound the memory
    of the [chunk, N, knn, 128] grouped activations. With return_winners,
    (latent, winners [P, D] int32): each channel's first arg-max point as
    the kernel finds it (`winners_plain`). bf16: the weights and biases
    bf16 values (`bf16_wb`), the centred neighbours, xyz and every layer's
    output rounded to bf16, products in float32. bf16 with return_winners
    (training): sa_wb / pn_wb are the float32 weights; the latent is taken
    on bf16_wb of them, as pcc_tpu's forward kernel rounds every weight and
    bias, and the winners on replay_wb of them, as its backward's replay
    computes the forward (sa_pallas.py:297-392)."""
    lat_sa, lat_pn = (bf16_wb(sa_wb), bf16_wb(pn_wb)) if bf16 and return_winners \
        else (sa_wb, pn_wb)
    rep_sa, rep_pn = (replay_wb(sa_wb), replay_wb(pn_wb)) if bf16 else (sa_wb, pn_wb)
    outs, wins = [], []
    for s in range(0, patches.shape[0], chunk):
        p = patches[s:s + chunk]
        idx = select_nearest(sq_dists(p, p), knn)          # [c, N, knn]
        z4 = pointwise_plain(p, idx, lat_sa, lat_pn, bf16)
        outs.append(z4.amax(dim=1))
        if return_winners:
            z4w = pointwise_plain(p, idx, rep_sa, rep_pn, True) if bf16 else z4
            wins.append(winners_plain(p, idx, z4w, rep_sa, rep_pn, bf16).to(torch.int32))
    if return_winners:
        return torch.cat(outs), torch.cat(wins)
    return torch.cat(outs)


def sa_fused_plain(patches: torch.Tensor, sa_wb, knn: int, bf16: bool = False) -> torch.Tensor:
    """SetAbstraction alone, [P, N, 3] f32 -> [P, N, 128], in plain PyTorch,
    PLAIN_CHUNK patches at a time. bf16: pcc_tpu's _sa_kernel with
    compute_dtype bfloat16, every weight and bias rounded (`bf16_wb`), then
    `sa_features` in bf16: bf16 values in float32 out."""
    if bf16:
        sa_wb = bf16_wb(sa_wb)
    return torch.cat([sa_features(p, select_nearest(sq_dists(p, p), knn), sa_wb, bf16)
                      for p in torch.split(patches, PLAIN_CHUNK)])


def sa_fused(patches: torch.Tensor, sa_wb, knn: int, bf16: bool = False) -> torch.Tensor:
    """SetAbstraction alone (pcc_tpu's sa_fused): [P, N, 3] f32 patches ->
    per-point features [P, N, 128] f32, the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. sa_wb: [([in, out] weight, [out] bias)]
    for 3 -> 32 -> 64 -> 128. bf16: the bf16 instance (launch counter
    "sa_fused_bf16"), which rounds every weight and bias as it loads them,
    a no-op on `bf16_wb`'s (SetAbstraction keeps those). Raises where a
    gradient would be needed: the kernel has no backward, as pcc_tpu's has
    none."""
    flat = [t for wb in sa_wb for t in wb]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [patches] + flat):
        raise RuntimeError("sa_fused has no backward: call it under torch.no_grad() "
                           "(SetAbstraction(fused=True) is for inference)")
    if patches.device.type == "cpu":
        return sa_fused_plain(patches, sa_wb, knn, bf16)
    cuda_lib.require_cuda("sa_fused", patches, torch.float32, 3)
    P, N, C = patches.shape
    if C != 3 or knn not in KNN_SUPPORTED or N % 16 or not knn <= N <= MAX_POINTS:
        raise ValueError(f"sa_fused: unsupported patches {tuple(patches.shape)}, knn={knn}")
    want = [(SA_WIDTHS[i], SA_WIDTHS[i + 1]) for i in range(3)]
    if [tuple(w.shape) for w, _ in sa_wb] != want:
        raise ValueError(f"sa_fused: weight shapes {[tuple(w.shape) for w, _ in sa_wb]} "
                         f"!= {want}")
    for i, t in enumerate(flat):
        cuda_lib.require_cuda(f"sa_fused {'bias' if i % 2 else 'weight'}", t, torch.float32,
                              1 if i % 2 else 2)
    if any(t.data_ptr() % 16 for t in flat):
        raise ValueError("sa_fused: weights and biases must be 16-byte aligned")
    out = torch.empty((P, N, SA_WIDTHS[-1]), dtype=torch.float32, device=patches.device)
    cuda_lib.launch("sa_fused_bf16" if bf16 else "sa_fused", _SA_ARGTYPES, patches.data_ptr(),
                    P, N, knn, *[t.data_ptr() for t in flat], out.data_ptr(),
                    cuda_lib.stream_ptr(patches))
    return out


def fma_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., cin] @ w [cin, cout] in float32 as the kernels compute it:
    acc = fma(x[k], w[k], acc) for k = 0, 1, ... from 0. The float64
    product of two float32 values is exact and its float64 sum, rounded to
    float32, is the fused multiply-add (but for a double rounding, about
    2^-29 of the time)."""
    x64, w64 = x.double(), w.double()
    acc = torch.zeros(x.shape[:-1] + (w.shape[1],), dtype=torch.float32, device=x.device)
    for k in range(x.shape[-1]):
        acc = (x64[..., k:k + 1] * w64[k] + acc).to(torch.float32)
    return acc


def _kernel_choices(p, idx, rows, sa_wb, pn_wb, bf16: bool = False, acts=None):
    """The forward of the query points `rows` [c, R] of patches p, in the
    kernels' float32 arithmetic (csrc/encoder_common.cuh), for the choices
    the backward makes on them. Returns the relu masks of the
    SetAbstraction layers 1-2 [c, R, knn, 32 / 64], the SetAbstraction
    max's first winning slot and its liveness (max > 0) [c, R, 128], the
    PointNet relu masks [c, R, 128 / 256 / 512] and the last layer [c, R, D].
    bf16: the bf16 kernels' arithmetic on the weights given (`bf16_wb` for
    the forward, `replay_wb` for the backward's replay; the centred
    neighbours, xyz and every layer's output rounded to bf16), the slot the
    first to reach the max of the rounded values. acts (a dict): filled
    with each layer's stored input as pcc_tpu's backward keeps it, "sa"
    [the centred neighbours unrounded, layer 1's and 2's outputs] and "pn"
    [x0 = xyz unrounded | the pooled features, x1, x2, x3]."""
    rnd = round_bf16 if bf16 else _identity
    q = torch.gather(p, 1, rows[..., None].expand(-1, -1, 3))            # [c, R, 3]
    nbr = torch.gather(idx, 1, rows[..., None].expand(-1, -1, idx.shape[-1]))
    centred = knn_gather(p, nbr) - q[:, :, None, :]
    h = rnd(centred)
    sa_masks, sa_in = [], [centred]
    for i, (w, b) in enumerate(sa_wb):
        z = fma_matmul(h, w) + b
        if i < len(sa_wb) - 1:
            h = rnd(torch.relu(z))
            sa_masks.append(h > 0)
            sa_in.append(h)
    top, slot = rnd(z).max(dim=2)             # first slot reaching the max
    feats = rnd(torch.relu(top))
    x = torch.cat([rnd(q), feats], dim=-1)
    pn_masks, pn_in = [], [torch.cat([q, feats], dim=-1)]
    for i, (w, b) in enumerate(pn_wb):
        x = fma_matmul(x, w) + b
        if i < len(pn_wb) - 1:
            x = torch.relu(x)
        x = rnd(x)
        if i < len(pn_wb) - 1:
            pn_masks.append(x > 0)
            pn_in.append(x)
    if acts is not None:
        acts.update(sa=sa_in, pn=pn_in)
    return sa_masks, slot, top > 0, pn_masks, x


def _gather_rows(t: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """t [c, R, ...] at rows sel [c, D] -> [c, D, ...]."""
    return torch.gather(t, 1, sel.reshape(sel.shape + (1,) * (t.dim() - 2)).expand(
        sel.shape + t.shape[2:]))


def _flatten(sa_wb, pn_wb) -> list:
    """([(w, b)] * 3, [(w, b)] * 4) -> the 14 tensors w1, b1, ..., pb4."""
    return [t for wb in list(sa_wb) + list(pn_wb) for t in wb]


def _unflatten(flat):
    """The 14 tensors w1, b1, ..., pb4 -> ([(w, b)] * 3, [(w, b)] * 4)."""
    pairs = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]
    return pairs[:len(SA_WIDTHS) - 1], pairs[len(SA_WIDTHS) - 1:]


def _kernel_args(name: str, patches: torch.Tensor, sa_wb, pn_wb, knn: int) -> list:
    """Check what the encoder kernels take (raise otherwise) and return the
    14 weight/bias pointers in the kernels' order."""
    cuda_lib.require_cuda(name, patches, torch.float32, 3)
    _, N, C = patches.shape
    D = pn_wb[-1][0].shape[1]
    if (C != 3 or knn not in KNN_SUPPORTED or N % 16 or not knn <= N <= MAX_POINTS
            or not 0 < D <= MAX_D):
        raise ValueError(f"{name}: unsupported patches {tuple(patches.shape)}, "
                         f"knn={knn}, D={D}")
    widths = [w.shape for w, _ in sa_wb] + [w.shape for w, _ in pn_wb]
    want = ([(SA_WIDTHS[i], SA_WIDTHS[i + 1]) for i in range(3)]
            + [(PN_WIDTHS[i], PN_WIDTHS[i + 1]) for i in range(3)] + [(512, D)])
    if [tuple(s) for s in widths] != want:
        raise ValueError(f"{name}: weight shapes {widths} != {want}")
    flat = _flatten(sa_wb, pn_wb)
    for i, t in enumerate(flat):
        cuda_lib.require_cuda(f"{name} {'bias' if i % 2 else 'weight'}", t, torch.float32,
                              1 if i % 2 else 2)
    if any(t.data_ptr() % 16 for t in flat):
        raise ValueError(f"{name}: weights and biases must be 16-byte aligned")
    return [t.data_ptr() for t in flat]


def patch_encoder(patches: torch.Tensor, sa_wb, pn_wb, knn: int,
                  return_winners: bool = False, bf16: bool = False):
    """[P, N, 3] f32 patches -> pre-spread latent [P, D] f32: the CUDA kernel
    on CUDA tensors, the plain version on CPU tensors. With return_winners,
    (latent, winners [P, D] int32): each latent channel's first arg-max
    point, which the backward routes its gradient through. bf16: the bf16
    instance on weights and biases that are bf16 values (`bf16_wb`, which
    PatchAE.encoder_weights keeps). bf16 with return_winners (training):
    sa_wb / pn_wb are the float32 weights; one launch computes the latent on
    bf16_wb of them and, in a second half of its grid, the winners on
    replay_wb of them, pcc_tpu's bf16 backward's own replay of the forward
    (its biases float32), whose winners its gradient routes through."""
    if patches.device.type == "cpu":
        return patch_encoder_plain(patches, sa_wb, pn_wb, knn, return_winners=return_winners,
                                   bf16=bf16)
    P, D = patches.shape[0], pn_wb[-1][0].shape[1]
    out = torch.empty((P, D), dtype=torch.float32, device=patches.device)
    win = (torch.empty((P, D), dtype=torch.int32, device=patches.device)
           if return_winners else None)
    if bf16:
        biases = [None] * 7
        if return_winners:
            biases = [b.contiguous() for _, b in list(sa_wb) + list(pn_wb)]
            sa_wb, pn_wb = bf16_wb(sa_wb), bf16_wb(pn_wb)
        args = _kernel_args("patch_encoder", patches, sa_wb, pn_wb, knn)
        if return_winners and any(b.data_ptr() % 16 for b in biases):
            raise ValueError("patch_encoder: biases must be 16-byte aligned")
        # the tensor-core layers' weights, packed once per weights
        frags = cached_frags([sa_wb[1][0], sa_wb[2][0]] + [w for w, _ in pn_wb[:3]], cat=True)
        cuda_lib.launch("patch_encoder_bf16", _BF16_ARGTYPES, patches.data_ptr(), P,
                        patches.shape[1], knn, *args, D, out.data_ptr(),
                        None if win is None else win.data_ptr(), cuda_lib.stream_ptr(patches),
                        *[None if b is None else b.data_ptr() for b in biases],
                        frags.data_ptr())
    else:
        args = _kernel_args("patch_encoder", patches, sa_wb, pn_wb, knn)
        cuda_lib.launch("patch_encoder", _ARGTYPES, patches.data_ptr(), P,
                        patches.shape[1], knn, *args, D, out.data_ptr(),
                        None if win is None else win.data_ptr(), cuda_lib.stream_ptr(patches))
    return (out, win) if return_winners else out


def winners_plain(p: torch.Tensor, idx: torch.Tensor, z4: torch.Tensor, sa_wb,
                  pn_wb, bf16: bool = False) -> torch.Tensor:
    """Each latent channel's winner as the kernels find it: the first point
    (lowest index) that reaches the channel's max over points, on the
    kernels' values. p [c, N, 3] patches, idx [c, N, knn] their
    neighbours, z4 [c, N, D] the plain pre-max latents -> [c, D] points. The
    points near a channel's max (within 1e-4 of its largest |entry| in
    float32; in bf16, where rounded values tie often and a rounding moves a
    value by 2^-8 of itself, within 2^-5) are recomputed in the kernels'
    arithmetic (fma_matmul), since ties and near-ties, which occur at
    training sizes, can resolve differently in any other summation order.
    bf16: pcc_tpu's bf16 backward's argmax (sa_pallas.py:392) on the
    rounded values of its replay (sa_wb, pn_wb: `replay_wb`)."""
    tol = 2.0 ** -5 if bf16 else 1e-4
    top = z4.amax(dim=1, keepdim=True)
    near = z4 >= top - tol * z4.abs().amax(dim=1, keepdim=True)
    # the candidate points of each patch, ascending, padded with the first
    cand = near.any(dim=-1)                                        # [c, N]
    R = int(cand.sum(dim=1).max())
    order = torch.sort((~cand).to(torch.int8), dim=1, stable=True).indices[:, :R]
    rows = torch.where(torch.gather(cand, 1, order), order, order[:, :1])
    z4r = _kernel_choices(p, idx, rows, sa_wb, pn_wb, bf16)[-1]
    z4r = torch.where(_gather_rows(near, rows), z4r, -torch.inf)   # [c, R, D]
    return torch.gather(rows, 1, z4r.max(dim=1).indices)           # first row


def _bwd_bf16_chunk(p, gc, idx, q, sa_rep, pn_rep):
    """pcc_tpu's bf16 backward (sa_pallas.py:288-470) of patches p [c, N, 3]
    against the cotangent gc [c, D], on the winning points q [c, D], written
    out as its dense_bwd chain: each distinct winning point one row (the
    channels it wins in its cotangent row), the forward replayed on the rows
    in the kernels' arithmetic (`_kernel_choices`); every input gradient
    round(dz) @ round(w).T (the weights arrive rounded, replay_wb), masked by
    its input's relu; every weight gradient x.T @ dz in float32 on the stored
    inputs (acts: xyz and the centred neighbours unrounded). Returns
    (dpatches [c, N, 3], [dw, db] * 7)."""
    c, D = q.shape
    acts = {}
    _, slot, live, _, _ = _kernel_choices(p, idx, q, sa_rep, pn_rep, True, acts)
    same = q[:, :, None] == q[:, None, :]                       # row r's point wins channel c'
    first = ~torch.tril(same, diagonal=-1).any(dim=-1)          # the first row of its point
    dz = gc[:, None, :] * (same & first[:, :, None])            # [c, D rows, D]

    def layer_grads(x, dz, w):
        """(dw, db, round(dz) @ round(w).T) of one layer (w rounded)."""
        dw = x.reshape(-1, x.shape[-1]).t() @ dz.reshape(-1, dz.shape[-1])
        return dw, dz.reshape(-1, dz.shape[-1]).sum(dim=0), round_bf16(dz) @ w.t()

    grads = []
    xs = acts["pn"]
    for i in reversed(range(len(pn_rep))):
        dw, db, dx = layer_grads(xs[i], dz, pn_rep[i][0])
        grads = [dw, db] + grads
        dz = dx * (xs[i] > 0) if i else dx
    dxyz, dfeats = dz[..., :3], dz[..., 3:]                     # [c, D, 3 / 128]
    knn = idx.shape[-1]
    slots = torch.arange(knn, device=p.device)[:, None]
    dz = torch.where((slot[:, :, None, :] == slots) & live[:, :, None, :],
                     dfeats[:, :, None, :], 0.0)                 # [c, D, knn, 128]
    xs = acts["sa"]
    sa_grads = []
    for i in reversed(range(len(sa_rep))):
        dw, db, dx = layer_grads(xs[i], dz, sa_rep[i][0])
        sa_grads = [dw, db] + sa_grads
        dz = dx * (xs[i] > 0) if i else dx
    # the gather transposed onto each neighbour, minus the centred term on
    # the query, plus the concat's xyz columns on the query
    nbr = torch.gather(idx, 1, q[..., None].expand(-1, -1, knn))             # [c, D, knn]
    dp = torch.zeros_like(p)
    dp.scatter_add_(1, nbr.reshape(c, -1, 1).expand(-1, -1, 3), dz.reshape(c, -1, 3))
    dp.scatter_add_(1, q[..., None].expand(-1, -1, 3), dxyz - dz.sum(dim=2))
    return dp, sa_grads + grads


def patch_encoder_bwd_plain(patches: torch.Tensor, g: torch.Tensor, sa_wb, pn_wb,
                            knn: int, winners=None, bf16: bool = False):
    """The encoder's gradient against the cotangent g [P, D], with the
    kernel's subgradient. Returns (dpatches [P, N, 3], dsa_wb, dpn_wb), the
    weight gradients summed over patches in the ([in, out], [out]) layout of
    sa_wb / pn_wb. bf16: pcc_tpu's bf16 backward (`_bwd_bf16_chunk`) on
    the float32 weights sa_wb / pn_wb, its winners those of
    `patch_encoder(..., bf16=True, return_winners=True)`.

    The gradient of latent channel c flows only through the point that wins
    its max over points (`winners` [P, D], the forward's, or else
    `winners_plain`), and within that point through the slot that wins
    each SetAbstraction channel's max, gated by the relu masks. The kernel
    makes these choices on its own float32 values, routing ties to the
    first point or slot; float32 ties and near-ties, which do occur at
    training sizes, can resolve differently in any other summation order. So
    the choices on the winning points are made by repeating the kernel's
    arithmetic (fma_matmul), and the gradients are then autograd through
    plain products on the winning points, with the relu and max replaced by
    those choices."""
    if bf16:
        sa_rep, pn_rep = replay_wb(sa_wb), replay_wb(pn_wb)
        dpatches, wgrads = [], None
        for s in range(0, patches.shape[0], PLAIN_CHUNK):
            p, gc = patches[s:s + PLAIN_CHUNK].detach(), g[s:s + PLAIN_CHUNK].detach()
            idx = select_nearest(sq_dists(p, p), knn)
            if winners is None:
                q = winners_plain(p, idx, pointwise_plain(p, idx, sa_rep, pn_rep, True),
                                  sa_rep, pn_rep, True)
            else:
                q = winners[s:s + PLAIN_CHUNK].long()
            dp, grads = _bwd_bf16_chunk(p, gc, idx, q, sa_rep, pn_rep)
            dpatches.append(dp)
            wgrads = grads if wgrads is None else [a + b for a, b in zip(wgrads, grads)]
        return (torch.cat(dpatches), *_unflatten(wgrads))
    leaves = [t.detach().requires_grad_(True) for t in _flatten(sa_wb, pn_wb)]
    sa, pn = _unflatten(leaves)
    dpatches, wgrads = [], None
    for s in range(0, patches.shape[0], PLAIN_CHUNK):
        p, gc = patches[s:s + PLAIN_CHUNK].detach(), g[s:s + PLAIN_CHUNK]
        with torch.no_grad():
            idx = select_nearest(sq_dists(p, p), knn)                      # [c, N, knn]
            if winners is None:
                q = winners_plain(p, idx, pointwise_plain(p, idx, sa_wb, pn_wb), sa_wb, pn_wb)
            else:
                q = winners[s:s + PLAIN_CHUNK].long()                      # [c, D]
            sa_masks, slot, live, pn_masks, _ = _kernel_choices(p, idx, q, sa_wb, pn_wb)
            nbr = torch.gather(idx, 1, q[..., None].expand(-1, -1, knn))  # [c, D, knn]
        with torch.enable_grad():
            pp = p.requires_grad_(True)
            xyz = torch.gather(pp, 1, q[..., None].expand(-1, -1, 3))     # [c, D, 3]
            h = knn_gather(pp, nbr) - xyz[:, :, None, :]
            for (w, b), m in zip(sa[:-1], sa_masks):
                h = (h @ w + b) * m
            w, b = sa[-1]
            z3 = h @ w + b                                                 # [c, D, knn, 128]
            feats = torch.gather(z3, 2, slot[:, :, None, :]).squeeze(2) * live
            x = torch.cat([xyz, feats], dim=-1)
            for (w, b), m in zip(pn[:-1], pn_masks):
                x = (x @ w + b) * m
            w, b = pn[-1]
            z4 = x @ w + b                                                 # [c, D rows, D]
            out = torch.diagonal(z4, dim1=1, dim2=2)                       # row c -> channel c
            grads = torch.autograd.grad(out, [pp] + leaves, grad_outputs=gc)
        dpatches.append(grads[0])
        wgrads = list(grads[1:]) if wgrads is None else [
            a + b for a, b in zip(wgrads, grads[1:])]
    return (torch.cat(dpatches), *_unflatten(wgrads))


def _bwd_workspace(P: int, knn: int, D: int):
    """Floats of the backward kernel's scratch (csrc/patch_encoder_bwd.cu::
    make_rows and its seven weight-gradient products): the winners' rows,
    D rounded up to ENC_Q slots a patch (PointNet: the layers' inputs and
    their pre-activations' gradients; SetAbstraction, knn rows a slot: the
    centred neighbour and the layers' inputs and gradients), the seven
    products' scratch, each its own, and PointNet's weights transposed."""
    pn = P * -(-D // ENC_Q) * ENC_Q
    sa = pn * knn
    c1, c2, c3 = SA_WIDTHS[1:]
    # x0 padded to 132 floats, x1..x3 and dz1..dz3, dz4 padded to a multiple of 4
    rows = (pn * (PN_WIDTHS[0] + 1 + 2 * sum(PN_WIDTHS[1:]) + ((D + 3) & ~3))
            + sa * (4 + 2 * c1 + 2 * c2 + c3))
    pn_widths = PN_WIDTHS + (D,)
    products = ([(sa, a, b) for a, b in zip(SA_WIDTHS[:-1], SA_WIDTHS[1:])]
                + [(pn, a, b) for a, b in zip(pn_widths[:-1], pn_widths[1:])])
    # the seven products' scratch side by side (one grouped launch), then
    # PointNet's weights transposed
    transposed = sum(a * b for a, b in zip(pn_widths[:-1], pn_widths[1:]))
    return rows, sum(wgrad_part_floats([pr]) for pr in products) + transposed


def patch_encoder_bwd(patches: torch.Tensor, g: torch.Tensor, sa_wb, pn_wb, knn: int,
                      winners=None, bf16: bool = False):
    """(dpatches, dsa_wb, dpn_wb) of the encoder against the cotangent g
    [P, D]: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors. winners [P, D] int32: each latent channel's first arg-max point,
    as `patch_encoder(..., return_winners=True)` gives them; when None, the
    wrapper gets them from one launch of the forward kernel (the plain
    version from `winners_plain`). bf16: the bf16 instance (launch counter
    "patch_encoder_bwd_bf16") on the float32 weights sa_wb / pn_wb, which it
    takes as replay_wb of them, with the winners of the bf16 forward."""
    if patches.device.type == "cpu":
        return patch_encoder_bwd_plain(patches, g, sa_wb, pn_wb, knn, winners=winners,
                                       bf16=bf16)
    if winners is None:
        winners = patch_encoder(patches, sa_wb, pn_wb, knn, return_winners=True, bf16=bf16)[1]
    leaves = _flatten(sa_wb, pn_wb)
    if bf16:
        sa_wb, pn_wb = replay_wb(sa_wb), replay_wb(pn_wb)
    args = _kernel_args("patch_encoder_bwd", patches, sa_wb, pn_wb, knn)
    P, N, _ = patches.shape
    D = pn_wb[-1][0].shape[1]
    cuda_lib.require_cuda("patch_encoder_bwd cotangent", g, torch.float32, 2)
    if g.shape != (P, D):
        raise ValueError(f"patch_encoder_bwd: cotangent {tuple(g.shape)} != {(P, D)}")
    cuda_lib.require_cuda("patch_encoder_bwd winners", winners, torch.int32, 2)
    if winners.shape != (P, D):
        raise ValueError(f"patch_encoder_bwd: winners {tuple(winners.shape)} != {(P, D)}")
    total = sum(t.numel() for t in leaves)
    dpatches = torch.empty_like(patches)
    grads = torch.empty(total, dtype=torch.float32, device=patches.device)
    rows, part = (torch.empty(n, dtype=torch.float32, device=patches.device)
                  for n in _bwd_workspace(P, knn, D))
    cuda_lib.launch("patch_encoder_bwd_bf16" if bf16 else "patch_encoder_bwd", _BWD_ARGTYPES,
                    patches.data_ptr(), g.data_ptr(), winners.data_ptr(), P, N, knn, *args, D,
                    dpatches.data_ptr(), grads.data_ptr(), rows.data_ptr(), part.data_ptr(),
                    part.numel(), cuda_lib.stream_ptr(patches))
    flat = list(torch.split(grads, [t.numel() for t in leaves]))
    flat = [f.view(t.shape) for f, t in zip(flat, leaves)]
    return (dpatches, *_unflatten(flat))


class PatchEncoderFn(torch.autograd.Function):
    """The encoder with its backward kernel: forward `patch_encoder`, which
    also hands over each latent channel's winning point, saved for the
    backward `patch_encoder_bwd` (pcc_tpu's custom VJP,
    sa_pallas.py::_make_trainable_encoder). Arguments: knn, bf16, patches,
    then the 14 weights and biases (float32; in bf16 each kernel rounds
    them where pcc_tpu's does)."""

    @staticmethod
    def forward(ctx, knn, bf16, patches, *wb):
        ctx.knn, ctx.bf16 = knn, bf16
        sa, pn = _unflatten(wb)
        latent, winners = patch_encoder(patches, sa, pn, knn, return_winners=True, bf16=bf16)
        ctx.save_for_backward(patches, winners, *wb)
        return latent

    @staticmethod
    def backward(ctx, g):
        patches, winners, *wb = ctx.saved_tensors
        sa, pn = _unflatten(wb)
        dpatches, dsa, dpn = patch_encoder_bwd(patches, g.contiguous(), sa, pn, ctx.knn,
                                               winners=winners, bf16=ctx.bf16)
        return (None, None, dpatches, *_flatten(dsa, dpn))


def patch_encoder_trainable(patches: torch.Tensor, sa_wb, pn_wb, knn: int,
                            bf16: bool = False) -> torch.Tensor:
    """Differentiable encoder [P, N, 3] -> [P, D] (pcc_tpu's
    patch_encoder_trainable, compute_dtype bfloat16 with bf16): the kernels
    on CUDA tensors, the plain versions on CPU tensors, the same latents as
    `patch_encoder`."""
    return PatchEncoderFn.apply(knn, bf16, patches, *_flatten(sa_wb, pn_wb))
