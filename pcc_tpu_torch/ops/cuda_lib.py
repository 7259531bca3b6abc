"""Build, load and launch the port's CUDA kernels (pcc_tpu_torch/csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface, at first use, into pcc_tpu_torch/_build/ (git-ignored),
and loaded with ctypes. The library's file name carries a hash of its source
and flags, so an edited source is rebuilt and a stale library never loads.
Importing this module needs neither nvcc nor a card.

Every C entry point launches on the stream it is given and returns
cudaGetLastError() as an int; the wrappers raise on a non-zero value. Two
kernels may share a source (fps and fps_int, the float32 and int32
instances of csrc/fps.cu; the float32 and bf16 instances of the encoder,
its backward, the decoder, SetAbstraction alone, the stage kernel (its
"pppe" layout and its store mode) and the stage backward): they share its
library, and each has its own
entry point `<name>_launch` and its own launch count.
`launches` counts, per kernel, the launches the wrappers made, so a run can
show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> (source in csrc/, extra nvcc flags)
KERNELS = {
    # FPS indices must be bit-equal to the plain version: no FMA contraction
    "fps": ("fps.cu", ("--fmad=false",)),
    "fps_int": ("fps.cu", ("--fmad=false",)),
    "patch_encoder": ("patch_encoder.cu", ()),
    "patch_decoder": ("patch_decoder.cu", ()),
    "patch_encoder_bwd": ("patch_encoder_bwd.cu", ()),
    "pppf_sa_stage": ("pppf_sa_stage.cu", ()),
    # the bf16 instances of the encoder, the decoder and the "pppf" stage
    "patch_encoder_bf16": ("patch_encoder.cu", ()),
    "patch_decoder_bf16": ("patch_decoder.cu", ()),
    "pppf_sa_stage_bf16": ("pppf_sa_stage.cu", ()),
    "pppf_sa_stage_bf16_save": ("pppf_sa_stage.cu", ()),
    "patch_encoder_bwd_bf16": ("patch_encoder_bwd.cu", ()),
    "pppf_sa_stage_bwd": ("pppf_sa_stage_bwd.cu", ()),
    "pppf_sa_stage_bwd_bf16": ("pppf_sa_stage_bwd.cu", ()),
    # chamfer indices must be bit-equal to the plain version, as FPS's
    "chamfer_fwd": ("chamfer_fwd.cu", ("--fmad=false",)),
    "chamfer_bwd": ("chamfer_bwd.cu", ("--fmad=false",)),
    "sa_fused": ("sa_fused.cu", ()),
    # the bf16 instances of SetAbstraction alone and of the "pppe" stage
    "sa_fused_bf16": ("sa_fused.cu", ()),
    "pppe_sa_stage_bf16": ("pppf_sa_stage.cu", ()),
    # XLA's bf16 reduction (bf16 training's bias gradients), order for order
    "bf16_reduce": ("bf16_reduce.cu", ()),
    # certified.cuh's tensor-core sums beside the k-order ones, for its check
    "cert_model": ("cert_model.cu", ()),
}
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = {name: 0 for name in KERNELS}
build_log: dict[str, str] = {}   # kernel name -> nvcc/ptxas output of its build
_functions: dict[str, object] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "at first use on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    src, flags = KERNELS[name]
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for part in [src, *headers]:
        with open(os.path.join(CSRC_DIR, part), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_NVCC_FLAGS + flags).encode())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:12]}.so")


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together. Returns the seconds each
    build took, by the first name of each source; raises with nvcc's output
    if one fails."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    running, paths = {}, set()
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path) or path in paths:
            continue
        paths.add(path)
        src, flags = KERNELS[name]
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_NVCC_FLAGS, *flags, "-o", tmp,
               os.path.join(CSRC_DIR, src)]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, path, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, path, t0) in running.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def function(name: str, argtypes):
    """The C entry point `<name>_launch` of kernel `name`, built if needed."""
    fn = _functions.get(name)
    if fn is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build([name])
        fn = getattr(ctypes.CDLL(path), f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _functions[name] = fn
    return fn


def launch(name: str, argtypes, *args) -> None:
    """Call kernel `name`'s entry point, raise on a CUDA error, count it."""
    err = function(name, argtypes)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: "
                           f"cudaError_t {err}")
    launches[name] += 1


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor `t`'s device, as an integer handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, t, dtype, ndim: int) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `ndim`."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


PTR = ctypes.c_void_p
INT = ctypes.c_int
