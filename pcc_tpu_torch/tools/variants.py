"""Kernel sources built with text edits, for the breakdown tools, which time
a kernel as it is and with one part taken out or one choice changed.

A variant is a kernel name of ops/cuda_lib.py's KERNELS and a list of
alternatives, each a list of (old, new) replacements in that kernel's
source: the first alternative whose old texts all occur in the source
applies (a tool may list the texts of several revisions of a kernel), and
`[[]]` is the source as it is. `build_variants` builds every variant by its
own nvcc process, all started together, from a copy of csrc/ in a
temporary directory, with the flags the kernel is built with.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

from pcc_tpu_torch.ops import cuda_lib


def edited(kernel: str, alternatives) -> str | None:
    """The source of `kernel` with the first of `alternatives` whose old
    texts all occur in it applied; None where none does."""
    with open(os.path.join(cuda_lib.CSRC_DIR, cuda_lib.KERNELS[kernel][0])) as f:
        text = f.read()
    for edits in alternatives:
        if all(old in text for old, _ in edits):
            for old, new in edits:
                text = text.replace(old, new)
            return text
    return None


def build_variants(tmp: str, variants: dict) -> dict:
    """{label: (kernel, alternatives)} -> {label: its library (ctypes)},
    built under tmp. A variant none of whose alternatives applies is left
    out, with a line printed; raises with nvcc's output if a build fails."""
    procs = {}
    for i, (label, (kernel, alternatives)) in enumerate(variants.items()):
        src, flags = cuda_lib.KERNELS[kernel]
        text = edited(kernel, alternatives)
        if text is None:
            print(f"variant {label}: its texts are not in this {src}; left out", flush=True)
            continue
        d = os.path.join(tmp, f"v{i}")
        os.makedirs(d)
        for f in os.listdir(cuda_lib.CSRC_DIR):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(cuda_lib.CSRC_DIR, f), d)
        with open(os.path.join(d, src), "w") as f:
            f.write(text)
        so = os.path.join(d, "variant.so")
        cmd = [cuda_lib._nvcc(), *cuda_lib._NVCC_FLAGS, *flags, "-o", so, os.path.join(d, src)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), so)
    libs = {}
    for label, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {label}:\n{out}")
        libs[label] = ctypes.CDLL(so)
    return libs


def entry(lib, kernel: str, argtypes):
    """The C entry point `<kernel>_launch` of a variant's library, typed."""
    fn = getattr(lib, f"{kernel}_launch")
    fn.restype, fn.argtypes = ctypes.c_int, argtypes
    return fn
