"""Range coding of the quantized latents under integer CDF rows
(the PyTorch port's copy of pcc_tpu/coding/rangecoder.py), and of symbols
under float CDFs quantized to such rows (`quantize_cdf`, the PPPE entropy
stream's histogram PMF).

The coder is the C++ range coder in _native/rangecoder.cpp, built with g++
at first use into that folder and loaded with ctypes. A failed build raises:
the pure-Python mirror below exists only as the tests' cross-check, never as
a silent substitute.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

PRECISION = 16

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "_native")
_SRC = os.path.join(_NATIVE_DIR, "rangecoder.cpp")
_LIB_PATH = os.path.join(_NATIVE_DIR, "librangecoder.so")
_lib = None


def _load_native():
    """Build (when missing or older than its source) and load the coder."""
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
        # build beside the target and rename: concurrent first uses (test
        # workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_NATIVE_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", tmp, _SRC],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building the range coder failed:\n{proc.stderr}")
            os.replace(tmp, _LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.rc_encode.restype = ctypes.c_int64
    lib.rc_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.rc_decode.restype = ctypes.c_int64
    lib.rc_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def quantize_cdf(cdf_float: np.ndarray) -> np.ndarray:
    """[..., Lp] float CDFs (leading 0, last about 1) -> int32 rows
    (pcc_tpu's quantize_cdf): scaled to 2^16 - Lp and rounded, made
    monotone by a running maximum, plus a +arange staircase, so that every
    symbol keeps a probability of at least 2^-16 (torchac's guard) and every
    row totals 2^16 - 1."""
    cdf_float = np.asarray(cdf_float, dtype=np.float64)
    Lp = cdf_float.shape[-1]
    scaled = np.round(np.clip(cdf_float, 0.0, 1.0) * ((1 << PRECISION) - Lp))
    scaled = np.maximum.accumulate(scaled, axis=-1)
    return (scaled + np.arange(Lp)).astype(np.int32)


def encode_float_cdf(cdf_float: np.ndarray, sym: np.ndarray) -> bytes:
    """Encode int symbols [n] under per-slot float CDFs [n, Lp]
    (the reference's torchac.encode_float_cdf API)."""
    return encode_quantized_cdf(quantize_cdf(cdf_float), sym)


def decode_float_cdf(cdf_float: np.ndarray, byte_stream: bytes) -> np.ndarray:
    """Decode bytes into int16 symbols shaped like cdf_float.shape[:-1]."""
    return decode_quantized_cdf(quantize_cdf(cdf_float), byte_stream)


def encode_quantized_cdf(cdf_int: np.ndarray, sym: np.ndarray) -> bytes:
    """Encode int symbols [...] under per-slot integer CDF rows [..., Lp]."""
    cdf = np.ascontiguousarray(
        np.asarray(cdf_int, dtype=np.int32).reshape(-1, cdf_int.shape[-1]))
    syms = np.ascontiguousarray(np.asarray(sym, dtype=np.int16).reshape(-1))
    n, Lp = cdf.shape
    if syms.shape[0] != n:
        raise ValueError(f"{syms.shape[0]} symbols for {n} CDF rows")
    lib = _load_native()
    cap = max(1024, 4 * n)
    out = np.zeros(cap, dtype=np.uint8)
    written = lib.rc_encode(cdf.ctypes.data, n, Lp, syms.ctypes.data,
                            out.ctypes.data, cap)
    if written < 0:
        raise ValueError("range coder encode failed (bad symbol or overflow)")
    return out[:written].tobytes()


def decode_quantized_cdf(cdf_int: np.ndarray, byte_stream: bytes) -> np.ndarray:
    """Decode bytes into int16 symbols shaped like cdf_int.shape[:-1]."""
    shape = cdf_int.shape[:-1]
    cdf = np.ascontiguousarray(
        np.asarray(cdf_int, dtype=np.int32).reshape(-1, cdf_int.shape[-1]))
    n, Lp = cdf.shape
    lib = _load_native()
    syms = np.zeros(n, dtype=np.int16)
    buf = np.ascontiguousarray(np.frombuffer(byte_stream, dtype=np.uint8))
    rc = lib.rc_decode(cdf.ctypes.data, n, Lp, buf.ctypes.data, len(buf),
                       syms.ctypes.data)
    if rc != 0:
        raise ValueError("range coder decode failed")
    return syms.reshape(shape)


# ---------------------------------------------------------------------------
# Pure-Python mirror of the C++ coder: the tests' cross-check only.
# ---------------------------------------------------------------------------

_TOP = 1 << 24
_M32 = 0xFFFFFFFF


def py_encode(cdf: np.ndarray, syms: np.ndarray) -> bytes:
    cdf = np.asarray(cdf).reshape(-1, cdf.shape[-1])
    syms = np.asarray(syms).reshape(-1)
    out = bytearray()
    low = 0          # uint64 semantics
    rng = _M32
    cache = 0
    cache_size = 1

    def shift_low():
        nonlocal low, cache, cache_size
        if (low & _M32) < 0xFF000000 or (low >> 32) != 0:
            carry = low >> 32
            b = cache
            while True:
                out.append((b + carry) & 0xFF)
                b = 0xFF
                cache_size -= 1
                if cache_size == 0:
                    break
            cache = (low >> 24) & 0xFF
        cache_size += 1
        low = ((low & _M32) << 8) & _M32

    for i in range(cdf.shape[0]):
        row = cdf[i]
        s = int(syms[i])
        start, size, total = int(row[s]), int(row[s + 1] - row[s]), int(row[-1])
        rng //= total
        low += start * rng
        rng *= size
        while rng < _TOP:
            shift_low()
            rng = (rng << 8) & _M32
    for _ in range(5):
        shift_low()
    return bytes(out)


def py_decode(cdf: np.ndarray, byte_stream: bytes) -> np.ndarray:
    shape = cdf.shape[:-1]
    cdf = np.asarray(cdf).reshape(-1, cdf.shape[-1])
    data = byte_stream
    pos = 0
    code = 0         # uint32 semantics
    rng = _M32

    def get():
        nonlocal pos
        b = data[pos] if pos < len(data) else 0
        pos += 1
        return b

    for _ in range(5):
        code = ((code << 8) | get()) & _M32
    n, Lp = cdf.shape
    syms = np.zeros(n, dtype=np.int16)
    for i in range(n):
        row = cdf[i]
        total = int(row[-1])
        rng //= total
        target = min(code // rng, total - 1)
        s = int(np.searchsorted(row, target, side="right")) - 1
        s = min(max(s, 0), Lp - 2)
        start, size = int(row[s]), int(row[s + 1] - row[s])
        code = (code - start * rng) & _M32
        rng *= size
        while rng < _TOP:
            code = ((code << 8) | get()) & _M32
            rng = (rng << 8) & _M32
        syms[i] = s
    return syms.reshape(shape)
