"""ctypes bindings for the native (C++) host-side codecs.

The port of ``groth_sahai_tpu/utils/native.py``. The IO path's bulk byte <->
limb conversion and scalar digit extraction run in the port's own copy of
``limbs.cpp`` (``groth_sahai_tpu_torch/csrc/``) at memory bandwidth; the
Python loops cost seconds for MSM-sized batches. At first use g++ builds it
into ``groth_sahai_tpu_torch/build/`` under a name that hashes the source
and flags (as :mod:`..ops.cuda_build` names the kernel libraries), through a
per-process temporary name renamed into place, so concurrent builders never
load a half-written library. A failed build raises: there is no fallback
and no switch to turn the build off. The numpy versions (``*_plain``) are
the plain versions the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..ops.cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / "limbs.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_LIB = None


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgslimbs-{h.hexdigest()[:12]}.so"


def _build(out) -> None:
    """One g++ invocation into a per-process name, renamed into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}) building "
                           f"{out.name}:\n{res.stderr}")
    tmp.replace(out)


def _load():
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.bytes_to_limbs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.limbs_to_bytes.argtypes = lib.bytes_to_limbs.argtypes
        lib.scalar_digits.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        _LIB = lib
    return _LIB


def bytes_to_limbs(data: bytes, nbytes: int, n_limbs: int) -> np.ndarray:
    """Packed LE field-element bytes -> uint32[n_limbs, batch]."""
    batch = len(data) // nbytes
    out = np.empty((n_limbs, batch), dtype=np.uint32)
    buf = np.frombuffer(data, dtype=np.uint8)
    _load().bytes_to_limbs(buf.ctypes.data, out.ctypes.data,
                           batch, nbytes, n_limbs)
    return out


def limbs_to_bytes(limbs: np.ndarray, nbytes: int) -> bytes:
    """uint32[n_limbs, batch] -> packed LE bytes (batch x nbytes)."""
    limbs = np.ascontiguousarray(limbs, dtype=np.uint32)
    n_limbs, batch = limbs.shape
    out = np.zeros(batch * nbytes, dtype=np.uint8)
    _load().limbs_to_bytes(limbs.ctypes.data, out.ctypes.data,
                           batch, nbytes, n_limbs)
    return out.tobytes()


def scalar_digits(limbs: np.ndarray, window: int) -> np.ndarray:
    """uint32[n_limbs, batch] scalars -> uint32[n_windows, batch] digits."""
    limbs = np.ascontiguousarray(limbs, dtype=np.uint32)
    n_limbs, batch = limbs.shape
    n_windows = -(-256 // window)
    out = np.empty((n_windows, batch), dtype=np.uint32)
    _load().scalar_digits(limbs.ctypes.data, out.ctypes.data,
                          batch, n_limbs, window, n_windows)
    return out


# ---------------------------------------------------------------- plain versions

def bytes_to_limbs_plain(data: bytes, nbytes: int, n_limbs: int) -> np.ndarray:
    batch = len(data) // nbytes
    out = np.empty((n_limbs, batch), dtype=np.uint32)
    arr = np.frombuffer(data, dtype=np.uint8).reshape(batch, nbytes)
    for l in range(n_limbs):
        lo = arr[:, 2 * l] if 2 * l < nbytes else 0
        hi = arr[:, 2 * l + 1].astype(np.uint32) << 8 \
            if 2 * l + 1 < nbytes else 0
        out[l] = lo + hi
    return out


def limbs_to_bytes_plain(limbs: np.ndarray, nbytes: int) -> bytes:
    limbs = np.ascontiguousarray(limbs, dtype=np.uint32)
    n_limbs, batch = limbs.shape
    out = np.zeros(batch * nbytes, dtype=np.uint8)
    view = out.reshape(batch, nbytes)
    for l in range(n_limbs):
        if 2 * l < nbytes:
            view[:, 2 * l] = limbs[l] & 0xFF
        if 2 * l + 1 < nbytes:
            view[:, 2 * l + 1] = (limbs[l] >> 8) & 0xFF
    return out.tobytes()


def scalar_digits_plain(limbs: np.ndarray, window: int) -> np.ndarray:
    limbs = np.ascontiguousarray(limbs, dtype=np.uint32)
    n_limbs, batch = limbs.shape
    n_windows = -(-256 // window)
    out = np.empty((n_windows, batch), dtype=np.uint32)
    mask = (1 << window) - 1
    for k in range(n_windows):
        lo_bit = k * window
        li, off = lo_bit // 16, lo_bit % 16
        d = limbs[li] >> off if li < n_limbs else np.zeros(batch, np.uint32)
        have = 16 - off
        if have < window and li + 1 < n_limbs:
            d = d | (limbs[li + 1] << have)
        out[k] = d & mask
    return out
