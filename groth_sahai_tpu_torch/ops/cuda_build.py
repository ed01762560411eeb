"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel source in ``groth_sahai_tpu_torch/csrc/`` is one shared library
with a plain C interface: at first use on a card, ``nvcc`` compiles it for
``sm_90a`` into ``groth_sahai_tpu_torch/build/`` (named by a hash of the
sources and flags) and ``ctypes`` loads it. `build_all` starts one ``nvcc``
per library at once. The compiler's resource report (``-Xptxas -v``:
registers, stack, spills) is kept beside each library as ``.log``.

Also the helpers the wrappers share: the CPU/CUDA dispatch test, the
checks on a CUDA limb tensor, the launch status and the stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import torch

from .limbs import int_to_limbs

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else "nvcc"


class KernelLibrary:
    """One kernel source (plus the headers it includes) as a ctypes library."""

    def __init__(self, stem: str, source: str, headers, argtypes: dict):
        self.stem = stem
        self.sources = (CSRC / source,) + tuple(CSRC / h for h in headers)
        self.argtypes = argtypes
        self.lib = None

    def path(self) -> pathlib.Path:
        h = hashlib.sha256()
        for src in self.sources:
            h.update(src.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.stem}-{h.hexdigest()[:12]}.so"

    def _start(self):
        """Start nvcc for this library unless it is built; returns the job."""
        out = self.path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")   # one per process
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.sources[0])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    @staticmethod
    def _finish(job):
        proc, tmp, out = job
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{out.name}:\n{log}")
        out.with_suffix(".log").write_text(log)
        tmp.replace(out)

    def _load(self):
        lib = ctypes.CDLL(str(self.path()))
        for name, argtypes in self.argtypes.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib = lib

    def get(self):
        """The loaded library, built at first use."""
        if self.lib is None:
            build_all([self])
        return self.lib


def build_all(libraries) -> list:
    """Build the libraries not built yet, one nvcc each, all at once; load
    them. Returns their paths."""
    jobs = [j for j in (lib._start() for lib in libraries) if j is not None]
    errors = []
    for job in jobs:
        try:
            KernelLibrary._finish(job)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libraries:
        if lib.lib is None:
            lib._load()
    return [lib.path() for lib in libraries]


# ------------------------------------------------------------ launch helpers

def on_cpu(*xs) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def lanes(x, rows: int, what: str):
    """Check a CUDA limb tensor and flatten it to a contiguous (rows, M)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"{what}: expected int64 limbs, got {x.dtype}")
    if x.shape[0] != rows:
        raise ValueError(f"{what}: expected {rows} limb rows, got {x.shape[0]}")
    return x.contiguous().reshape(rows, -1)


def check(rc: int, name: str, nl: int):
    if rc == -1:
        raise ValueError(f"{name}: no kernel instantiated for {nl} limbs")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def host_words(field, value: int) -> int:
    """Address of `value`'s limbs as a host uint32 array (p or R mod p),
    made once per field; the C entry copies them into the kernel's
    parameters."""
    key = ("ctypes", value)
    if key not in field._consts:
        field._consts[key] = (ctypes.c_uint32 * field.n)(
            *[int(x) for x in int_to_limbs(value, field.n)])
    return ctypes.addressof(field._consts[key])
