"""Hand-written Hopper kernels of the field core, with their plain versions.

The port of ``groth_sahai_tpu/ops/pallas_fp.py``. Four kernels, written in
CUDA C++ for ``sm_90a`` in ``csrc/fp_kernels.cu``: ``mul_wide`` and
``redc`` over the in-thread field library ``csrc/field.cuh`` (the port of
``ops/pallas_reg.py``); ``mont_mul`` (Fq and Fr) and ``pow_const`` over
Fq on packed 32-bit words (``csrc/field_w32.cuh``), each Montgomery
product split over a group of threads (``csrc/field_split_w32.cuh``; Fr's
``pow_const`` keeps the one-thread 16-bit body):

  ==========  =========================================  =======================
  wrapper     replaces (TPU kernel)                      computes
  ==========  =========================================  =======================
  mont_mul    pallas_fp.py:mont_mul (_mont_mul_kernel)   a*b*R^-1 mod p, < 2p
  mul_wide    pallas_fp.py:mul_wide (_mul_wide_kernel)   exact 2n+1-limb a*b
  redc        pallas_fp.py:redc (_redc_kernel)           t*R^-1 mod p, < 2p
  pow_const   pallas_fp.py:pow_const (_pow_chain_kernel) a^e, one launch
  ==========  =========================================  =======================

What bounds them on the H100: each launch reads its inputs and writes its
output once, as int64 limbs (8 bytes per 16-bit limb, the port's tensor
contract). At the pairing path's 8192-lane batches a launch moves a few MB
and does ~1e7 32-bit multiply-adds, so `mont_mul`, `mul_wide` and `redc`
are bound by device-memory bytes and, below that, by launch overhead and
at narrow calls by one product's latency: `mont_mul` splits each product
over a group of threads, so that its widest calls spread over every SM and
its narrow ones wait on a shorter chain. `pow_const` (610 dependent
Montgomery products per lane for a Fermat inverse) runs over 2 to 8192
lanes, too few to fill the card: one product's latency sets its time,
which the split over a group of threads shortens.

Dispatch rule: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. There is no fallback and no switch.

Each wrapper counts its launches in a plain int attribute, ``launches``,
raised by one where it launches its kernel and nowhere else.

Build: at first use on a card (see :mod:`.cuda_build`), ``nvcc`` compiles
``csrc/fp_kernels.cu`` into a plain-C library loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import KernelLibrary, check, host_words, lanes, on_cpu, stream
from .limbs import MASK, W, int_to_limbs

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
LIBRARY = KernelLibrary("gs_fp", "fp_kernels.cu",
                        ["field.cuh", "field_w32.cuh", "field_split_w32.cuh",
                         "group_w32.cuh"], {
    "gs_mont_mul": [_I, _P, _P, _P, _I64, _P, _U32, _P],
    "gs_mul_wide": [_I, _P, _P, _P, _I64, _P],
    "gs_redc": [_I, _P, _P, _I64, _P, _U32, _P],
    "gs_pow_const": [_I, _P, _P, _I, _P, _I64, _P, _P, _U32, _P],
})


def exponent_bits(e: int) -> list:
    """MSB-first bit string of e (the chain's schedule)."""
    n = e.bit_length()
    return [(e >> (n - 1 - i)) & 1 for i in range(n)]


# ---------------------------------------------------------------- plain versions
#
# The same functions in PyTorch, on int64 limbs. The CPU path runs them and
# `chip_smoke.py` holds each kernel against them on the card. They compute
# the same unique values by another route (whole-column products and the
# Montgomery quotient M = -t p^-1 mod R at once), so the limbs agree.

# Lanes from which `_columns` adds shifted rows instead of gathering the
# whole outer product: n row operations on (n, lanes) tensors beat one
# gather over n^2 products once the products stop fitting in cache.
SHIFT_ADD_LANES = 256


def _columns(field, a, b, rows: int):
    """Un-carried product columns sum_{i+j=k, k<rows} a_i b_j (each < n 2^32)."""
    n = a.shape[0]
    if a[0].numel() >= SHIFT_ADD_LANES:
        cols = torch.zeros((rows,) + a.shape[1:], dtype=torch.int64,
                           device=a.device)
        for i in range(min(n, rows)):
            k = min(n, rows - i)
            cols[i:i + k] += a[i] * b[:k]
        return cols

    def pairs():
        i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        return (i * n + j)[(i + j) < rows]

    src = field._cached(("col_src", n, rows), a.device, pairs)
    dst = field._cached(("col_dst", n, rows), a.device,
                        lambda: pairs() // n + pairs() % n)
    prod = (a.unsqueeze(1) * b.unsqueeze(0)).reshape((n * n,) + a.shape[1:])
    cols = torch.zeros((rows,) + a.shape[1:], dtype=torch.int64,
                       device=a.device)
    if rows < 2 * n - 1:                 # else every pair lands: src = all
        prod = prod.index_select(0, src)
    return cols.index_add_(0, dst, prod)


def mul_wide_plain(field, a, b):
    return field._carry(_columns(field, a, b, 2 * field.n + 1), bits=38)


def _toeplitz(field, value: int, rows: int, device):
    """float64 (rows, n) matrix T with T[k, j] = limb k - j of `value`, made
    once per device: T @ x gives the product columns of `value` and x (x's
    limbs on axis 0), exact while every column stays below 2^53."""
    key = (("toeplitz", value, rows), device)
    t = field._consts.get(key)
    if t is None:
        c = int_to_limbs(value, field.n).astype(np.int64)
        k = np.arange(rows)[:, None] - np.arange(field.n)[None, :]
        t = torch.as_tensor(np.where((k >= 0) & (k < field.n),
                                     c[np.clip(k, 0, field.n - 1)], 0),
                            dtype=torch.float64, device=device)
        field._consts[key] = t
    return t


def _const_columns(field, value: int, x, rows: int):
    """Product columns of a constant and x (limbs < 2^16 on axis 1; any
    leading stack axis rides along) by one float64 matrix product: each
    column is < n 2^32, exact."""
    T = _toeplitz(field, value, rows, x.device)
    shape = x.shape[:1] + (rows,) + x.shape[2:]
    xf = x.reshape(x.shape[0], field.n, -1).to(torch.float64)
    return (T @ xf).to(torch.int64).reshape(shape)


def _redc_columns(field, t, bits: int):
    """(t + M p) / R for M = -t p^-1 mod R, from the 2n+1 columns of t,
    carried or not (each column < 2^bits, bits <= 37). M depends on t mod
    R alone, which t's low n columns give without a carry: split into
    16-bit pieces, each piece's product with p^-1 is exact in float64."""
    n = field.n
    low = t[:n]
    pieces = torch.stack([low & MASK, (low >> W) & MASK,
                          low >> (2 * W)][:-(-bits // W)])
    y = _const_columns(field, field.nprime, pieces, n)
    cols = y[0]                                 # columns of low n' mod R
    for s in range(1, y.shape[0]):
        cols[s:] += y[s, :n - s]
    m = field._carry(cols, bits=39)             # M = -t p^-1 mod R
    cols = _const_columns(field, field.p, m[None], 2 * n + 1)[0] + t
    return field._carry(cols, bits=38)[n:2 * n]   # (t + M p) / R


def redc_plain(field, t):
    return _redc_columns(field, t, 16)


def mont_mul_plain(field, a, b):
    """redc of a*b, straight from the product's columns (< n 2^32)."""
    return _redc_columns(field, _columns(field, a, b, 2 * field.n + 1), 37)


def pow_const_plain(field, a, e: int):
    acc = field.one(a.shape[1:], device=a.device)
    for bit in exponent_bits(e):
        acc = mont_mul_plain(field, acc, acc)
        if bit:
            acc = mont_mul_plain(field, acc, a)
    return acc


# --------------------------------------------------------------------- wrappers

def mont_mul(field, a, b):
    """Fused CIOS Montgomery product a*b*R^-1 mod p (same-shape inputs).

    Replaces pallas_fp.py:mont_mul (_mont_mul_kernel). Needs
    value(a)*value(b) <= 2^16 p^2; output < 2p.
    """
    if on_cpu(a, b):
        return mont_mul_plain(field, a, b)
    nl = field.n
    a2 = lanes(a, nl, "mont_mul a")
    b2 = lanes(b, nl, "mont_mul b")
    out = torch.empty_like(a2)
    m = a2.shape[1]
    if m:
        check(LIBRARY.get().gs_mont_mul(
            nl, a2.data_ptr(), b2.data_ptr(), out.data_ptr(), m,
            host_words(field, field.p),
            field.n0, stream(a2)), "mont_mul", nl)
        mont_mul.launches += 1
    return out.reshape(a.shape)


def mul_wide(field, a, b):
    """Exact 2n+1-limb product (same-shape inputs).

    Replaces pallas_fp.py:mul_wide (_mul_wide_kernel).
    """
    if on_cpu(a, b):
        return mul_wide_plain(field, a, b)
    nl = field.n
    a2 = lanes(a, nl, "mul_wide a")
    b2 = lanes(b, nl, "mul_wide b")
    m = a2.shape[1]
    out = torch.empty((2 * nl + 1, m), dtype=torch.int64, device=a2.device)
    if m:
        check(LIBRARY.get().gs_mul_wide(
            nl, a2.data_ptr(), b2.data_ptr(), out.data_ptr(), m,
            stream(a2)), "mul_wide", nl)
        mul_wide.launches += 1
    return out.reshape((2 * nl + 1,) + a.shape[1:])


def redc(field, t):
    """Montgomery reduction of a wide value t < p*R; output < 2p.

    Replaces pallas_fp.py:redc (_redc_kernel).
    """
    if on_cpu(t):
        return redc_plain(field, t)
    nl = field.n
    t2 = lanes(t, 2 * nl + 1, "redc t")
    m = t2.shape[1]
    out = torch.empty((nl, m), dtype=torch.int64, device=t2.device)
    if m:
        check(LIBRARY.get().gs_redc(
            nl, t2.data_ptr(), out.data_ptr(), m,
            host_words(field, field.p),
            field.n0, stream(t2)), "redc", nl)
        redc.launches += 1
    return out.reshape((nl,) + t.shape[1:])


def pow_const(field, a, e: int):
    """a^e (Montgomery in/out, e > 0) as one square-and-multiply chain.

    Replaces pallas_fp.py:pow_const (_pow_chain_kernel): MSB-first, from
    R mod p, square then multiply on set bits.
    """
    assert e > 0
    if on_cpu(a):
        return pow_const_plain(field, a, e)
    nl = field.n
    a2 = lanes(a, nl, "pow_const a")
    m = a2.shape[1]
    out = torch.empty_like(a2)
    if m:
        bits = field._cached(("bits", e), a2.device, lambda: exponent_bits(e))
        check(LIBRARY.get().gs_pow_const(
            nl, a2.data_ptr(), bits.data_ptr(), bits.numel(), out.data_ptr(),
            m, host_words(field, field.p), host_words(field, field.r_mod_p),
            field.n0, stream(a2)), "pow_const", nl)
        pow_const.launches += 1
    return out.reshape(a.shape)


KERNELS = (mont_mul, mul_wide, redc, pow_const)
PLAIN = {mont_mul: mont_mul_plain, mul_wide: mul_wide_plain,
         redc: redc_plain, pow_const: pow_const_plain}
for _k in KERNELS:
    _k.launches = 0


def reset_counts():
    for k in KERNELS:
        k.launches = 0
