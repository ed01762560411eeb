"""Limb-sliced prime-field arithmetic on PyTorch tensors.

The port of ``groth_sahai_tpu/ops/fp.py``. A field element is
``int64[n, *batch]`` of exact 16-bit limbs, little-endian along axis 0 (see
:mod:`groth_sahai_tpu_torch.ops.limbs`), in Montgomery form
(``x_bar = x * R mod p``, ``R = 2^(16 n)``). ``int64`` because a 16x16-bit
limb product overflows ``int32`` and ``torch.uint32`` has no add, shift or
compare in PyTorch.

Redundant representation (the reference's bound discipline, unchanged)
----------------------------------------------------------------------
  * `mul`/`sqr` outputs are < 2p (Montgomery, no conditional subtraction);
  * `add(a, b)` = a + b (bounds add; single carry pass, no reduction);
  * `sub(a, b, k)` = a + k*p - b, requires bound(b) <= k*p (static k);
  * `mul` needs value(a) * value(b) <= 2^16 * p^2 (e.g. both < 2^8 p), so
    the product < p*R;
  * wide (2n+1-limb) values must stay < 2^18 * p^2 so `redc` input < p*R;
  * `normalize` canonically reduces to [0, p); `eq`/`is_zero` work on
    non-canonical values by checking against small multiples of p.

Every op gives the same limbs as the reference for the same input limbs:
each is a function of the values alone (exact limbs, modulo 2^(16 rows)).

Kernels: on a CUDA tensor `_mont_mul`, `mul_wide`, `redc` and `pow_const`
launch the hand-written kernels of :mod:`.cuda_fp`; on a CPU tensor they run
those kernels' plain PyTorch versions. The rest is PyTorch glue.

Devices: every constructor (`zeros`, `one`, `from_ints`, `from_int`) takes
an explicit ``device`` that defaults to ``"cuda"`` and raises when no card
is present; every op returns tensors on its inputs' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .limbs import W, MASK, int_to_limbs, ints_to_limbs, limbs_to_int, limbs_to_ints
from . import cuda_fp


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (no silent CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def _carry_passes(bits: int) -> int:
    """Split-and-shift passes that bring columns < 2^bits to <= 2^17 - 2."""
    top = (1 << bits) - 1
    passes = 0
    while top > (1 << 17) - 2:
        top = MASK + (top >> W)
        passes += 1
    return passes


class PrimeField:
    """Montgomery arithmetic mod `modulus` on 16-bit limb tensors."""

    def __init__(self, modulus: int, n_limbs: int, name: str = "Fp"):
        assert modulus % 2 == 1 and modulus < 1 << (W * n_limbs)
        self.p = modulus
        self.n = n_limbs
        self.name = name
        self.R_int = 1 << (W * n_limbs)
        # Headroom for the redundant representation: need 2^16 * p < R so
        # that mul inputs bounded by 2^8 p keep T = a*b < p*R.
        assert (modulus << 16) < self.R_int, "need 16 bits of limb headroom"
        self.n0 = (-pow(modulus, -1, 1 << W)) % (1 << W)   # -p^{-1} mod 2^16
        self.p_limbs = int_to_limbs(modulus, n_limbs)
        self.r_mod_p = self.R_int % modulus
        self.r2_mod_p = (self.r_mod_p * self.r_mod_p) % modulus
        # -p^{-1} mod R: the plain redc computes M = -t p^{-1} mod R at once.
        self.nprime = (-pow(modulus, -1, self.R_int)) % self.R_int
        self._consts = {}

    # ---------------------------------------------------------------- helpers

    def _cached(self, key, device, make):
        """Device copy of a host constant, made once per device.

        Constants must not be re-uploaded per op: a copy from pageable host
        memory waits for the stream, which would serialize host and card.
        """
        k = (key, device)
        t = self._consts.get(k)
        if t is None:
            t = torch.as_tensor(make(), dtype=torch.int64, device=device)
            self._consts[k] = t
        return t

    def _const(self, value_int: int, ndim: int, device, rows: int = 0):
        """Raw limb constant (NOT reduced, NOT Montgomery), shaped (rows, 1...)."""
        rows = rows or self.n
        c = self._cached(("int", value_int, rows), device,
                         lambda: int_to_limbs(value_int, rows).astype(np.int64))
        return c.reshape(c.shape + (1,) * max(ndim - 1, 0))

    def _offset(self, value_int: int, rows: int, ndim: int, device):
        """Limbs of value + (2^(16 rows) - 1) + 1, one column each: the
        borrow-free complement offset of `sub`-style chains."""
        def make():
            c = int_to_limbs(value_int, rows).astype(np.int64) + MASK
            c[0] += 1
            return c
        c = self._cached(("off", value_int, rows), device, make)
        return c.reshape(c.shape + (1,) * max(ndim - 1, 0))

    def zeros(self, batch_shape=(), device="cuda"):
        return torch.zeros((self.n,) + tuple(batch_shape), dtype=torch.int64,
                           device=resolve_device(device))

    def one(self, batch_shape=(), device="cuda"):
        """Montgomery form of 1 (i.e. R mod p)."""
        dev = resolve_device(device)
        c = self._const(self.r_mod_p, 1 + len(batch_shape), dev)
        return c.expand((self.n,) + tuple(batch_shape)).clone()

    # ------------------------------------------------------- carry primitives

    def _carry(self, cols, bits: int = 17):
        """Exact carry propagation along axis 0, modulo 2^(16 rows).

        `cols` are non-negative int64 columns < 2^bits; limb 0 may reach
        2^17 - 1 (nothing carries into it). Split-and-shift passes bring
        every column to <= 2^17 - 2, so each carry is 0 or 1; the ripple is
        then resolved at once as a binary addition over per-limb bit masks:
        limb i generates (g_i: column >= 2^16) or propagates (p_i: column ==
        2^16 - 1), and the carries into all limbs are ((G|P) + G) ^ P. The
        carry out of the top limb is dropped, as in the reference's scan.
        """
        v = cols
        for k in range(_carry_passes(bits)):
            hi = v >> W
            v = v & MASK if k == 0 else v.bitwise_and_(MASK)   # own copy
            v[1:] += hi[:-1]
        rows, nd = v.shape[0], v.ndim
        assert rows <= 62, "bit-mask carry needs rows + 1 <= 63 bits"
        w = self._cached(("pow2", rows, nd), v.device, lambda: np.array(
            [1 << i for i in range(rows)]).reshape((rows,) + (1,) * (nd - 1)))
        sh = self._cached(("iota", rows, nd), v.device, lambda: np.arange(
            rows).reshape((rows,) + (1,) * (nd - 1)))
        g = (v >> W).mul_(w).sum(0)
        p = (v == MASK).mul(w).sum(0)
        cin = ((g | p) + g) ^ p
        cbits = (cin.unsqueeze(0) >> sh).bitwise_and_(1)
        return (v + cbits).bitwise_and_(MASK)

    def _sub_borrow(self, a, b):
        """(a - b) limbwise (equal rows); returns (diff, borrow_out bool)."""
        cols = a + MASK - b
        cols[0] += 1
        pad = torch.zeros_like(cols[:1])
        out = self._carry(torch.cat([cols, pad], 0))
        return out[:-1], out[-1] == 0

    # ----------------------------------------------------------- field ops

    def add(self, a, b):
        """a + b. Bound: bound(a) + bound(b). One carry pass, no reduction."""
        return self._carry(a + b)

    def sub(self, a, b, k: int = 4):
        """a - b + k*p, for a static k with bound(b) <= k*p.

        Bound of result: bound(a) + k*p. Single fused add/sub chain.
        """
        off = self._offset(k * self.p, self.n, a.ndim, a.device)
        return self._carry(a + off - b, bits=18)

    def neg(self, a, k: int = 2):
        """k*p - a with bound(a) <= k*p. Result bound: k*p."""
        off = self._offset(k * self.p, self.n, a.ndim, a.device)
        return self._carry(off - a)

    def double(self, a):
        return self._carry(a + a)

    @staticmethod
    def _align(a, b):
        """Insert leading batch axes so a and b have the same ndim."""
        nd = max(a.ndim, b.ndim)
        if a.ndim < nd:
            a = a.reshape(a.shape[:1] + (1,) * (nd - a.ndim) + a.shape[1:])
        if b.ndim < nd:
            b = b.reshape(b.shape[:1] + (1,) * (nd - b.ndim) + b.shape[1:])
        return torch.broadcast_tensors(a, b)

    def mul(self, a, b):
        """Montgomery product a*b*R^{-1} mod p.

        Requires bound(a)*bound(b) <= 2^16 * p^2 (e.g. both < 2^8 p).
        Output bound: < 2p. Batch shapes broadcast against each other.
        """
        return self._mont_mul(a, b)

    def _mont_mul(self, a, b):
        a, b = self._align(a, b)
        return cuda_fp.mont_mul(self, a, b)

    def sqr(self, a):
        return self._mont_mul(a, a)

    # ------------------------------------------- wide (lazy-reduction) domain
    #
    # A "wide" value is a 2n+1-limb exact product-domain integer (< p*R).
    # Tower multiplications compute Karatsuba combinations on wide values and
    # Montgomery-reduce ONCE per output coefficient ("lazy reduction").
    # Budget: wide values must stay < 2^18 * p^2 so that redc input < p*R
    # and output < 2p.

    def mul_wide(self, a, b):
        """Exact 2n+1-limb product a*b (16-bit limbs). No reduction."""
        a, b = self._align(a, b)
        return cuda_fp.mul_wide(self, a, b)

    def redc(self, t):
        """Montgomery-reduce a wide value: t * R^{-1} mod p, output < 2p.

        Requires t < p*R (2n+1 exact limbs).
        """
        return cuda_fp.redc(self, t)

    def add_wide(self, a, b):
        """Wide + wide (exact carry pass)."""
        return self._carry(a + b)

    def double_wide(self, a):
        return self._carry(a + a)

    def sub_wide(self, a, b, k2: int = 1 << 8):
        """a - b + k2 * p^2 on wide values; requires bound(b) <= k2 * p^2."""
        off = self._offset(k2 * self.p * self.p, 2 * self.n + 1, a.ndim,
                           a.device)
        return self._carry(a + off - b, bits=18)

    def mul_small(self, a, k: int):
        """a * k for small positive Python int k (<= 2^6). Bound: k*bound(a)."""
        assert 1 <= k <= 64
        if k == 1:
            return a
        return self._carry(a * k, bits=22)

    def fold(self, a):
        """Cheap partial reduction: fold the top limb back mod p.

        For a with exact limbs and any value < capacity, returns
        a' = (a mod 2^(16(n-1))) + floor(a / 2^(16(n-1))) * (2^(16(n-1)) mod p)
        which is congruent mod p and bounded by 2^(16(n-1)) + (bound/2^(16(n-1))) * p.
        """
        nl = self.n
        c_col = self._const((1 << (W * (nl - 1))) % self.p, a.ndim, a.device,
                            rows=nl - 1)
        prod = a[nl - 1] * c_col                  # (nl-1, ...), exact 16x16
        cols = torch.cat([a[:nl - 1] + (prod & MASK),
                          torch.zeros_like(a[:1])], 0)
        cols[1:nl] += prod >> W
        return self._carry(cols, bits=18)

    # ------------------------------------------------- normalization & tests

    def normalize(self, a, k: int = 2):
        """Canonical value in [0, p) for bound(a) <= k*p (static small k)."""
        s = a
        j = max((k - 1).bit_length() - 1, 0)
        for jj in range(j, -1, -1):
            ph = self._const((1 << jj) * self.p, a.ndim, a.device)
            d, borrow = self._sub_borrow(s, ph)
            s = torch.where(borrow[None], s, d)
        return s

    def is_zero(self, a, k: int = 2):
        """a == 0 mod p, for bound(a) <= k*p: compare against 0, p, .. (k-.)p."""
        zero = (a == 0).all(0)
        for m in range(1, k):
            mp = self._const(m * self.p, a.ndim, a.device)
            zero = zero | (a == mp).all(0)
        return zero

    def eq(self, a, b, k: int = 2):
        """a == b mod p for bounds <= k*p each."""
        d = self.sub(a, b, k=k)            # bound 2k*p
        return self.is_zero(d, k=2 * k)

    @staticmethod
    def select(mask, a, b):
        """mask ? a : b, with mask shaped like the batch dims."""
        return torch.where(mask[None], a, b)

    @staticmethod
    def stack(elems):
        """Stack field elements along a new axis 1 (one op downstream)."""
        return torch.stack(elems, 1)

    @staticmethod
    def unstack(x, n):
        return [x[:, i] for i in range(n)]

    # -------------------------------------------------------------- pow / inv

    def pow_const(self, a, e: int):
        """a^e (Montgomery in/out) for a fixed Python-int exponent.

        One launch of the square-and-multiply chain kernel on a card (the
        plain version on the CPU).
        """
        if e == 0:
            return self.one(a.shape[1:], device=a.device)
        return cuda_fp.pow_const(self, a, e)

    def inv(self, a):
        """a^{-1} via Fermat; Montgomery in/out. inv(0) = 0 (by convention)."""
        return self.pow_const(a, self.p - 2)

    def inv_batch(self, a, k: int = 8, rows: int = 32):
        """Batched a^{-1} via the blocked Montgomery trick; inv(0) = 0.

        One Fermat exponentiation per `rows` elements instead of one per
        element: a forward product loop over `rows` steps, ONE batched
        Fermat inversion of the row totals, a backward recovery loop. `k`:
        static bound multiplier of the input (bound(a) <= k*p) for the zero
        test; zeros are replaced by 1 and restored to 0 at the end.
        """
        batch = a.shape[1:]
        total = math.prod(batch)
        if total < 4 * rows:
            return self.pow_const(a, self.p - 2)

        zero = self.is_zero(a, k=k)
        a = torch.where(zero[None], self.one(batch, device=a.device), a)
        cols = -(-total // rows)
        pad = rows * cols - total
        flat = a.reshape(self.n, total)
        if pad:
            flat = torch.cat([flat, self.one((pad,), device=a.device)], 1)
        g = flat.reshape(self.n, rows, cols)

        # forward: excl[r] = a[0] * ... * a[r-1]; acc ends as the row total
        acc = self.one((cols,), device=a.device)
        excl = []
        for r in range(rows):
            excl.append(acc)
            acc = self._mont_mul(acc, g[:, r])
        acc = self.pow_const(acc, self.p - 2)

        # backward: inv(a[r]) = excl[r] * acc; acc *= a[r]
        outs = [None] * rows
        for r in range(rows - 1, -1, -1):
            outs[r] = self._mont_mul(excl[r], acc)
            acc = self._mont_mul(acc, g[:, r])
        inv_flat = torch.stack(outs, 1).reshape(self.n, rows * cols)
        inv_flat = inv_flat[:, :total].reshape((self.n,) + tuple(batch))
        return torch.where(zero[None], torch.zeros_like(inv_flat), inv_flat)

    # ------------------------------------------------------------- conversion

    def to_mont(self, a):
        r2 = self._const(self.r2_mod_p, a.ndim, a.device)
        return self._mont_mul(a, r2.expand(a.shape))

    def from_mont(self, a):
        """Montgomery -> standard form, canonically reduced to [0, p)."""
        one = self._const(1, a.ndim, a.device)
        return self.normalize(self._mont_mul(a, one.expand(a.shape)))

    def from_ints(self, values, device="cuda"):
        """Python ints -> Montgomery-form tensor (n, len(values)).

        The Montgomery conversion (v * R mod p) runs on the host in exact
        integer math, then the limbs are copied to `device` once.
        """
        arr = ints_to_limbs([(v % self.p) * self.r_mod_p % self.p
                             for v in values], self.n)
        return torch.as_tensor(arr.astype(np.int64),
                               device=resolve_device(device))

    def from_int(self, value: int, device="cuda"):
        arr = int_to_limbs((value % self.p) * self.r_mod_p % self.p, self.n)
        return torch.as_tensor(arr.astype(np.int64),
                               device=resolve_device(device))

    def to_ints(self, a) -> list:
        """Montgomery-form tensor (n, *batch) -> flat list of ints."""
        std = self.from_mont(a).cpu().numpy()
        if std.ndim == 1:
            return [limbs_to_int(std)]
        return limbs_to_ints(std.reshape(self.n, -1))


# Field instances for BLS12-381 (extra limb = redundant-representation room).
from . import bls12_381 as _c

FQ = PrimeField(_c.P, 25, "Fq")    # 400-bit capacity for the 381-bit modulus
FR = PrimeField(_c.R, 17, "Fr")    # 272-bit capacity for the 255-bit modulus
