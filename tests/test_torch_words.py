"""The packed-word arithmetic of the curve kernels cadd and cmsm_row_scan.

`csrc/field_w32.cuh` holds an Fq value as 13 packed 32-bit words and
multiplies in Montgomery form with R = 2^400: 12 CIOS steps of 2^32 and one
of 2^16, in PTX carry chains (the running sum split into an even and an
odd array, so each word product's two halves sit in one chain). The kernel
runs only on a card, so this file holds a pure-Python twin of its
instruction sequence -- each carry-chain instruction, in the kernel's
order, with the carry flag it reads and sets -- and of its 16-bit <->
32-bit packing, and checks that the twin gives the limbs of the port's
plain Montgomery product (`cuda_fp.mont_mul_plain`, itself held against
the JAX package in test_torch_fp.py) limb for limb, on seeded inputs up to
the 2^16 p^2 bound and at the edges of the bodies' bounds. It also checks
the host's Newton iteration for n0w = -p^-1 mod 2^32 and that no chain
drops a carry that is not zero.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from groth_sahai_tpu_torch.ops import cuda_fp
from groth_sahai_tpu_torch.ops.fp import FQ

from .test_torch_tower import one_thread  # noqa: F401

P = FQ.p
NL = FQ.n          # 25 16-bit limbs
NW = 13            # packed words of an Fq value
NPW = 12           # words of p
MASK = (1 << 32) - 1


def pack(limbs):
    """field_w32.cuh pack_host: word k = limb 2k | limb 2k+1 << 16."""
    return [limbs[2 * k] | ((limbs[2 * k + 1] if 2 * k + 1 < NL else 0) << 16)
            for k in range(NW)]


def unpack(words):
    """The kernels' store: limb i = (word i/2 >> 16 (i % 2)) & 0xFFFF."""
    return [(words[i // 2] >> (16 * (i % 2))) & 0xFFFF for i in range(NL)]


def n0w_newton(p0: int) -> int:
    """make_field_w: p^-1 mod 2^32 by four Newton steps from x = p0."""
    x = p0
    for _ in range(4):
        x = (x * (2 - p0 * x)) & MASK
    return (-x) & MASK


def clear(x) -> bool:
    """x == 0, for an int or every lane of a numpy uint64 array."""
    return x == 0 if isinstance(x, int) else not np.any(x)


class Chain:
    """The PTX carry flag and the instructions of field_w32.cuh that use it.
    An instruction without .cc drops its carry out, which must be 0."""

    def __init__(self):
        self.cf = 0

    def _cc(self, s):
        self.cf = s >> 32
        return s & MASK

    @staticmethod
    def _last(s):
        assert clear(s >> 32), "a chain dropped a carry"
        return s

    def add_cc(self, a, b):
        return self._cc(a + b)

    def addc_cc(self, a, b):
        return self._cc(a + b + self.cf)

    def addc(self, a, b):
        return self._last(a + b + self.cf)

    def mad_lo_cc(self, a, b, c):
        return self._cc(((a * b) & MASK) + c)

    def madc_lo_cc(self, a, b, c):
        return self._cc(((a * b) & MASK) + c + self.cf)

    def madc_hi_cc(self, a, b, c):
        return self._cc((a * b >> 32) + c + self.cf)

    def madc_hi(self, a, b, c):
        return self._last((a * b >> 32) + c + self.cf)


def mont_w32(a, b, p, n0w: int, n0: int):
    """field_w32.cuh mont_words: a b R^-1 mod p (< 2p) on NW packed words
    (NW = len(a): Fq 13, R = 2^400; Fr 9, R = 2^272; p in NW - 1 words),
    step for step: T = E + 2^32 O, b's even words into E's word pairs and
    its odd words into O's, m p by the same split, then E = E / 2^32 + O;
    the last step reduces by 2^16. A word may be an int or a numpy uint64
    array of lanes."""
    NW, NPW = len(a), len(p)
    cc = Chain()
    E, O = [0] * (NW + 1), [0] * NW
    for i in range(NW):
        ai = a[i]
        for j in range(1, NW, 2):              # O = ai b_odd
            O[j - 1], O[j] = (ai * b[j]) & MASK, ai * b[j] >> 32
        O[NW - 1] = 0
        if i == 0:                             # E = ai b_even
            for j in range(0, NW, 2):
                E[j], E[j + 1] = (ai * b[j]) & MASK, ai * b[j] >> 32
        else:                                  # E += ai b_even
            E[0] = cc.mad_lo_cc(ai, b[0], E[0])
            E[1] = cc.madc_hi_cc(ai, b[0], E[1])
            for j in range(2, NW - 1, 2):
                E[j] = cc.madc_lo_cc(ai, b[j], E[j])
                E[j + 1] = cc.madc_hi_cc(ai, b[j], E[j + 1])
            E[NW - 1] = cc.madc_lo_cc(ai, b[NW - 1], E[NW - 1])
            E[NW] = cc.madc_hi(ai, b[NW - 1], E[NW])
        m = (E[0] * n0w) & MASK if i < NW - 1 else (E[0] * n0) & 0xFFFF
        E[0] = cc.mad_lo_cc(m, p[0], E[0])     # E += m p_even
        E[1] = cc.madc_hi_cc(m, p[0], E[1])
        for j in range(2, NPW, 2):
            E[j] = cc.madc_lo_cc(m, p[j], E[j])
            E[j + 1] = cc.madc_hi_cc(m, p[j], E[j + 1])
        E[NPW] = cc.addc_cc(E[NPW], 0)
        E[NW] = cc.addc(E[NW], 0)
        O[0] = cc.mad_lo_cc(m, p[1], O[0])     # O += m p_odd
        O[1] = cc.madc_hi_cc(m, p[1], O[1])
        for j in range(3, NPW, 2):
            O[j - 1] = cc.madc_lo_cc(m, p[j], O[j - 1])
            O[j] = cc.madc_hi_cc(m, p[j], O[j])
        O[NPW] = cc.addc(O[NPW], 0)
        if i < NW - 1:                         # T / 2^32
            assert clear(E[0])
            E[0] = cc.add_cc(E[1], O[0])
            for k in range(1, NW - 1):
                E[k] = cc.addc_cc(E[k + 1], O[k])
            E[NW - 1] = cc.addc(E[NW], O[NW - 1])
            E[NW] = 0
        else:
            assert clear(E[0] & 0xFFFF)
    t = [E[0], cc.add_cc(E[1], O[0])]          # T's words, then T / 2^16
    t += [cc.addc_cc(E[k], O[k - 1]) for k in range(2, NW)]
    t.append(cc.addc(E[NW], O[NW - 1]))
    return [((t[j] | t[j + 1] << 32) >> 16) & MASK for j in range(NW)]


def limbs_of(values):
    return [[(v >> (16 * i)) & 0xFFFF for i in range(NL)] for v in values]


def value_of(limbs) -> int:
    return sum(x << (16 * i) for i, x in enumerate(limbs))


def random_pairs(n: int, seed: int):
    """Seeded values a, b < 2^8 p, so value(a) value(b) <= 2^16 p^2."""
    rng = np.random.default_rng(seed)
    top = (P << 8).bit_length() - 1
    draw = lambda: int.from_bytes(rng.bytes(52), "little") % (1 << top)
    return [draw() for _ in range(n)], [draw() for _ in range(n)]


EDGES = {   # name -> (a, b): the bound edges of the bodies' products
    "zero": (0, 0),
    "one": (1, 1),
    "p-1": (P - 1, P - 1),
    "2p-1": (2 * P - 1, 2 * P - 1),
    "4p-1": (4 * P - 1, 4 * P - 1),
    "196p*196p": (196 * P - 1, 196 * P - 1),
    "12p*288p": (12 * P - 1, 288 * P - 1),
    "2^16p^2": ((1 << 8) * P - 1, (1 << 8) * P - 1),
}


@pytest.mark.parametrize("case", ["random"] + list(EDGES))
def test_mont_w32_twin_matches_plain_limb_for_limb(case):
    """The twin of the packed-word product gives mont_mul_plain's limbs,
    and the packing round-trips."""
    if case == "random":
        av, bv = random_pairs(64, 20261018)
    else:
        av, bv = ([v] for v in EDGES[case])
    assert all(a * b <= (1 << 16) * P * P for a, b in zip(av, bv))
    a16, b16 = limbs_of(av), limbs_of(bv)
    pw = pack(limbs_of([P])[0])
    assert pw[NPW] == 0                    # p fits 12 words
    n0w = n0w_newton(pw[0])
    got = [unpack(mont_w32(pack(a), pack(b), pw[:NPW], n0w, FQ.n0))
           for a, b in zip(a16, b16)]
    want = cuda_fp.mont_mul_plain(
        FQ, torch.tensor(a16, dtype=torch.int64).T,
        torch.tensor(b16, dtype=torch.int64).T)
    assert torch.equal(torch.tensor(got, dtype=torch.int64).T, want)
    for a in a16:
        assert unpack(pack(a)) == a
    for a, b, c in zip(av, bv, got):
        assert value_of(c) < 2 * P
        assert value_of(c) % P == a * b * pow(1 << 400, -1, P) % P


def test_n0w_newton_inverts_p_mod_2_32():
    """n0w p = -1 mod 2^32, from the host's four Newton steps, and n0 is
    its low 16 bits."""
    n0w = n0w_newton(P & MASK)
    assert (n0w * P) & MASK == MASK
    assert n0w == (-pow(P, -1, 1 << 32)) % (1 << 32)
    assert n0w & 0xFFFF == FQ.n0


def test_packing_holds_the_bodies_values():
    """Every value the bodies make (< 288p) and every sum of two (< 2^400)
    packs into 13 words and back, word 12 holding limb 24 alone."""
    for v in (288 * P - 1, (1 << 400) - 1, 2 * P - 1, 0):
        limbs = limbs_of([v])[0]
        words = pack(limbs)
        assert sum(w << (32 * k) for k, w in enumerate(words)) == v
        assert words[NW - 1] >> 16 == 0
        assert unpack(words) == limbs
