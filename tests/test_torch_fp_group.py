"""The split Montgomery product of pow_const over a group of threads.

`csrc/field_split_w32.cuh` spreads one Montgomery product (13 packed 32-bit
words, R = 2^400) over a group of G threads of a warp: thread g owns
columns g K .. g K + K - 1 (K = 16 / G) of the CIOS running sum in
carry-save form (three words a column), each step broadcasts m by one
shuffle and shifts the window by another, and the carries resolve once at
the end by two shuffles up, a carry passed up, two ballots (a
carry-lookahead) and one shuffle down. The kernel runs only on a card, so
this file holds a pure-Python twin of that schedule -- each thread's
carry-chain instructions in the kernel's order, with its own carry flag,
and every shuffle and ballot as an explicit exchange between the threads
-- and holds it limb for limb against the port's plain Montgomery product
(`cuda_fp.mont_mul_plain`, itself held against the JAX package in
test_torch_fp.py) on seeded products and at the edges, and a whole
Fermat chain (e = p - 2) against `cuda_fp.pow_const_plain`. It checks the
column bound (t <= 3), that every step clears the low word it reduces,
and counts the exchanges a product takes.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from groth_sahai_tpu_torch.ops import cuda_fp
from groth_sahai_tpu_torch.ops.fp import FQ

from .test_torch_tower import one_thread  # noqa: F401
from .test_torch_words import (MASK, NL, NPW, NW, Chain, limbs_of, mont_w32,
                               n0w_newton, pack, unpack)

P = FQ.p
COLS = 16
PW = [(P >> (32 * k)) & MASK for k in range(NPW)]
N0W = n0w_newton(PW[0])
GROUPS = (4, 8, 16)


def pow_group() -> int:
    """kPowGroup as fp_kernels.cu sets it."""
    src = (pathlib.Path(cuda_fp.__file__).resolve().parent.parent / "csrc"
           / "fp_kernels.cu").read_text()
    return int(re.search(r"constexpr int kPowGroup = (\d+);", src).group(1))


class Group:
    """The G threads of one lane, in lockstep: each with its carry flag;
    shuffles (width G) and ballots are exchanges between them, counted."""

    def __init__(self, G: int):
        self.G, self.K = G, COLS // G
        self.cc = [Chain() for _ in range(G)]
        self.exchanges = 0

    def shfl(self, v, src):
        self.exchanges += 1
        return [v[src]] * self.G

    def down(self, v, d):
        """__shfl_down_sync: a thread past the top keeps its own value."""
        self.exchanges += 1
        return [v[g + d] if g + d < self.G else v[g] for g in range(self.G)]

    def up(self, v, d):
        self.exchanges += 1
        return [v[g - d] if g >= d else v[g] for g in range(self.G)]

    def ballot(self, pred) -> int:
        self.exchanges += 1
        return sum(1 << g for g in range(self.G) if pred[g])

    def own(self, w):
        """Each thread's K words of a value (zero past its words)."""
        K = self.K
        return [[w[g * K + k] if g * K + k < len(w) else 0 for k in range(K)]
                for g in range(self.G)]

    def full(self, o):
        """All 13 words from the threads' own words, one shuffle each."""
        K = self.K
        return [self.shfl([o[g][i % K] for g in range(self.G)], i // K)[0]
                for i in range(NW)]


def split_mont(grp: Group, a, b, p):
    """Split.mont of field_split_w32.cuh: a (13 words) in every thread, b
    and p as the threads' own words; returns the threads' own result
    words."""
    G, K, cc = grp.G, grp.K, grp.cc
    rng = range(G)
    l = [[0] * K for _ in rng]
    h = [[0] * K for _ in rng]
    t = [[0] * K for _ in rng]
    pend = [0] * G

    def mac3(g, k, x, y):
        l[g][k] = cc[g].mad_lo_cc(x, y, l[g][k])
        h[g][k] = cc[g].madc_hi_cc(x, y, h[g][k])
        t[g][k] = cc[g].addc(t[g][k], 0)
        assert t[g][k] <= 3, "a column reached 2^66"

    for i in range(NW):
        for g in rng:
            for k in range(K):
                mac3(g, k, a[i], b[g][k])
        low = grp.shfl([l[g][0] for g in rng], 0)
        m = [(x * N0W) & MASK if i < NW - 1 else (x * FQ.n0) & 0xFFFF
             for x in low]
        for g in rng:
            for k in range(K):
                mac3(g, k, m[g], p[g][k])
        assert l[0][0] & (MASK if i < NW - 1 else 0xFFFF) == 0
        if K > 1:
            for g in rng:
                l[g][K - 1] = cc[g].add_cc(l[g][K - 1], pend[g])
                h[g][K - 1] = cc[g].addc_cc(h[g][K - 1], 0)
                t[g][K - 1] = cc[g].addc(t[g][K - 1], 0)
        if i == NW - 1:
            break
        nxt = grp.down([l[g][0] for g in rng], 1)
        nxt[G - 1] = 0
        for g in rng:
            for k in range(K - 1):
                l[g][k] = cc[g].add_cc(h[g][k], l[g][k + 1])
                h[g][k] = cc[g].addc(t[g][k], 0)
                t[g][k] = 0
            if K == 1:
                l[g][0] = cc[g].add_cc(h[g][0], nxt[g])
                h[g][0] = cc[g].addc(t[g][0], 0)
            else:
                l[g][K - 1], h[g][K - 1] = h[g][K - 1], t[g][K - 1]
                pend[g] = nxt[g]
            t[g][K - 1] = 0
    # s_j + 2^32 c_j = l_j + h_(j-1) + t_(j-2)
    hin = grp.up([h[g][K - 1] for g in rng], 1)
    tin1 = grp.up([t[g][K - 1] for g in rng], 1)
    tin2 = grp.up([t[g][K - 2 if K > 1 else 0] for g in rng],
                  1 if K > 1 else 2)
    s = [[0] * K for _ in rng]
    c = [[0] * K for _ in rng]
    for g in rng:
        hin[g] = 0 if g == 0 else hin[g]
        tin1[g] = 0 if g == 0 else tin1[g]
        tin2[g] = 0 if g < (1 if K > 1 else 2) else tin2[g]
        for k in range(K):
            hm = h[g][k - 1] if k > 0 else hin[g]
            tm = t[g][k - 2] if k > 1 else tin1[g] if k == 1 else tin2[g]
            s[g][k] = cc[g].add_cc(l[g][k], hm)
            c[g][k] = cc[g].addc(0, 0)
            s[g][k] = cc[g].add_cc(s[g][k], tm)
            c[g][k] = cc[g].addc(c[g][k], 0)
            assert c[g][k] <= 2
    e = [0] * G
    if K > 1:
        for g in rng:
            s[g][1] = cc[g].add_cc(s[g][1], c[g][0])
            for k in range(2, K):
                s[g][k] = cc[g].addc_cc(s[g][k], c[g][k - 1])
            e[g] = cc[g].addc(0, 0)
    inc = grp.up([c[g][K - 1] + e[g] for g in rng], 1)
    gen, ones = [0] * G, [False] * G
    for g in rng:
        x = 0 if g == 0 else inc[g]
        assert x <= 3
        s[g][0] = cc[g].add_cc(s[g][0], x)
        for k in range(1, K):
            s[g][k] = cc[g].addc_cc(s[g][k], 0)
        gen[g] = cc[g].addc(0, 0)
        ones[g] = all(w == MASK for w in s[g])
        assert not (gen[g] and ones[g])
    gb, pb = grp.ballot(gen), grp.ballot(ones)
    for g in rng:
        cin = (((gb | pb) + gb) ^ pb) >> g & 1
        s[g][0] = cc[g].add_cc(s[g][0], cin)
        for k in range(1, K - 1):
            s[g][k] = cc[g].addc_cc(s[g][k], 0)
        if K > 1:
            s[g][K - 1] = cc[g].addc(s[g][K - 1], 0)
    up = grp.down([s[g][0] for g in rng], 1)
    up[G - 1] = 0
    return [[((s[g][k] | (s[g][k + 1] if k + 1 < K else up[g]) << 32) >> 16)
             & MASK for k in range(K)] for g in rng]


def twin_product(G: int, av: int, bv: int):
    """One split product of the values av, bv; returns its 25 limbs and the
    group (its counts)."""
    grp = Group(G)
    a, b = pack(limbs_of([av])[0]), pack(limbs_of([bv])[0])
    r = split_mont(grp, a, grp.own(b), grp.own(PW))
    return unpack(grp.full(r)), grp


def twin_pow(G: int, av: int, e: int):
    """fq_pow_const_kernel<G> for one lane: from R mod p, a square, then on a
    set bit a product with a (whole in every thread); the accumulator is
    broadcast whole for the next square. Returns the 25 limbs."""
    x = pack(limbs_of([av])[0])
    one = pack(limbs_of([FQ.r_mod_p])[0])
    if G == 1:
        acc = one
        for bit in cuda_fp.exponent_bits(e):
            acc = mont_w32(acc, acc, PW, N0W, FQ.n0)
            if bit:
                acc = mont_w32(acc, x, PW, N0W, FQ.n0)
        return unpack(acc)
    grp = Group(G)
    p = grp.own(PW)
    acc, whole = grp.own(one), one
    bits = cuda_fp.exponent_bits(e)
    for i, bit in enumerate(bits):
        t = split_mont(grp, whole, acc, p)
        acc = split_mont(grp, x, t, p) if bit else t
        if i + 1 < len(bits):
            whole = grp.full(acc)
    return unpack([acc[j // grp.K][j % grp.K] for j in range(NW)])


def seeded(n: int, seed: int):
    """Values a, b < 2^8 p (value(a) value(b) <= 2^16 p^2)."""
    rng = np.random.default_rng(seed)
    top = (P << 8).bit_length() - 1
    draw = lambda: int.from_bytes(rng.bytes(52), "little") % (1 << top)
    return [draw() for _ in range(n)], [draw() for _ in range(n)]


EDGES = [(0, 0), (1, 1), (P - 1, P - 1), (2 * P - 1, 2 * P - 1),
         ((1 << 8) * P - 1, (1 << 8) * P - 1),
         (2 * P - 1, P << 16), ((P << 16) - 1, 2 * P - 1),   # the chain's
         (0, (1 << 400) - 1), ((1 << 400) - 1, 1)]           # widest a x


@pytest.mark.parametrize("G", GROUPS)
def test_split_product_matches_plain_limb_for_limb(G):
    """The twin of the split product gives mont_mul_plain's limbs on
    seeded products and the edges, and takes 32 exchanges (13 broadcasts
    of m, 12 shifts, 7 for the carries), plus 13 to broadcast the result."""
    n = 1200 if G == pow_group() else 400
    av, bv = seeded(n, 20261018 + G)
    av[:len(EDGES)] = [a for a, _ in EDGES]
    bv[:len(EDGES)] = [b for _, b in EDGES]
    got = []
    for a, b in zip(av, bv):
        limbs, grp = twin_product(G, a, b)
        assert grp.exchanges == 32 + 13
        got.append(limbs)
    want = cuda_fp.mont_mul_plain(
        FQ, torch.tensor(limbs_of(av), dtype=torch.int64).T,
        torch.tensor(limbs_of(bv), dtype=torch.int64).T)
    assert torch.equal(torch.tensor(got, dtype=torch.int64).T, want)


@pytest.mark.parametrize("G", [1, pow_group()])
def test_split_fermat_chain_matches_plain(G):
    """A whole p - 2 chain as the kernel runs it (G = 1: the one-thread
    packed-word product; the committed G) against pow_const_plain, on a
    seeded lane and the widest input (2^16 p - 1); a a^(p-2) = 1."""
    av = [seeded(1, 7)[0][0], (P << 16) - 1]
    e = P - 2
    want = cuda_fp.pow_const_plain(
        FQ, torch.tensor(limbs_of(av), dtype=torch.int64).T, e)
    for lane, a in enumerate(av):
        got = twin_pow(G, a, e)
        assert got == want[:, lane].tolist()
        v = sum(x << (16 * i) for i, x in enumerate(got))
        r_inv = pow(1 << 400, -1, P)
        assert (a * r_inv) * (v * r_inv) % P == 1


def test_split_layout_and_counts():
    """Each thread owns 16 / G consecutive columns and p's words there (zero
    past word 11); after the 12 shifts the window holds T / 2^384 in 14
    columns (value(a) value(b) <= 2^16 p^2); the chain is 381 squares and
    229 products."""
    for G in GROUPS:
        grp = Group(G)
        p = grp.own(PW)
        assert [w for o in p for w in o] == PW + [0] * (COLS - NPW)
        assert len(p) == G and all(len(o) == COLS // G for o in p)
    assert ((1 << 16) * P * P + (1 << 400) * P) >> 384 < 1 << (32 * (NW + 1))
    bits = cuda_fp.exponent_bits(P - 2)
    assert (len(bits), sum(bits)) == (381, 229)
    assert NL == 25 and COLS >= NW + 1


def test_fp_variants_imports_neither_jax_nor_the_jax_package():
    """The pow_const group-size script runs on the card, without JAX; its
    variants set kPowGroup to each other G of 1, 4, 8, 16."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import groth_sahai_tpu_torch.utils.fp_variants as fv\n"
            "names = set(fv.variants())\n"
            "assert len(names) == 4 and 'as built' in names, names\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
            "       and (m == 'groth_sahai_tpu' or m.startswith(\n"
            "            ('groth_sahai_tpu.', 'jax.')) or m == 'jax')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=str(repo)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
