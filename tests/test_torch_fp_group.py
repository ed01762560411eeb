"""The split Montgomery product of pow_const and mont_mul over a group of
threads.

`csrc/field_split_w32.cuh` spreads one Montgomery product (NW packed 32-bit
words: Fq 13, R = 2^400; Fr 9, R = 2^272) over a group of G threads of a
warp: thread g owns columns g K .. g K + K - 1 (K = NW rounded up to a
multiple of G, over G) of the CIOS running sum in carry-save form (three
words a column), each step broadcasts m by one shuffle and shifts the
window by another, and the carries resolve once at the end by two shuffles
up, a carry passed up, two ballots (a carry-lookahead) and one shuffle
down. The kernel runs only on a card, so this file holds a pure-Python
twin of that schedule -- each thread's carry-chain instructions in the
kernel's order, with its own carry flag, and every shuffle and ballot as
an explicit exchange between the threads -- and holds it limb for limb
against the port's plain Montgomery product (`cuda_fp.mont_mul_plain`,
itself held against the JAX package in test_torch_fp.py) on seeded
products and at the edges, at pow_const's operands and at mont_mul's whole
contract over both fields (a word may be a numpy array of lanes, so one
pass of the twin works 4096 lanes), and a whole Fermat chain (e = p - 2)
against `cuda_fp.pow_const_plain`. It checks the column bound (t <= 3),
that every step clears the low word it reduces, and counts the exchanges
a product takes.
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
from groth_sahai_tpu_torch.ops.fp import FQ, FR

from .test_torch_tower import one_thread  # noqa: F401
from .test_torch_words import (MASK, NL, NPW, NW, Chain, limbs_of, mont_w32,
                               n0w_newton, pack, unpack)

P = FQ.p
COLS = 16
PW = [(P >> (32 * k)) & MASK for k in range(NPW)]
N0W = n0w_newton(PW[0])
GROUPS = (4, 8, 16)


def _fp_kernels() -> str:
    return (pathlib.Path(cuda_fp.__file__).resolve().parent.parent / "csrc"
            / "fp_kernels.cu").read_text()


def pow_group() -> int:
    """kPowGroup as fp_kernels.cu sets it."""
    return int(re.search(r"constexpr int kPowGroup = (\d+);",
                         _fp_kernels()).group(1))


def mul_group(field) -> int:
    """kMulGroupFq or kMulGroupFr as fp_kernels.cu sets it."""
    return int(re.search(rf"constexpr int kMulGroup{field.name} = (\d+);",
                         _fp_kernels()).group(1))


def holds(x) -> bool:
    """An assert's condition, for an int or a numpy array of lanes."""
    return x if isinstance(x, bool) else bool(np.all(x))


class Group:
    """The G threads of one lane, in lockstep: each with its carry flag;
    shuffles (width G) and ballots are exchanges between them, counted.
    A product of NW words takes a window of NW rounded up to a multiple of
    G columns (16 for Fq at G = 4, 8, 16)."""

    def __init__(self, G: int, nw: int = NW):
        self.G, self.nw = G, nw
        self.K = -(-nw // G)
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

    def ballot(self, pred):
        self.exchanges += 1
        if not any(isinstance(x, np.ndarray) for x in pred):
            return sum(1 << g for g in range(self.G) if pred[g])
        return sum(np.asarray(x, dtype=np.uint64) << np.uint64(g)
                   for g, x in enumerate(pred))

    def own(self, w):
        """Each thread's K words of a value (zero past its words)."""
        K = self.K
        return [[w[g * K + k] if g * K + k < len(w) else 0 for k in range(K)]
                for g in range(self.G)]

    def full(self, o):
        """All NW words from the threads' own words, one shuffle each."""
        K = self.K
        return [self.shfl([o[g][i % K] for g in range(self.G)], i // K)[0]
                for i in range(self.nw)]


def split_mont(grp: Group, a, b, p, n0w: int = N0W, n0: int = FQ.n0):
    """Split.mont of field_split_w32.cuh: a (NW words) in every thread, b
    and p as the threads' own words; returns the threads' own result
    words."""
    G, K, cc, NW = grp.G, grp.K, grp.cc, grp.nw
    rng = range(G)
    l = [[0] * K for _ in rng]
    h = [[0] * K for _ in rng]
    t = [[0] * K for _ in rng]
    pend = [0] * G

    def mac3(g, k, x, y):
        l[g][k] = cc[g].mad_lo_cc(x, y, l[g][k])
        h[g][k] = cc[g].madc_hi_cc(x, y, h[g][k])
        t[g][k] = cc[g].addc(t[g][k], 0)
        assert holds(t[g][k] <= 3), "a column reached 2^66"

    for i in range(NW):
        for g in rng:
            for k in range(K):
                mac3(g, k, a[i], b[g][k])
        low = grp.shfl([l[g][0] for g in rng], 0)
        m = [(x * n0w) & MASK if i < NW - 1 else (x * n0) & 0xFFFF
             for x in low]
        for g in rng:
            for k in range(K):
                mac3(g, k, m[g], p[g][k])
        assert holds(l[0][0] & (MASK if i < NW - 1 else 0xFFFF) == 0)
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
            assert holds(c[g][k] <= 2)
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
        assert holds(x <= 3)
        s[g][0] = cc[g].add_cc(s[g][0], x)
        for k in range(1, K):
            s[g][k] = cc[g].addc_cc(s[g][k], 0)
        gen[g] = cc[g].addc(0, 0)
        ones[g] = (all(w == MASK for w in s[g]) if isinstance(s[g][0], int)
                   else np.logical_and.reduce([w == MASK for w in s[g]]))
        assert not np.any(np.logical_and(gen[g], ones[g]))
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


FIELD_EDGES = {   # (a, b) at mont_mul's contract: value(a) value(b) <= 2^16 p^2
    field.name: [(0, 0), (field.p - 1, field.p - 1),
                 (2 * field.p - 1, 2 * field.p - 1), (0, field.p - 1),
                 ((1 << 8) * field.p - 1, (1 << 8) * field.p),
                 ((1 << 16) * field.p, field.p), (field.p, (1 << 16) * field.p),
                 ((1 << 16) * field.p * field.p // (2 * field.p - 1),
                  2 * field.p - 1),
                 ((1 << 16 * field.n) - 1, 1), (1, (1 << 16 * field.n) - 1)]
    for field in (FQ, FR)}


def lane_words(values, nw):
    """Packed words of each value as numpy uint64 arrays over the lanes."""
    return [np.array([(v >> (32 * k)) & MASK for v in values],
                     dtype=np.uint64) for k in range(nw)]


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("field", [FQ, FR], ids=["Fq", "Fr"])
def test_mont_mul_split_matches_plain_at_its_contract(field, G):
    """mont_mul_kernel<G, NW>: the product over Fq's 13 words (R = 2^400)
    and Fr's 9 (R = 2^272), G = 1 the one-thread mont_words, else split
    over G threads, on 4096 seeded lanes (a, b < 2^8 p) and the contract's
    edges (0, p - 1, 2p - 1, products at 2^16 p^2, an operand at 2^(16 n)
    - 1), limb for limb against mont_mul_plain, every bound of the twin
    held; 2 NW + 6 exchanges a split product."""
    p, nw = field.p, (field.n + 1) // 2
    rng = np.random.default_rng(20261019 + G + nw)
    top = (p << 8).bit_length() - 1
    draw = lambda: int.from_bytes(rng.bytes(36 if nw == 9 else 52),
                                  "little") % (1 << top)
    av, bv = [draw() for _ in range(4096)], [draw() for _ in range(4096)]
    edges = FIELD_EDGES[field.name]
    av[:len(edges)] = [a for a, _ in edges]
    bv[:len(edges)] = [b for _, b in edges]
    assert all(a * b <= (1 << 16) * p * p for a, b in zip(av, bv))
    pw = [(p >> (32 * k)) & MASK for k in range(nw - 1)]
    n0w = n0w_newton(pw[0])
    a, b = lane_words(av, nw), lane_words(bv, nw)
    if G == 1:
        words = mont_w32(a, b, pw, n0w, field.n0)
    else:
        grp = Group(G, nw)
        r = split_mont(grp, a, grp.own(b), grp.own(pw), n0w, field.n0)
        words = [r[j // grp.K][j % grp.K] for j in range(nw)]
        assert grp.exchanges == 2 * nw + 6
    got = np.stack([(words[i // 2] >> np.uint64(16 * (i % 2))) & 0xFFFF
                    for i in range(field.n)]).astype(np.int64)
    limbs = lambda vs: torch.tensor([[(v >> (16 * i)) & 0xFFFF for v in vs]
                                     for i in range(field.n)],
                                    dtype=torch.int64)
    want = cuda_fp.mont_mul_plain(field, limbs(av), limbs(bv))
    assert torch.equal(torch.from_numpy(got), want)
    assert G in (1, 2, 4, 8) and mul_group(field) in (1, 2, 4, 8)


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
    variants set kPowGroup to each other G of 1, 4, 8, 16; with --mont,
    kMulGroupFq and kMulGroupFr to each of 1, 2, 4, 8."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import groth_sahai_tpu_torch.utils.fp_variants as fv\n"
            "names = set(fv.variants())\n"
            "assert len(names) == 4 and 'as built' in names, names\n"
            "mont = set(fv.mont_variants())\n"
            "assert mont == {'as built', 'G=1', 'G=2', 'G=4', 'G=8'}, mont\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
            "       and (m == 'groth_sahai_tpu' or m.startswith(\n"
            "            ('groth_sahai_tpu.', 'jax.')) or m == 'jax')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=str(repo)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
