#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. build   -- nvcc builds the kernel libraries from groth_sahai_tpu_torch/csrc
                for sm_90a, one process per source, all at once; prints the
                build time, the compiler's resource report and the card's
                name and power limit;
  2. kernels -- each of the six kernels against its plain PyTorch version on
                the card, bit-exact, at the shapes the main path gives it:
                the field kernels at Fq width over the pairing's stacks
                (16384, 442368, 98304 and 8192 lanes) and at Fr width over
                8192 lanes; the tower kernels over 4096 and 4 lanes (the
                signed product's tree reduction and final exponentiation).
                Seeded random inputs plus edge lanes at the top of each
                kernel's input bound (0, 1, p-1, 2p-1, value(a)*value(b) =
                2^16 p^2, wide t = p R - 1; Fq12 coefficients 32p - 1);
  3. pairing -- `pairing(P, Q)` over 8192 pairs (P_i = a_i G1, Q_i = b_i G2,
                a few infinity lanes); sampled lanes against the host oracle
                and the GT product of all lanes against e(G1, G2)^(sum a_i b_i);
  4. signed  -- the verifier's signed Miller product at Kp = 2048 with a
                mixed conjugation mask, then `final_exp`; each (i, j) entry
                against e(G1, G2)^(sum_k +-a_ik b_jk);
  5. report  -- launch counts of phases 3 and 4 (every kernel of a path must
                have run on it), each kernel's device time per launch
                (profiler) at its path shape beside its bound, the plain
                version's time (CUDA events), one `kernels` JSON line, a
                profile of each path, then the result line.

Imports nothing of JAX or of the JAX package. Needs one card.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
import traceback

BATCH = 8192          # pairs in phase 3
K_SIGNED = 2000       # pairs per entry in phase 4 (padded to Kp = 2048)
SEED = 20261017

# H100 SXM peaks (NVIDIA data sheet; CUDA programming guide throughput table):
# HBM3 3.35 TB/s; 32-bit integer multiply-add 64 per clock per SM x 132 SMs
# x 1.98 GHz = 16.7e12 per second. Both assume the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_IMAD_PER_S = 64 * 132 * 1.98e9

FP_SOURCE = "groth_sahai_tpu_torch/csrc/fp_kernels.cu"
TOWER_SOURCE = "groth_sahai_tpu_torch/csrc/tower_kernels.cu"
ORIGIN = {   # kernel -> (the TPU kernel it replaces, its source in the port)
    "mont_mul": ("groth_sahai_tpu/ops/pallas_fp.py:188", FP_SOURCE),
    "mul_wide": ("groth_sahai_tpu/ops/pallas_fp.py:169", FP_SOURCE),
    "redc": ("groth_sahai_tpu/ops/pallas_fp.py:179", FP_SOURCE),
    "pow_const": ("groth_sahai_tpu/ops/pallas_fp.py:223", FP_SOURCE),
    "fq12_mul": ("groth_sahai_tpu/ops/pallas_tower.py:387", TOWER_SOURCE),
    "cyc_pow": ("groth_sahai_tpu/ops/pallas_tower.py:743", TOWER_SOURCE),
}
# The kernels each path must launch: at 8192 pairs the pairing runs the
# lazy tower over the field kernels alone; the signed product's reduction
# and final exponentiation run at <= 4096 lanes and take the tower kernels.
PATH_KERNELS = {"pairing": ("mont_mul", "mul_wide", "redc", "pow_const"),
                "signed": tuple(ORIGIN)}


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def kernels():
    """name -> wrapper of every ported kernel."""
    from groth_sahai_tpu_torch.ops import cuda_fp as K, cuda_tower as CT
    return {k.__name__: k for k in K.KERNELS + CT.KERNELS}


def reset_counts():
    from groth_sahai_tpu_torch.ops import cuda_fp as K, cuda_tower as CT
    K.reset_counts()
    CT.reset_counts()


def read_counts():
    return {name: k.launches for name, k in kernels().items()}


def time_ms(fn, reps: int) -> float:
    """Mean time of one call by CUDA events over `reps` back-to-back calls
    (device time plus whatever the host's issue of each call adds)."""
    import torch
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    sync()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernel: str) -> float:
    """Device time of one launch of `kernel` (the profiler's CUPTI record,
    without the host's issue time), averaged over the launches of `reps`
    calls that the profiler recorded (it may miss the first of a window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel + "_kernel" in e.key]
    count = sum(e.count for e in rows)
    if not 0 < count <= reps:
        raise AssertionError(f"the profiler saw {count} launches of {kernel} "
                             f"in {reps} calls")
    return sum(e.self_device_time_total for e in rows) / count / 1e3


# ----------------------------------------------------------------- phase 2

def rand_limbs(rows: int, lanes: int, bits: int, gen, device):
    """Random exact limbs of values < 2^bits, from a seeded generator."""
    import torch
    x = torch.randint(0, 1 << 16, (rows, lanes), generator=gen,
                      dtype=torch.int64)
    for i in range(rows):
        keep = max(0, min(16, bits - 16 * i))
        x[i] &= (1 << keep) - 1
    return x.to(device)


def edge_limbs(values, rows: int, device):
    import numpy as np
    import torch
    from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
    return torch.as_tensor(ints_to_limbs(values, rows).astype(np.int64),
                           device=device)


def field_inputs(field, lanes: int, gen, device):
    """(a, b, t) for one field: random lanes with value(a), value(b) < 2^8 p
    (so value(a)*value(b) <= 2^16 p^2) and t < p R, then the edge lanes."""
    p, n = field.p, field.n
    top = (p << 8).bit_length() - 1                  # 2^top <= 2^8 p
    wide_top = (p * field.R_int).bit_length() - 1    # 2^wide_top <= p R
    a = rand_limbs(n, lanes, top, gen, device)
    b = rand_limbs(n, lanes, top, gen, device)
    t = rand_limbs(2 * n + 1, lanes, wide_top, gen, device)
    edge_a = [0, 1, p - 1, 2 * p - 1, p << 8, p << 16, (p << 16) - 1, p - 1]
    edge_b = [p - 1, 1, p - 1, 2 * p - 1, p << 8, p, p, 0]
    assert all(x * y <= (p * p) << 16 for x, y in zip(edge_a, edge_b))
    edge_t = [p * field.R_int - 1, 0, 1, p, (p * p) << 16, p * field.R_int // 2,
              field.R_int, field.R_int - 1]
    k = len(edge_a)
    a[:, :k] = edge_limbs(edge_a, n, device)
    b[:, :k] = edge_limbs(edge_b, n, device)
    t[:, :k] = edge_limbs(edge_t, 2 * n + 1, device)
    return a, b, t


def fq12_inputs(lanes: int, bound_p: int, gen, device, edges):
    """int64 [25, 12, lanes] with coefficients < bound_p * p; lane k of the
    first len(edges) has every coefficient equal to edges[k]."""
    from groth_sahai_tpu_torch.ops.fp import FQ
    bits = (bound_p * FQ.p).bit_length() - 1         # 2^bits <= bound_p p
    x = rand_limbs(FQ.n, 12 * lanes, bits, gen, device).reshape(
        FQ.n, 12, lanes)
    for k, v in enumerate(edges[:lanes]):
        x[:, :, k] = edge_limbs([v], FQ.n, device)
    return x


# The shapes that carry each kernel on the main path, in lanes: at 8192
# pairs mont_mul runs over an Fq2 batch (FQ2.mul_fq in the Miller steps),
# mul_wide over the Fq12 product's 54 stacked Fq products, redc over its 12
# coefficients, pow_const over the Fq inverse of final_exp; on the signed
# product fq12_mul takes the first tree-reduction step, (2, 2, 1024) = 4096
# lanes, and cyc_pow the final exponentiation's (2, 2) = 4 lanes.
PATH_LANES = {"mont_mul": 2 * BATCH, "mul_wide": 54 * BATCH,
              "redc": 12 * BATCH, "pow_const": BATCH,
              "fq12_mul": 4096, "cyc_pow": 4}


def make_cases(device):
    """(name, field, lanes, args) for every kernel at its path shape (Fq),
    the field kernels at Fr width and the tower kernels at 4 lanes too."""
    import torch
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.fp import FQ, FR
    gen = torch.Generator().manual_seed(SEED)
    cases = []
    for field, lanes in ((FQ, None), (FR, BATCH)):
        for name in ("mont_mul", "mul_wide", "redc", "pow_const"):
            m = lanes or PATH_LANES[name]
            a, b, t = field_inputs(field, m, gen, device)
            args = {"mont_mul": (a, b), "mul_wide": (a, b), "redc": (t,),
                    "pow_const": (a, field.p - 2)}[name]
            cases.append((name, field, m, (field,) + args))
    p = FQ.p
    top = 32 * p - 1                     # bound(a) bound(b) <= 1024 p^2
    for m in (PATH_LANES["fq12_mul"], 4):
        a = fq12_inputs(m, 32, gen, device, [top, top, 0, p - 1])
        b = fq12_inputs(m, 32, gen, device, [top, 1, top, p - 1])
        cases.append(("fq12_mul", FQ, m, (a, b)))
    v_abs = abs(C.X) + 1
    for e in (v_abs // 3, v_abs, abs(C.X)):  # the final exp's exponents
        a = fq12_inputs(PATH_LANES["cyc_pow"], 2, gen, device,
                        [2 * p - 1, 0])
        cases.append(("cyc_pow", FQ, PATH_LANES["cyc_pow"], (a, e)))
    return cases


def plain_of(name):
    from groth_sahai_tpu_torch.ops import cuda_fp as K, cuda_tower as CT
    plain = dict(K.PLAIN)
    plain.update(CT.PLAIN)
    return plain[kernels()[name]]


def compare(name, args):
    """Kernel and plain version on the same inputs; max |difference|."""
    got, want = kernels()[name](*args), plain_of(name)(*args)
    sync()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    return int((got - want).abs().max().item())


def check_kernels(device):
    """Phase 2: every kernel bit-exact against its plain version at its
    path's shapes. Returns (worst error by kernel, the timing cases)."""
    from groth_sahai_tpu_torch.ops import cuda_fp as K
    from groth_sahai_tpu_torch.ops.fp import FQ
    worst = {name: 0 for name in ORIGIN}
    timing = {}
    for name, field, lanes, args in make_cases(device):
        err = compare(name, args)
        worst[name] = max(worst[name], err)
        print(f"[kernels] {field.name} {name:9s} lanes={lanes:6d} "
              f"max_abs_err={err}", flush=True)
        if err != 0:
            raise AssertionError(f"{name} on {field.name} differs from "
                                 f"its plain version")
        if field is FQ and lanes == PATH_LANES[name]:
            timing[name] = args
    # the Fermat inverse really inverts: a * a^(p-2) == 1 on random lanes
    import torch
    gen = torch.Generator().manual_seed(SEED + 1)
    fq_a = field_inputs(FQ, 256, gen, device)[0][:, 8:]
    prod = FQ.normalize(FQ.mul(FQ.normalize(fq_a, k=256),
                               K.pow_const(FQ, fq_a, FQ.p - 2)))
    one = FQ.normalize(FQ.one((fq_a.shape[1],), device=device))
    if not bool((prod == one).all()):
        raise AssertionError("pow_const(a, p-2) is not the inverse of a")
    return worst, timing


# ----------------------------------------------------------- phases 3 and 4

def host_multiples(count: int):
    """[k G1 for k = 1..count], [k G2 for k = 1..count] by repeated addition."""
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    g1 = (H.C.G1_GEN_X, H.C.G1_GEN_Y)
    g2 = (H.C.G2_GEN_X, H.C.G2_GEN_Y)
    p1, p2 = [g1], [g2]
    for _ in range(count - 1):
        p1.append(H.g1_add(p1[-1], g1))
        p2.append(H.g2_add(p2[-1], g2))
    return p1, p2


def gt_power(e: int):
    """e(G1, G2)^e on the host, in the port's Fq12 int layout."""
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    return H.f12_pow(H.pairing_gen(), e % H.R)


def pairing_inputs(mult1, mult2, rng):
    """Scalars a_i, b_i (0 = infinity) and the affine point lists."""
    a = list(range(1, BATCH + 1))
    b = list(range(1, BATCH + 1))
    rng.shuffle(b)
    for lane in (3, BATCH // 2):             # infinity P
        a[lane] = 0
    for lane in (BATCH // 3, BATCH - 2):     # infinity Q
        b[lane] = 0
    a[BATCH - 1] = b[BATCH - 1] = 0          # infinity on both sides
    P = [None if k == 0 else mult1[k - 1] for k in a]
    Q = [None if k == 0 else mult2[k - 1] for k in b]
    return a, b, P, Q


def run_pairing(device, mult1, mult2, rng):
    """Phase 3 main path. Returns (counts, seconds, checks seconds)."""
    import torch
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_from_ints,
                                                 g2_affine_from_ints)
    from groth_sahai_tpu_torch.ops.pairing import pairing, _product_reduce
    from groth_sahai_tpu_torch.ops.tower import FQ12
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    a, b, P_pts, Q_pts = pairing_inputs(mult1, mult2, rng)
    P = g1_affine_from_ints(P_pts, device=device)
    Q = g2_affine_from_ints(Q_pts, device=device)
    sync()

    reset_counts()
    t0 = time.perf_counter()
    e = pairing(P, Q)
    sync()
    secs = time.perf_counter() - t0
    counts = read_counts()

    t0 = time.perf_counter()
    if tuple(e.shape) != (25, 12, BATCH):
        raise AssertionError(f"pairing output shape {tuple(e.shape)}")
    sample = [0, 3, BATCH // 3, BATCH - 1] + rng.sample(range(BATCH), 6)
    got = FQ12.to_ints(e[:, :, torch.as_tensor(sample, device=device)])
    for lane, g in zip(sample, got):
        want = H.pairing(P_pts[lane], Q_pts[lane])
        if g != want:
            raise AssertionError(f"pairing lane {lane} differs from the host")
    total = FQ12.to_ints(_product_reduce(e, axis=0))[0]
    if total != gt_power(sum(x * y for x, y in zip(a, b))):
        raise AssertionError("GT product of all pairing lanes is wrong")
    print(f"[pairing] {BATCH} pairs: {secs:.3f} s on the card; lanes "
          f"{sample} match the host; GT product of all lanes matches",
          flush=True)
    return counts, secs, time.perf_counter() - t0, (P, Q)


def run_signed(device, mult1, mult2, rng):
    """Phase 4 main path: signed Miller product at Kp = 2048 + final_exp."""
    import numpy as np
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_from_ints,
                                                 g2_affine_from_ints)
    from groth_sahai_tpu_torch.models import kernels as MK
    from groth_sahai_tpu_torch.ops.tower import FQ12
    k = K_SIGNED
    sa = [[rng.randrange(1, len(mult1) + 1) for _ in range(k)] for _ in range(2)]
    sb = [[rng.randrange(1, len(mult2) + 1) for _ in range(k)] for _ in range(2)]
    sa[0][k // 2] = 0                              # an infinity commitment
    mask = np.array([rng.random() < 0.5 for _ in range(k)], dtype=bool)

    def com(pts_of, scal, from_ints):
        flat = [None if s == 0 else pts_of[s - 1] for row in scal for s in row]
        x, y, inf = from_ints(flat, device=device)
        shape = lambda t: t.reshape(t.shape[:-1] + (2, k))
        return (shape(x), shape(y), inf.reshape(2, k))

    com1 = com(mult1, sa, g1_affine_from_ints)
    com2 = com(mult2, sb, g2_affine_from_ints)
    sync()

    reset_counts()
    t0 = time.perf_counter()
    f = MK.miller_product_signed(com1, com2, mask)
    out = MK.final_exp(f)
    sync()
    secs = time.perf_counter() - t0
    counts = read_counts()

    t0 = time.perf_counter()
    if tuple(out.shape) != (25, 12, 2, 2):
        raise AssertionError(f"signed product shape {tuple(out.shape)}")
    got = FQ12.to_ints(out.reshape(25, 12, 4))
    for i in range(2):
        for j in range(2):
            ex = sum((-1 if mask[q] else 1) * sa[i][q] * sb[j][q]
                     for q in range(k))
            if got[2 * i + j] != gt_power(ex):
                raise AssertionError(f"signed product entry ({i},{j}) wrong")
    print(f"[signed] Kp={MK.next_pow2(k)} (K={k}): {secs:.3f} s on the card; "
          f"all four entries match the host", flush=True)
    return counts, secs, time.perf_counter() - t0, (com1, com2, mask)


# ----------------------------------------------------------------- phase 5

def bound_ms(name: str, lanes: int, args) -> tuple:
    """The least time of one launch on this card: (ms, "bytes" or
    "operations"). Bytes: int64 limbs read and written once (8 bytes per
    16-bit limb). Operations: 16x16-bit products, one 32-bit multiply-add
    each -- CIOS 2n^2 per Montgomery product, n^2 for a schoolbook product
    or a reduction; an Fq12 product is 66 Montgomery products (54 Karatsuba
    + 12 post-reductions), a cyclotomic square 30 (18 + 12). The chains
    count what this exponent needs: a square per bit, a product per set
    bit."""
    from groth_sahai_tpu_torch.ops import cuda_fp as K
    from groth_sahai_tpu_torch.ops import cuda_tower as CT
    from groth_sahai_tpu_torch.ops.fp import FQ
    n = FQ.n
    mont = 2 * n * n
    if name == "pow_const":
        bits = K.exponent_bits(args[-1])
        products = (len(bits) + sum(bits)) * mont
    elif name == "cyc_pow":
        e = args[-1]
        products = (CT.CYC_POW_NBITS * 30 + bin(e).count("1") * 66) * mont
    else:
        products = {"mont_mul": mont, "mul_wide": n * n, "redc": n * n,
                    "fq12_mul": 66 * mont}[name]
    limbs = {"mont_mul": 3 * n, "mul_wide": 4 * n + 1, "redc": 3 * n + 1,
             "pow_const": 2 * n, "fq12_mul": 36 * n, "cyc_pow": 24 * n}[name]
    t_bytes = limbs * 8 * lanes / PEAK_BYTES_PER_S * 1e3
    t_ops = products * lanes / PEAK_IMAD_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_report(worst, timing, counts, by_path):
    """Each kernel at its path shape: device time per launch (profiler),
    the wrapper's time per call and the plain version's (CUDA events), its
    bound; the outputs of these inputs compared once more."""
    rows = []
    for name, (replaces, source) in ORIGIN.items():
        args, lanes = timing[name], PATH_LANES[name]
        kern, plain = kernels()[name], plain_of(name)
        saved = kern.launches
        err = compare(name, args)
        if err != 0:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"at the timing shape")
        slow = name in ("pow_const", "cyc_pow")
        ms = device_ms(lambda: kern(*args), 3 if slow else 20, name)
        wrapper_ms = time_ms(lambda: kern(*args), 3 if slow else 20)
        plain_ms = time_ms(lambda: plain(*args), 1 if slow else 5)
        kern.launches = saved          # timing launches are not path launches
        bound, by = bound_ms(name, lanes, args)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(worst[name], err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "lanes": lanes, "wrapper_ms": wrapper_ms,
            "launches_by_path": {path: c[name] for path, c in by_path.items()},
        })
        print(f"[report] {name:9s} lanes={lanes:6d} device {ms:.4f} ms per "
              f"launch (wrapper {wrapper_ms:.4f} ms per call, plain "
              f"{plain_ms:.4f} ms), bound {bound:.5f} ms by {by}", flush=True)
    return rows


def profile_path(path: str, fn):
    """Where the time of one run of a path goes: device time by kernel
    (torch.profiler), the ported kernels' share, the launch count and the
    device's busy share of the wall time (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        print(f"[profile] {path}: device time not measured (the profiler "
              f"recorded no CUDA kernels)", flush=True)
        return
    busy = sum(t for _, _, t in rows)
    ported = {}
    for name in ORIGIN:
        mine = [(c, t) for k, c, t in rows if name + "_kernel" in k]
        count, total = sum(c for c, _ in mine), sum(t for _, t in mine)
        ported[name] = {"count": count, "ms": total / 1e3,
                        "us_per_launch": total / count if count else None}
    ours = sum(f["ms"] for f in ported.values()) * 1e3
    summary = {
        "path": path, "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / wall_us,
        "ported_kernels_ms": ours / 1e3,
        "ported_kernels_share_of_busy": ours / busy,
        "ported_kernels": ported,
        "device_launches": sum(c for _, c, _ in rows),
        "top": [{"kernel": k[:90], "count": c, "ms": t / 1e3}
                for k, c, t in sorted(rows, key=lambda r: -r[2])[:8]],
    }
    print("[profile] " + json.dumps(summary), flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one H100",
              file=sys.stderr)
        return 2
    try:
        from groth_sahai_tpu_torch.ops import cuda_build, cuda_fp, cuda_tower
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable ({exc}); run it from "
              f"the repository's root", file=sys.stderr)
        return 2

    phases = {}
    try:
        device = torch.device("cuda", 0)
        t0 = time.perf_counter()
        libs = cuda_build.build_all([cuda_fp.LIBRARY, cuda_tower.LIBRARY])
        phases["build"] = time.perf_counter() - t0
        card = card_line()
        for lib in libs:      # ptxas: each kernel's registers and stack
            log = lib.with_suffix(".log")
            lines = log.read_text().splitlines() if log.exists() else []
            print(f"[build] {lib.name}", flush=True)
            for line in lines:
                if any(k in line for k in ("Function properties",
                                           "stack frame", "Used")):
                    print("    " + line.strip(), flush=True)
        print(f"[build] {len(libs)} libraries in {phases['build']:.1f} s on "
              f"{card}", flush=True)

        t0 = time.perf_counter()
        worst, timing = check_kernels(device)
        phases["kernels"] = time.perf_counter() - t0

        rng = random.Random(SEED)
        t0 = time.perf_counter()
        mult1, mult2 = host_multiples(BATCH)
        phases["host_inputs"] = time.perf_counter() - t0

        c_pair, phases["pairing"], phases["pairing_checks"], pq = run_pairing(
            device, mult1, mult2, rng)
        c_signed, phases["signed"], phases["signed_checks"], coms = run_signed(
            device, mult1, mult2, rng)
        by_path = {"pairing": c_pair, "signed": c_signed}
        for path, counts in by_path.items():
            print(f"[report] launches on the {path} path: {counts}",
                  flush=True)
            idle = [k for k in PATH_KERNELS[path] if counts[k] == 0]
            if idle:
                raise AssertionError(f"kernels never launched on the {path} "
                                     f"path: {idle}")
        total = {k: c_pair[k] + c_signed[k] for k in c_pair}

        t0 = time.perf_counter()
        rows = kernel_report(worst, timing, total, by_path)
        phases["report"] = time.perf_counter() - t0

        from groth_sahai_tpu_torch.models import kernels as MK
        from groth_sahai_tpu_torch.ops.pairing import pairing
        t0 = time.perf_counter()
        profile_path("pairing", lambda: pairing(*pq))
        profile_path("signed", lambda: MK.final_exp(
            MK.miller_product_signed(*coms)))
        phases["profile"] = time.perf_counter() - t0
        print("[phases] " + json.dumps({k: round(v, 3)
                                        for k, v in phases.items()}),
              flush=True)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
