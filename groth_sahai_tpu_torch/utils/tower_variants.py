"""Group sizes of the grouped tower kernels, timed side by side.

    python3 -m groth_sahai_tpu_torch.utils.tower_variants [--step]
        [--against DIR]

Needs one NVIDIA H100 (sm_90a) and nvcc. Builds `csrc/tower_kernels.cu` as
it stands and with the threads a lane of fq12_mul, cyc_pow,
miller_iter_dbl, miller_iter_add and f12_pow_dyn (`kFq12MulGroup`,
`kCycPowGroup`, `kDblGroup`, `kAddGroup`, `kPowDynGroup`) all set to each
of 4, 8, 16 and 32 in copies of its sources, one nvcc each, all at once,
into `groth_sahai_tpu_torch/build/tower_variants/`. For each it prints
ptxas's report of the eight kernels and of `mont` (frame, spills,
registers) and their SASS (instructions, and the mix of their Montgomery
product), then times, by CUDA events, fq12_mul over 4 lanes (the final
exponentiation's products), 256, 2048 (the first halving of verify's
Miller product tree) and 4096 lanes, cyc_pow over 4 lanes (the
verifier's final exponentiation, e = |x|) and over 4096, miller_iter_dbl
over 4096 lanes (the verifier's Miller loop), miller_iter_add over 4096,
128 and 32 lanes (the verifier's; gs-e2e's widest and narrowest) and
f12_pow_dyn over 4096 and 1024 lanes (gt-exp-4096's two calls: random
255-bit scalars), in the order as built, variants, as built, each
variant's outputs against the committed build's; the committed build's
against the plain versions. With
`--against DIR`, the tower library built from the kernel sources in DIR
(another checkout's `groth_sahai_tpu_torch/csrc`, with the same C entry
points) is timed as one more variant. Inputs are seeded, at the kernels'
input bounds. Prints the card's name and power limit.

With `--step`, the two steps' threads a lane (`kDblStepGroup`,
`kAddStepGroup`) are set together to each of STEP_GROUPS, and cyc_sqr's
(`kCycSqrGroup`) to each of CYC_SQR_GROUPS, instead; miller_dbl_step and
miller_add_step over 4096 lanes (miller-steps-4096's), miller_iter_dbl and
miller_iter_add over 4096 (the kernels whose point levels the steps
share) and cyc_sqr over 4096 (pairing-4096's) are timed, each by the
profiler's device time a launch and CUDA events a call.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import sys

import torch

from ..ops import bls12_381 as C
from ..ops import cuda_build
from ..ops import cuda_tower as CT
from ..ops.cuda_build import check, host_words
from ..ops.fp import FQ, FR
from .curve_variants import _bind, _device_ms, _events_ms, _limbs, \
    build_variants, card_line, group_variants, ptxas_report, sass_report

OUT = cuda_build.BUILD_DIR / "tower_variants"
TOWER_SASS = (r"(fq12_mul|cyc_pow|cyc_sqr|miller_iter_dbl|miller_iter_add|"
              r"f12_pow_dyn|miller_dbl_step|miller_add_step)_kernelILi(\d+)E",
              "{} at {} threads a lane")
# ptxas lines: the eight kernels, and the Montgomery product they call
PTXAS = (r"fq12_mul_kernel|cyc_pow_kernel|cyc_sqr_kernel|"
         r"miller_iter_dbl_kernel|miller_iter_add_kernel|f12_pow_dyn_kernel|"
         r"miller_dbl_step_kernel|miller_add_step_kernel|mont")
STEP_GROUPS = (4, 8, 16)
CYC_SQR_GROUPS = (4, 8, 16, 32)
_STEP_CONST = re.compile(r"(constexpr int (kDblStepGroup|kAddStepGroup) = )"
                         r"(\d+);")
_CYC_SQR_CONST = re.compile(r"(constexpr int (kCycSqrGroup) = )(\d+);")
_CONST = re.compile(r"(constexpr int (kFq12MulGroup|kCycPowGroup|"
                    r"kDblGroup|kAddGroup|kPowDynGroup) = )(\d+);")


def built_groups(const=_CONST) -> dict:
    """The committed group sizes by constant name."""
    text = (cuda_build.CSRC / "tower_kernels.cu").read_text()
    return {m.group(2): int(m.group(3)) for m in const.finditer(text)}


def variants() -> dict:
    """name -> {file: transform}: as built, then every G of GROUPS for all
    five kernels that is not the committed choice."""
    return group_variants("tower_kernels.cu", _CONST, built_groups())


def step_variants() -> dict:
    """As built, then the two steps at each G of STEP_GROUPS ("steps
    G=4", ...) and cyc_sqr at each G of CYC_SQR_GROUPS ("cyc_sqr G=4",
    ...) that is not the committed choice."""
    out = {}
    for label, const, groups in (("steps", _STEP_CONST, STEP_GROUPS),
                                 ("cyc_sqr", _CYC_SQR_CONST, CYC_SQR_GROUPS)):
        for name, edit in group_variants("tower_kernels.cu", const,
                                         built_groups(const), groups).items():
            out[name if name == "as built" else f"{label} {name}"] = edit
    return out


def _dbl_case(gen, lanes, args, stream):
    """miller_iter_dbl over `lanes` lanes: f < 2p, X, Z < 2p, Y < 10p, P < p."""
    f = _limbs((12, lanes), 2, gen)
    R = [_limbs((2, lanes), b, gen) for b in (2, 10, 2)]
    P = [_limbs((lanes,), 1, gen) for _ in range(2)]

    def dbl_call(lib, f=f, R=R, P=P, lanes=lanes):
        fo = torch.empty_like(f)
        rs = [torch.empty_like(R[0]) for _ in range(3)]
        check(lib.gs_miller_iter_dbl(
            FQ.n, *(x.data_ptr() for x in [f] + R + P + [fo] + rs), lanes,
            *args, host_words(FQ, CT.TWO_INV_MONT), FQ.n0, stream),
            "miller_iter_dbl", FQ.n)
        return [fo] + rs

    def dbl_plain(f=f, R=R, P=P):
        fo, rs = CT.miller_iter_dbl_plain(f, tuple(R), *P)
        return [fo] + list(rs)
    return (f"miller_iter_dbl, {lanes} lanes", lanes, dbl_call, dbl_plain)


def _add_case(gen, lanes, args, stream):
    """miller_iter_add over `lanes` lanes: f < 2p, X, Z < 2p, Y < 10p,
    Q, P < p."""
    f = _limbs((12, lanes), 2, gen)
    R = [_limbs((2, lanes), b, gen) for b in (2, 10, 2)]
    Q = [_limbs((2, lanes), 1, gen) for _ in range(2)]
    P = [_limbs((lanes,), 1, gen) for _ in range(2)]

    def add_call(lib, f=f, R=R, Q=Q, P=P, lanes=lanes):
        fo = torch.empty_like(f)
        rs = [torch.empty_like(R[0]) for _ in range(3)]
        check(lib.gs_miller_iter_add(
            FQ.n, *(x.data_ptr() for x in [f] + R + Q + P + [fo] + rs),
            lanes, *args, FQ.n0, stream), "miller_iter_add", FQ.n)
        return [fo] + rs

    def add_plain(f=f, R=R, Q=Q, P=P):
        fo, rs = CT.miller_iter_add_plain(f, tuple(R), tuple(Q), *P)
        return [fo] + list(rs)
    return (f"miller_iter_add, {lanes} lanes", lanes, add_call, add_plain)


def step_cases(gen):
    """miller_dbl_step over 4096 lanes (X, Z < 2p, Y < 10p), then
    miller_iter_dbl over 4096; miller_add_step over 4096 (Q < p) and
    miller_iter_add over 4096; cyc_sqr over 4096 (a < 2p)."""
    args = (host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p))
    stream = torch.cuda.current_stream().cuda_stream
    lanes = 4096
    R = [_limbs((2, lanes), b, gen) for b in (2, 10, 2)]
    Q = [_limbs((2, lanes), 1, gen) for _ in range(2)]
    a = _limbs((12, lanes), 2, gen)

    def step_call(lib, R=R, lanes=lanes):
        outs = [torch.empty_like(R[0]) for _ in range(6)]
        check(lib.gs_miller_dbl_step(
            FQ.n, *(x.data_ptr() for x in R + outs), lanes, *args,
            host_words(FQ, CT.TWO_INV_MONT), FQ.n0, stream),
            "miller_dbl_step", FQ.n)
        return outs

    def step_plain(R=R):
        R3, line = CT.miller_dbl_step_plain(tuple(R), (FQ.p + 1) // 2)
        return list(R3) + list(line)

    def add_step_call(lib, R=R, Q=Q, lanes=lanes):
        outs = [torch.empty_like(R[0]) for _ in range(6)]
        check(lib.gs_miller_add_step(
            FQ.n, *(x.data_ptr() for x in R + Q + outs), lanes, *args,
            FQ.n0, stream), "miller_add_step", FQ.n)
        return outs

    def add_step_plain(R=R, Q=Q):
        R3, line = CT.miller_add_step_plain(tuple(R), tuple(Q))
        return list(R3) + list(line)

    def sqr_call(lib, a=a, lanes=lanes):
        o = torch.empty_like(a)
        check(lib.gs_cyc_sqr(FQ.n, a.data_ptr(), o.data_ptr(), lanes, *args,
                             FQ.n0, stream), "cyc_sqr", FQ.n)
        return [o]
    return [(f"miller_dbl_step, {lanes} lanes", lanes, step_call,
             step_plain), _dbl_case(gen, lanes, args, stream),
            (f"miller_add_step, {lanes} lanes", lanes, add_step_call,
             add_step_plain), _add_case(gen, lanes, args, stream),
            (f"cyc_sqr, {lanes} lanes", lanes, sqr_call,
             lambda a=a: [CT.cyc_sqr_plain(a)])]


def cases(gen):
    """(name, lanes, fn(lib) -> outputs, plain outputs) of the timed calls."""
    args = (host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p))
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for lanes in (4, 256, 2048, 4096):
        a, b = (_limbs((12, lanes), 32, gen) for _ in range(2))

        def mul_call(lib, a=a, b=b, lanes=lanes):
            o = torch.empty_like(a)
            check(lib.gs_fq12_mul(FQ.n, a.data_ptr(), b.data_ptr(),
                                  o.data_ptr(), lanes, *args, FQ.n0, stream),
                  "fq12_mul", FQ.n)
            return [o]
        out.append((f"fq12_mul, {lanes} lanes", lanes, mul_call,
                    lambda a=a, b=b: [CT.fq12_mul_plain(a, b)]))
    for lanes in (4, 4096):
        a = _limbs((12, lanes), 2, gen)

        def pow_call(lib, a=a, lanes=lanes):
            o = torch.empty_like(a)
            check(lib.gs_cyc_pow(FQ.n, a.data_ptr(), abs(C.X), o.data_ptr(),
                                 lanes, *args, FQ.n0, stream), "cyc_pow", FQ.n)
            return [o]
        out.append((f"cyc_pow, {lanes} lanes", lanes, pow_call,
                    lambda a=a: [CT.cyc_pow_plain(a, abs(C.X))]))
    out.append(_dbl_case(gen, 4096, args, stream))
    out += [_add_case(gen, lanes, args, stream) for lanes in (4096, 128, 32)]
    for lanes in (4096, 1024):
        a = _limbs((12, lanes), 2, gen)
        s = torch.randint(0, 1 << 16, (FR.n, lanes), generator=gen,
                          dtype=torch.int64, device="cuda")
        s[15] &= (1 << 15) - 1              # 255-bit scalars, like rho
        s[16:] = 0

        def pow_dyn_call(lib, a=a, s=s, lanes=lanes):
            o = torch.empty_like(a)
            check(lib.gs_f12_pow_dyn(FQ.n, FR.n, a.data_ptr(), s.data_ptr(),
                                     o.data_ptr(), lanes, *args, FQ.n0,
                                     stream), "f12_pow_dyn", FQ.n)
            return [o]
        out.append((f"f12_pow_dyn, {lanes} lanes", lanes, pow_dyn_call,
                    lambda a=a, s=s: [CT.f12_pow_dyn_plain(a, s)]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--step", action="store_true",
                    help="the doubling step's group sizes")
    ap.add_argument("--against", type=pathlib.Path, default=None,
                    help="another checkout's csrc/ to time beside these")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("tower_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    if opts.step:
        print(f"as built: {built_groups(_STEP_CONST)} "
              f"{built_groups(_CYC_SQR_CONST)}", flush=True)
        edits, make = step_variants(), step_cases
    else:
        print(f"as built: {built_groups()}", flush=True)
        edits, make = variants(), cases
    sources = {}
    if opts.against:
        edits["against"] = {}
        sources["against"] = opts.against.resolve()
    built = build_variants("tower_kernels.cu", edits, OUT, sources)
    for name, (lib, log) in built.items():
        for line in sass_report(lib, TOWER_SASS) + ptxas_report(log, PTXAS):
            print(f"[{name}] {line}", flush=True)
    libs = {name: _bind(lib, CT.LIBRARY) for name, (lib, _) in built.items()}
    gen = torch.Generator("cuda").manual_seed(20261018)
    order = list(libs) + ["as built"]
    for what, lanes, fn, plain in make(gen):
        want = fn(libs["as built"])
        exact = all(torch.equal(a, b) for a, b in zip(want, plain()))
        print(f"[plain] {what}: as built "
              f"{'equals' if exact else 'DIFFERS FROM'} the plain version",
              flush=True)
        if not exact:
            return 1
        reps = 3 if "f12_pow_dyn" in what else 5 if "cyc_pow" in what \
            else 20
        for name in order:
            same = all(torch.equal(a, b) for a, b in zip(fn(libs[name]),
                                                         want))
            ms = _events_ms(lambda: fn(libs[name]), reps)
            timed = f"{ms:.4f} ms a launch"
            if opts.step:
                dev = _device_ms(lambda: fn(libs[name]), reps,
                                 what.split(",")[0])
                timed = (f"device {dev:.4f} ms a launch" if dev is not None
                         else "device not recorded") + \
                    f" (events {ms:.4f} ms a call)"
            print(f"[time] {what}: {name}: {timed}, outputs "
                  f"{'equal' if same else 'DIFFERENT'}", flush=True)
            if not same:
                return 1
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
