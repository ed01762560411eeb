"""Group sizes of the field kernels' split products, timed side by side.

    python3 -m groth_sahai_tpu_torch.utils.fp_variants [--mont] [--against DIR]

Needs one NVIDIA H100 (sm_90a) and nvcc. Builds `csrc/fp_kernels.cu` as it
stands and with each other threads a lane of GROUPS in copies of its
sources, one nvcc each, all at once, into
`groth_sahai_tpu_torch/build/fp_variants/`; prints ptxas's report of the
kernels (frame, spills, registers) and their SASS instructions; then
times the calls in the order as built, variants, as built, each
variant's outputs against the committed build's, the committed build's
against the plain version.

With no option: Fq's pow_const (`kPowGroup`: 1 is field_w32.cuh's
one-thread `mont`, 4 to 16 the product split over the group,
field_split_w32.cuh), by CUDA events, e = p - 2 (the Fermat inverse) at
the lanes the paths launch it with: 4 (final_exp's inverse of the 2 x 2
GT on the verifier's signed product), 21 (`to_affine` of verify's Gamma
d), 2 and 16 (the prove paths' `to_affine`), 4096 and 8192 (the pairing
paths' final_exp).

With `--mont`: mont_mul over Fq and Fr (`kMulGroupFq`, `kMulGroupFr`, both
set to each of MUL_GROUPS: 1 is field_w32.cuh's one-thread mont_words,
2 to 8 the split), by the profiler's device time a launch (and CUDA
events a call), at MONT_LANES: Fq over 16384 lanes (pairing-8192's
FQ2.mul_fq), verify-ppe-334's three most-launched shapes (all Fq) and
every shape the paths launch over Fr (chip_smoke.py prints them).

With `--against DIR`, the field library built from the kernel sources in
DIR (another checkout's `groth_sahai_tpu_torch/csrc`, the same C entry
points) is timed as one more variant. Inputs are seeded: pow_const's
below 2p, mont_mul's below 2^8 p (value(a) value(b) <= 2^16 p^2). Prints
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import sys

import torch

from ..ops import cuda_build
from ..ops import cuda_fp as K
from ..ops.cuda_build import check, host_words
from ..ops.fp import FQ, FR
from .curve_variants import (_bind, _device_ms, _events_ms, _limbs,
                             build_variants, card_line, group_variants,
                             ptxas_report, sass_report)

OUT = cuda_build.BUILD_DIR / "fp_variants"
GROUPS = (1, 4, 8, 16)
MUL_GROUPS = (1, 2, 4, 8)
LANES = (4, 21, 2, 16, 4096, 8192)
# mont_mul's timed shapes (field, lanes): pairing-8192's widest, then
# verify-ppe-334's three most-launched (all Fq: 288 of its 300 launches at
# 21 lanes), then every shape the paths launch over Fr (verify none)
MONT_LANES = (("Fq", 16384), ("Fq", 21), ("Fq", 1336), ("Fq", 8),
              ("Fr", 1), ("Fr", 2), ("Fr", 4), ("Fr", 16), ("Fr", 1024))
FP_SASS = (r"((?:fq_)?pow_const)_kernelILi(\d+)E", "{}<{}>")
MONT_SASS = (r"mont_mul_kernelILi(\d+)ELi(\d+)E",
             "mont_mul at {} threads a lane over {} words")
PTXAS = r"mont_mul_kernel|(?:fq_)?pow_const_kernel|mont"
_CONST = re.compile(r"(constexpr int kPowGroup = )(\d+);")
_MUL_CONST = re.compile(r"(constexpr int (kMulGroupFq|kMulGroupFr) = )"
                        r"(\d+);")


def built_group() -> int:
    """The committed kPowGroup."""
    text = (cuda_build.CSRC / "fp_kernels.cu").read_text()
    return int(_CONST.search(text).group(2))


def built_mul_groups() -> dict:
    """The committed kMulGroupFq and kMulGroupFr."""
    text = (cuda_build.CSRC / "fp_kernels.cu").read_text()
    return {m.group(2): int(m.group(3)) for m in _MUL_CONST.finditer(text)}


def variants() -> dict:
    """name -> {file: transform}: as built, then each other G of GROUPS."""
    out = {"as built": {}}
    for g in GROUPS:
        if g != built_group():
            out[f"G={g}"] = {"fp_kernels.cu": lambda s, g=g: _CONST.sub(
                lambda m: f"{m.group(1)}{g};", s)}
    return out


def mont_variants() -> dict:
    """As built, then mont_mul at each G of MUL_GROUPS for both fields."""
    return group_variants("fp_kernels.cu", _MUL_CONST, built_mul_groups(),
                          MUL_GROUPS)


def cases(gen):
    """(name, fn(lib) -> output, plain output) of the timed calls."""
    e = FQ.p - 2
    bits = torch.tensor(K.exponent_bits(e), dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for lanes in LANES:
        a = _limbs((lanes,), 2, gen)

        def call(lib, a=a, lanes=lanes):
            o = torch.empty_like(a)
            check(lib.gs_pow_const(
                FQ.n, a.data_ptr(), bits.data_ptr(), bits.numel(),
                o.data_ptr(), lanes, host_words(FQ, FQ.p),
                host_words(FQ, FQ.r_mod_p), FQ.n0, stream), "pow_const", FQ.n)
            return o
        out.append((f"pow_const, {lanes} lanes", call,
                    lambda a=a: K.pow_const_plain(FQ, a, e)))
    return out


def mont_cases(gen):
    """(name, fn(lib) -> output, plain output) of mont_mul at MONT_LANES:
    values below 2^8 p."""
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for name, lanes in MONT_LANES:
        field = FQ if name == "Fq" else FR
        top = (field.p << 8).bit_length() - 1
        a, b = (torch.randint(0, 1 << 16, (field.n, lanes), generator=gen,
                              dtype=torch.int64, device="cuda")
                for _ in range(2))
        for x in (a, b):
            for i in range(field.n):
                x[i] &= (1 << max(0, min(16, top - 16 * i))) - 1

        def call(lib, a=a, b=b, lanes=lanes, field=field):
            o = torch.empty_like(a)
            check(lib.gs_mont_mul(field.n, a.data_ptr(), b.data_ptr(),
                                  o.data_ptr(), lanes,
                                  host_words(field, field.p), field.n0,
                                  stream), "mont_mul", field.n)
            return o
        out.append((f"mont_mul {name}, {lanes} lanes", call,
                    lambda a=a, b=b, field=field: K.mont_mul_plain(field, a,
                                                                   b)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mont", action="store_true",
                    help="mont_mul's group sizes (default: pow_const's)")
    ap.add_argument("--against", type=pathlib.Path, default=None,
                    help="another checkout's csrc/ to time beside these")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    if opts.mont:
        print(f"as built: {built_mul_groups()}", flush=True)
        edits, sass, make = mont_variants(), MONT_SASS, mont_cases
    else:
        print(f"as built: kPowGroup = {built_group()}", flush=True)
        edits, sass, make = variants(), FP_SASS, cases
    sources = {}
    if opts.against:
        edits["against"] = {}
        sources["against"] = opts.against.resolve()
    built = build_variants("fp_kernels.cu", edits, OUT, sources)
    for name, (lib, log) in built.items():
        for line in sass_report(lib, sass) + ptxas_report(log, PTXAS):
            print(f"[{name}] {line}", flush=True)
    libs = {name: _bind(lib, K.LIBRARY) for name, (lib, _) in built.items()}
    gen = torch.Generator("cuda").manual_seed(20261018)
    order = list(libs) + ["as built"]
    for what, fn, plain in make(gen):
        want = fn(libs["as built"])
        exact = torch.equal(want, plain())
        print(f"[plain] {what}: as built "
              f"{'equals' if exact else 'DIFFERS FROM'} the plain version",
              flush=True)
        if not exact:
            return 1
        for name in order:
            same = torch.equal(fn(libs[name]), want)
            if opts.mont:
                dev = _device_ms(lambda: fn(libs[name]), 50, "mont_mul")
                ms = _events_ms(lambda: fn(libs[name]), 50)
                timed = (f"device {dev:.5f} ms a launch" if dev is not None
                         else "device not recorded") + \
                    f" (events {ms:.5f} ms a call)"
            else:
                ms = _events_ms(lambda: fn(libs[name]), 5)
                timed = f"{ms:.4f} ms a launch"
            print(f"[time] {what}: {name}: {timed}, output "
                  f"{'equal' if same else 'DIFFERENT'}", flush=True)
            if not same:
                return 1
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
