"""Group sizes of pow_const's split product, timed side by side.

    python3 -m groth_sahai_tpu_torch.utils.fp_variants [--against DIR]

Needs one NVIDIA H100 (sm_90a) and nvcc. Builds `csrc/fp_kernels.cu` as it
stands and with Fq's pow_const at each other threads a lane of GROUPS
(`kPowGroup`: 1 is field_w32.cuh's one-thread `mont`, 4 to 16 the product
split over the group, field_split_w32.cuh) in copies of its sources, one
nvcc each, all at once, into `groth_sahai_tpu_torch/build/fp_variants/`.
For each it prints ptxas's report of the pow_const kernels and of `mont`
(frame, spills, registers) and their SASS instructions, then times, by
CUDA events, pow_const (e = p - 2, the Fermat inverse) at the lanes the
paths launch it with: 4 (final_exp's inverse of the 2 x 2 GT on the
verifier's signed product), 21 (`to_affine` of verify's Gamma d), 2 and 16
(the prove paths' `to_affine`), 4096 and 8192 (the pairing paths'
final_exp), in the order as built, variants, as built, each variant's
outputs against the committed build's, the committed build's against the
plain version. With `--against DIR`, the field library built from the
kernel sources in DIR (another checkout's `groth_sahai_tpu_torch/csrc`,
the same C entry points) is timed as one more variant. Inputs are seeded,
below 2p. Prints the card's name and power limit.
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
from ..ops.fp import FQ
from .curve_variants import (_bind, _events_ms, _limbs, build_variants,
                             card_line, ptxas_report, sass_report)

OUT = cuda_build.BUILD_DIR / "fp_variants"
GROUPS = (1, 4, 8, 16)
LANES = (4, 21, 2, 16, 4096, 8192)
FP_SASS = (r"((?:fq_)?pow_const)_kernelILi(\d+)E", "{}<{}>")
PTXAS = r"(?:fq_)?pow_const_kernel|mont"
_CONST = re.compile(r"(constexpr int kPowGroup = )(\d+);")


def built_group() -> int:
    """The committed kPowGroup."""
    text = (cuda_build.CSRC / "fp_kernels.cu").read_text()
    return int(_CONST.search(text).group(2))


def variants() -> dict:
    """name -> {file: transform}: as built, then each other G of GROUPS."""
    out = {"as built": {}}
    for g in GROUPS:
        if g != built_group():
            out[f"G={g}"] = {"fp_kernels.cu": lambda s, g=g: _CONST.sub(
                lambda m: f"{m.group(1)}{g};", s)}
    return out


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=pathlib.Path, default=None,
                    help="another checkout's csrc/ to time beside these")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    print(f"as built: kPowGroup = {built_group()}", flush=True)
    edits, sources = variants(), {}
    if opts.against:
        edits["against"] = {}
        sources["against"] = opts.against.resolve()
    built = build_variants("fp_kernels.cu", edits, OUT, sources)
    for name, (lib, log) in built.items():
        for line in sass_report(lib, FP_SASS) + ptxas_report(log, PTXAS):
            print(f"[{name}] {line}", flush=True)
    libs = {name: _bind(lib, K.LIBRARY) for name, (lib, _) in built.items()}
    gen = torch.Generator("cuda").manual_seed(20261018)
    order = list(libs) + ["as built"]
    for what, fn, plain in cases(gen):
        want = fn(libs["as built"])
        exact = torch.equal(want, plain())
        print(f"[plain] {what}: as built "
              f"{'equals' if exact else 'DIFFERS FROM'} the plain version",
              flush=True)
        if not exact:
            return 1
        for name in order:
            same = torch.equal(fn(libs[name]), want)
            ms = _events_ms(lambda: fn(libs[name]), 5)
            print(f"[time] {what}: {name}: {ms:.4f} ms a launch, output "
                  f"{'equal' if same else 'DIFFERENT'}", flush=True)
            if not same:
                return 1
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
