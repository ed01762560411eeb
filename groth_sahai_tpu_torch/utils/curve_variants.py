"""Design variants of the packed-word curve kernels, timed side by side.

    python3 -m groth_sahai_tpu_torch.utils.curve_variants
    python3 -m groth_sahai_tpu_torch.utils.curve_variants --groups [--against DIR]

Needs one NVIDIA H100 (sm_90a) and nvcc. With no option, builds
`csrc/curve_kernels.cu` as
it stands and in variants made by editing a copy of its sources, one nvcc
each, all at once, into `groth_sahai_tpu_torch/build/variants/`:

  as built           the committed design: the Montgomery product `mont`
                     out of line, operands and result by value (in
                     registers), the running sum split into even and odd
                     word arrays;
  one chain per half mont's first form: one running sum, each row's low
                     halves in one carry chain and its high halves in
                     another;
  operands by ref    mont out of line with its operands passed by
                     reference (through the stack);
  product inlined    mont inlined at every product of the bodies;
  first design       both of the last two: one chain per half, inlined.

For each it prints ptxas's report and the SASS of the two kernels (their
instructions, and the mix of their Montgomery product), then times `gs_cadd` on G2 at 2,757,504 lanes and
`gs_cmsm_row_scan` on G2 at 85,504 lanes x 128 rows (verify-ppe-334's
widest launches) by CUDA events, each variant's outputs against the
committed design's, in the order as built, variants, as built. Prints the
card's name and power limit. The committed design is held against the
plain versions by `chip_smoke.py`.

With `--groups`, builds the curve library as it stands and with the
threads a lane of cdbl_n_add and cmadd (`kCdblGroupG1`, `kCdblGroupG2`,
which both kernels take) both set to each of 2, 4, 8, 16 and 32,
into `groth_sahai_tpu_torch/build/cdbl_variants/`, prints ptxas's report
of the two kernels and of `mont` and their SASS, and times by CUDA events
cdbl_n_add at its four path shapes (G2, n = 8 over 668 lanes:
verify-ppe-334's window combination; G2 and G1, n = 4 over 1336 and 4096
lanes: the scalar multiplications of the commits and of
scalar-mul-g1-4096; G1, n = 13 over one lane: msm-g1-65536's) and cmadd
at its path shapes (G2 and G1 over 1336 lanes: the commits' window
tables; G1 over 4096: scalar-mul-g1-4096's; G2 over 128, 32 and 8 and G1
over 32: gs-e2e's), in the order as built, variants, as built, each
variant's outputs against the committed build's, the committed build's
against the plain version. `--against DIR` times the curve library of another checkout's
kernel sources (`groth_sahai_tpu_torch/csrc`, the same C entry points) as
one more variant.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import pathlib
import re
import subprocess
import sys

import torch

from ..ops import cuda_build
from ..ops import cuda_curve as CC
from ..ops.cuda_build import check, host_words
from ..ops.fp import FQ

OUT = cuda_build.BUILD_DIR / "variants"
GROUP_OUT = cuda_build.BUILD_DIR / "cdbl_variants"
GROUPS = (4, 8, 16, 32)
CDBL_SASS = (r"(cdbl_n_add|cmadd)_kernelILi([12])ELi(\d+)E",
             "{} G{} at {} threads a lane")
CDBL_PTXAS = r"cdbl_n_add_kernel|cmadd_kernel|mont"
_CDBL_CONST = re.compile(r"(constexpr int (kCdblGroupG1|kCdblGroupG2) = )"
                         r"(\d+);")
CURVE_GROUPS = (2,) + GROUPS     # --groups: the sizes timed

ROW_CHAINS = r'''
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

template <bool first>
__device__ __forceinline__ void mac_row(uint32_t (&t)[kWords + 1],
                                        uint32_t ai, const Fw& b) {
  if (first) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) t[j] = ai * b.w[j];
    t[1] = mad_hi_cc(ai, b.w[0], t[1]);
#pragma unroll
    for (int j = 1; j < kWords - 1; ++j)
      t[j + 1] = madc_hi_cc(ai, b.w[j], t[j + 1]);
    t[kWords] = madc_hi(ai, b.w[kWords - 1], 0);
  } else {
    t[0] = mad_lo_cc(ai, b.w[0], t[0]);
#pragma unroll
    for (int j = 1; j < kWords; ++j) t[j] = madc_lo_cc(ai, b.w[j], t[j]);
    t[kWords] = addc(0, 0);
    t[1] = mad_hi_cc(ai, b.w[0], t[1]);
#pragma unroll
    for (int j = 1; j < kWords - 1; ++j)
      t[j + 1] = madc_hi_cc(ai, b.w[j], t[j + 1]);
    t[kWords] = madc_hi(ai, b.w[kWords - 1], t[kWords]);
  }
}

__device__ __forceinline__ void mac_p(const FieldW& f,
                                      uint32_t (&t)[kWords + 1], uint32_t m) {
  t[0] = mad_lo_cc(m, f.p[0], t[0]);
#pragma unroll
  for (int j = 1; j < kPWords; ++j) t[j] = madc_lo_cc(m, f.p[j], t[j]);
  t[kPWords] = addc_cc(t[kPWords], 0);
  t[kWords] = addc(t[kWords], 0);
  t[1] = mad_hi_cc(m, f.p[0], t[1]);
#pragma unroll
  for (int j = 1; j < kPWords; ++j)
    t[j + 1] = madc_hi_cc(m, f.p[j], t[j + 1]);
  t[kWords] = addc(t[kWords], 0);
}

__device__ __noinline__ Fw mont(const FieldW& f, Fw a, Fw b) {
  uint32_t t[kWords + 1];
  mac_row<true>(t, a.w[0], b);
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if (i > 0) mac_row<false>(t, a.w[i], b);
    if (i < kWords - 1) {
      mac_p(f, t, t[0] * f.n0w);
#pragma unroll
      for (int j = 0; j < kWords; ++j) t[j] = t[j + 1];
      t[kWords] = 0;
    } else {
      mac_p(f, t, (t[0] * f.n0) & 0xFFFFu);
    }
  }
  Fw c;
#pragma unroll
  for (int j = 0; j < kWords; ++j) c.w[j] = __funnelshift_r(t[j], t[j + 1], 16);
  return c;
}

'''
MONT = "__device__ __noinline__ Fw mont(const FieldW& f, Fw a, Fw b) {"


def _one_chain_per_half(src: str) -> str:
    a = src.index("// Montgomery product a b 2^-400 mod p")
    b = src.index("}  // namespace w32")
    return src[:a] + ROW_CHAINS + src[b:]


def _inlined(src: str) -> str:
    return src.replace(MONT, "__device__ __forceinline__ Fw mont(const "
                             "FieldW& f, Fw a, Fw b) {")


VARIANTS = {
    "as built": lambda s: s,
    "one chain per half": _one_chain_per_half,
    "operands by ref": lambda s: s.replace(
        MONT, "__device__ __noinline__ Fw mont(const FieldW& f, const Fw& a, "
              "const Fw& b) {"),
    "product inlined": _inlined,
    "first design": lambda s: _inlined(_one_chain_per_half(s)),
}


def build_variants(source: str, edits: dict, out: pathlib.Path,
                   sources=None) -> dict:
    """One library of `source` per variant, all nvcc processes at once:
    edits maps a variant's name to {file name: transform of its text}
    (an empty dict builds the sources as they stand); sources maps a
    variant's name to another directory of sources than csrc/. Returns
    {name: (path, ptxas report)}."""
    jobs = {}
    for name, change in edits.items():
        d = out / name.replace(" ", "_").replace("=", "")
        d.mkdir(parents=True, exist_ok=True)
        for f in (sources or {}).get(name, cuda_build.CSRC).iterdir():
            if f.suffix in (".cu", ".cuh"):
                text = f.read_text()
                if f.name in change:
                    text = change[f.name](text)
                    if text == f.read_text():
                        raise RuntimeError(f"variant {name!r} changed nothing")
                (d / f.name).write_text(text)
        lib = d / f"lib{pathlib.Path(source).stem}.so"
        jobs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
             str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (lib, log)
    return built


def group_variants(source: str, const: re.Pattern, built: dict,
                   groups=GROUPS) -> dict:
    """name -> {file: transform}: as built, then one variant for each G of
    `groups` that sets every group-size constant of `source` (the pattern
    `const`, the size its third group) to G, unless `built` (the committed
    sizes by name) is that G already."""
    out = {"as built": {}}
    for g in groups:
        if set(built.values()) != {g}:
            out[f"G={g}"] = {source: lambda s, g=g: const.sub(
                lambda m: f"{m.group(1)}{g};", s)}
    return out


def build(names):
    """The curve library in each variant of `names`."""
    return build_variants(
        "curve_kernels.cu",
        {name: {} if name == "as built" else {"field_w32.cuh": VARIANTS[name]}
         for name in names}, OUT)


CURVE_SASS = r"(cadd|cmsm_row_scan)_kernelILi([12])E", "{} G{}"


def sass_report(lib, kernels=CURVE_SASS) -> list:
    """The compiled code of the packed-word kernels in one library (by
    default the curve kernels cadd and cmsm_row_scan, G1 and G2; `kernels`
    is a pattern of their mangled names and a label made from its two
    groups), from `cuobjdump -sass`: lines giving each kernel's
    instructions and the instruction mix of its out-of-line Montgomery
    product (from the CALL's target to the RET)."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    blocks, code = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            code = blocks.setdefault(head.group(1), [])
            continue
        ins = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if ins and code is not None:
            code.append((int(ins.group(1), 16), ins.group(2), ins.group(3)))
    out = []
    for name, code in blocks.items():
        kern = re.search(kernels[0], name)
        if not kern:
            continue
        line = (kernels[1].format(*kern.groups())
                + f": {len(code)} instructions")
        targets = {int(t.group(1), 16) for _, op, rest in code
                   if op.startswith("CALL")
                   and (t := re.search(r"0x([0-9a-f]+)", rest))}
        if len(targets) == 1:
            start, body = targets.pop(), []
            for at, op, _ in code:
                if at >= start:
                    body.append(op)
                    if op.startswith("RET"):
                        break
            mix = collections.Counter(body)
            imad = sum(c for op, c in mix.items() if op.startswith("IMAD"))
            line += (f"; its Montgomery product {len(body)} instructions, "
                     f"{imad} IMAD* (" + ", ".join(
                         f"{op} {c}" for op, c in mix.most_common()
                         if op.startswith(("IMAD", "IADD3"))) + ")")
        out.append(line)
    return out


def ptxas_report(log: str, pattern: str) -> list:
    """From nvcc's `-Xptxas -v` report, one line per function whose
    mangled name matches `pattern`: its stack frame and spills, and for a
    kernel its registers."""
    funcs, cur = [], None
    for line in log.splitlines():
        head = re.search(r"Function properties for (\S+)", line)
        if head:
            cur = {"name": head.group(1)}
            funcs.append(cur)
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if cur is not None and frame:
            cur["frame"] = frame.groups()
        elif cur is not None and regs:
            cur["regs"] = regs.group(1)
    out = []
    for f in funcs:
        hit = re.search(pattern, f["name"])
        if hit and "frame" in f:
            rest = f["name"][hit.end():]
            targs = rest[:rest.find("Ev")] if rest.startswith("I") else ""
            args = [a or b for a, b in re.findall(r"Li(\d+)E|(Fq2?A)",
                                                    targs)]
            line = (hit.group(0) + (f"<{','.join(args)}>" if args else "")
                    + f": {f['frame'][0]} B frame, spills "
                    f"{f['frame'][1]}/{f['frame'][2]} B")
            out.append(line + (f", {f['regs']} registers"
                               if "regs" in f else ""))
    return out


def _limbs(shape, bound_p: int, gen):
    """Random exact 16-bit limbs (25, *shape) of values < 2^(bits of
    bound_p p - 1), on the card."""
    bits = (bound_p * FQ.p).bit_length() - 1
    x = torch.randint(0, 1 << 16, (FQ.n,) + shape, generator=gen,
                      dtype=torch.int64, device="cuda")
    for i in range(FQ.n):
        x[i] &= (1 << max(0, min(16, bits - 16 * i))) - 1
    return x


def _bind(lib, library=CC.LIBRARY):
    """A built variant of `library` (a KernelLibrary), loaded."""
    handle = ctypes.CDLL(str(lib))
    for fname, argt in library.argtypes.items():
        getattr(handle, fname).argtypes = argt
        getattr(handle, fname).restype = ctypes.c_int
    return handle


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, reps: int, key: str):
    """Device time of one launch of the kernels whose name holds `key`, by
    the profiler's CUPTI records over `reps` calls (a short kernel's
    back-to-back launches by CUDA events time the host's launch rate);
    None where it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and key in e.key]
    count = sum(e.count for e in rows)
    return (sum(e.self_device_time_total for e in rows) / count / 1e3
            if count else None)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


# cdbl_n_add's path shapes: (curve name, n_dbl, lanes)
CDBL_SHAPES = (("G2", 8, 668), ("G2", 4, 1336), ("G1", 4, 4096),
               ("G1", 13, 1))


def cdbl_cases(gen):
    """(name, fn(lib) -> outputs, plain outputs) at CDBL_SHAPES: seeded
    coordinates < 4p."""
    from ..ops.curve import G1, G2
    args = (host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p), FQ.n0,
            torch.cuda.current_stream().cuda_stream)
    out = []
    for cname, n, lanes in CDBL_SHAPES:
        curve = G2 if cname == "G2" else G1
        lead = (2,) if curve.ns == 2 else ()
        pts = [_limbs(lead + (lanes,), 4, gen) for _ in range(6)]

        def call(lib, pts=pts, n=n, lanes=lanes, ns=curve.ns):
            outs = [torch.empty_like(pts[0]) for _ in range(3)]
            check(lib.gs_cdbl_n_add(FQ.n, ns, n,
                                    *(t.data_ptr() for t in pts + outs),
                                    lanes, *args), "cdbl_n_add", FQ.n)
            return outs

        def plain(pts=pts, n=n, curve=curve):
            return list(CC.cdbl_n_add_plain(tuple(pts[:3]), n,
                                            tuple(pts[3:]), curve))
        out.append((f"cdbl_n_add {cname}, n = {n}, {lanes} lanes", call,
                    plain))
    return out


# cmadd's path shapes: (curve name, lanes)
CMADD_SHAPES = (("G2", 1336), ("G1", 4096), ("G1", 1336), ("G2", 128),
                ("G2", 32), ("G1", 32), ("G2", 8))


def cmadd_cases(gen):
    """(name, fn(lib) -> outputs, plain outputs) at CMADD_SHAPES: seeded
    accumulators < 4p, affine points < 2p, a quarter of them at
    infinity."""
    from ..ops.curve import G1, G2
    args = (host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p), FQ.n0,
            torch.cuda.current_stream().cuda_stream)
    out = []
    for cname, lanes in CMADD_SHAPES:
        curve = G2 if cname == "G2" else G1
        lead = (2,) if curve.ns == 2 else ()
        acc = [_limbs(lead + (lanes,), 4, gen) for _ in range(3)]
        aff = [_limbs(lead + (lanes,), 2, gen) for _ in range(2)]
        inf = torch.rand(lanes, generator=gen, device="cuda") < 0.25

        def call(lib, acc=acc, aff=aff, inf=inf, lanes=lanes, ns=curve.ns):
            outs = [torch.empty_like(acc[0]) for _ in range(3)]
            check(lib.gs_cmadd(FQ.n, ns,
                               *(t.data_ptr() for t in acc + aff + [inf]
                                 + outs), lanes, *args), "cmadd", FQ.n)
            return outs

        def plain(acc=acc, aff=aff, inf=inf, curve=curve):
            return list(CC.cmadd_plain(tuple(acc), (*aff, inf), curve))
        out.append((f"cmadd {cname}, {lanes} lanes", call, plain))
    return out


def groups_main(against) -> int:
    """cdbl_n_add's and cmadd's group sizes (and another checkout's
    kernels) timed."""
    card = card_line()
    print(card, flush=True)
    text = (cuda_build.CSRC / "curve_kernels.cu").read_text()
    built_g = {m.group(2): int(m.group(3))
               for m in _CDBL_CONST.finditer(text)}
    print(f"as built: {built_g}", flush=True)
    edits = group_variants("curve_kernels.cu", _CDBL_CONST, built_g,
                           CURVE_GROUPS)
    sources = {}
    if against:
        edits["against"] = {}
        sources["against"] = against.resolve()
    built = build_variants("curve_kernels.cu", edits, GROUP_OUT, sources)
    for name, (lib, log) in built.items():
        for line in (sass_report(lib, CDBL_SASS)
                     + ptxas_report(log, CDBL_PTXAS)):
            print(f"[{name}] {line}", flush=True)
    libs = {name: _bind(lib) for name, (lib, _) in built.items()}
    gen = torch.Generator("cuda").manual_seed(20261018)
    order = list(libs) + ["as built"]
    for what, fn, plain in cdbl_cases(gen) + cmadd_cases(gen):
        want = fn(libs["as built"])
        exact = all(torch.equal(a, b) for a, b in zip(want, plain()))
        print(f"[plain] {what}: as built "
              f"{'equals' if exact else 'DIFFERS FROM'} the plain version",
              flush=True)
        if not exact:
            return 1
        for name in order:
            same = all(torch.equal(a, b) for a, b in zip(fn(libs[name]),
                                                         want))
            ms = _events_ms(lambda: fn(libs[name]), 20)
            print(f"[time] {what}: {name}: {ms:.4f} ms a launch, outputs "
                  f"{'equal' if same else 'DIFFERENT'}", flush=True)
            if not same:
                return 1
    print(card, flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", action="store_true",
                    help="time cdbl_n_add's and cmadd's threads a lane, "
                         "not mont's designs")
    ap.add_argument("--against", type=pathlib.Path, default=None,
                    help="with --groups: another checkout's csrc/ to time "
                         "beside these")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("curve_variants: needs a CUDA card", file=sys.stderr)
        return 2
    if opts.groups:
        return groups_main(opts.against)
    card = card_line()
    print(card, flush=True)
    built = build(list(VARIANTS))
    for name, (lib, log) in built.items():
        keep = [ln.strip() for ln in log.splitlines()
                if "stack frame" in ln or "Used" in ln]
        for line in sass_report(lib):
            print(f"[{name}] {line}", flush=True)
        print(f"[{name}] ptxas (every function): " + " | ".join(keep),
              flush=True)
    libs = {name: _bind(lib) for name, (lib, _) in built.items()}
    gen = torch.Generator("cuda").manual_seed(20261018)
    args = (host_words(FQ, FQ.p), host_words(FQ, FQ.r_mod_p), FQ.n0,
            torch.cuda.current_stream().cuda_stream)

    def cadd_case():
        m = 2_757_504
        ins = [_limbs((2, m), 4, gen).reshape(50, m) for _ in range(6)]

        def cadd(lib):
            outs = [torch.empty_like(ins[0]) for _ in range(3)]
            assert lib.gs_cadd(25, 2, *(t.data_ptr() for t in ins + outs),
                               m, *args) == 0
            return outs
        return cadd

    def scan_case():
        rows, lanes = 128, 85_504
        pts = [_limbs((2, rows, lanes), 2, gen).reshape(50, rows, lanes)
               for _ in range(2)]
        flags = torch.rand((rows, lanes), generator=gen, device="cuda") < 0.25

        def scan(lib):
            raw = [torch.empty((rows, 50, lanes), dtype=torch.int64,
                               device="cuda") for _ in range(3)]
            tot = [torch.empty((50, lanes), dtype=torch.int64,
                               device="cuda") for _ in range(3)]
            assert lib.gs_cmsm_row_scan(
                25, 2, rows,
                *(t.data_ptr() for t in pts + [flags] + raw + tot), lanes,
                *args) == 0
            return tot + raw
        return scan

    order = list(VARIANTS) + ["as built"]
    for what, case, reps in (("G2 cadd, 2,757,504 lanes", cadd_case, 5),
                             ("G2 cmsm_row_scan, 85,504 lanes x 128 rows",
                              scan_case, 3)):
        fn = case()
        want = fn(libs["as built"])
        for name in order:
            same = all(torch.equal(a, b) for a, b in zip(fn(libs[name]),
                                                         want))
            ms = _events_ms(lambda: fn(libs[name]), reps)
            print(f"[time] {what}: {name}: {ms:.3f} ms a launch, outputs "
                  f"{'equal' if same else 'DIFFERENT'}", flush=True)
            if not same:
                return 1
        del fn, want
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
