"""Compare the kernel times of chip_smoke.py runs of two trees.

Reads the `[report]` lines (device ms per launch of each kernel at each of
its report shapes) of the logs of some runs of the parent and some of the
change, made in one call to the card, and prints for each shape the median
of each side, their ratio (change / parent) and each side's spread (its
largest time over its smallest). chip_smoke.py times a launch by the
profiler, or by CUDA events around the call where the profiler recorded
none; the two differ by the host's issue time, so where a shape's runs
were timed both ways only those by the profiler are compared ("profiler
runs"), if each side has one, and else the wrapper's times per call (CUDA
events around each call in every run: "wrapper times"). A shape whose
spread on either side is wider than the limit (5 % by default) is named
undecided: its runs differ by more than the change is held to.

    python3 -m groth_sahai_tpu_torch.utils.smoke_compare \
        --parent p1.log p2.log --change c1.log c2.log [--limit 0.05]
"""
import argparse
import re
import statistics

_LINE = re.compile(r"^\[report\] (\S+) (\w+) +lanes= *(\d+)(?: (?:n|rows)=(\d+))?"
                   r" device ([\d.]+) ms per launch by (profiler|cuda events)"
                   r" \(wrapper ([\d.]+) ms per call", re.M)


def report_times(text: str) -> dict:
    """{(field, kernel, lanes, n or rows): (device ms, "profiler" or "cuda
    events", wrapper ms per call)} of one log."""
    return {(m[1], m[2], int(m[3]), m[4]): (float(m[5]), m[6], float(m[7]))
            for m in _LINE.finditer(text)}


def compare(parent: list, change: list, limit: float) -> list:
    """[(shape, parent median, change median, ratio, parent spread, change
    spread, verdict)] over the shapes of the change's logs; verdict is
    "moved", "held" or "undecided" (a spread wider than the limit), with
    " (profiler runs)" or " (wrapper times)" where a shape was timed two
    ways, or "new" for a shape the parent's logs do not time."""
    rows = []
    for key in change[0]:
        c = [run[key] for run in change if key in run]
        p = [run[key] for run in parent if key in run]
        note = ""
        if len({t[1] for t in c + p}) > 1:
            cp = [t for t in c if t[1] == "profiler"]
            pp = [t for t in p if t[1] == "profiler"]
            if cp and pp:
                c, p, note = cp, pp, " (profiler runs)"
            else:
                c = [(t[2],) + t[1:] for t in c]
                p = [(t[2],) + t[1:] for t in p]
                note = " (wrapper times)"
        c, p = [t[0] for t in c], [t[0] for t in p]
        cm = statistics.median(c)
        if not p:
            rows.append((key, None, cm, None, None, max(c) / min(c), "new"))
            continue
        pm = statistics.median(p)
        ps, cs = max(p) / min(p), max(c) / min(c)
        ratio = cm / pm
        verdict = ("undecided" if max(ps, cs) - 1 > limit
                   else "moved" if abs(ratio - 1) > limit else "held")
        rows.append((key, pm, cm, ratio, ps, cs, verdict + note))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", nargs="+", required=True)
    ap.add_argument("--change", nargs="+", required=True)
    ap.add_argument("--limit", type=float, default=0.05)
    a = ap.parse_args()
    read = lambda paths: [report_times(open(p, errors="replace").read())
                          for p in paths]
    for (field, name, lanes, e), pm, cm, ratio, ps, cs, verdict in compare(
            read(a.parent), read(a.change), a.limit):
        shape = f"{field} {name} lanes={lanes}" + (f" {e}" if e else "")
        if pm is None:
            print(f"{shape}: change {cm:.4f} ms (spread {cs:.3f}), {verdict}")
        else:
            print(f"{shape}: parent {pm:.4f} ms (spread {ps:.3f}), change "
                  f"{cm:.4f} ms (spread {cs:.3f}), ratio {ratio:.3f}, "
                  f"{verdict}")


if __name__ == "__main__":
    main()
