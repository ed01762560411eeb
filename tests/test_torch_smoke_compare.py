"""utils/smoke_compare.py: the `[report]` lines of chip_smoke.py logs read
back shape by shape, and the medians of two trees' runs compared."""
from groth_sahai_tpu_torch.utils import smoke_compare as SC


def _log(times):
    """A chip_smoke.py log's report lines for the given device times."""
    mont, cmadd, scan = times
    return "\n".join([
        "[report] launches on gs-e2e: {\"cmadd\": 868}",
        f"[report] Fq mont_mul        lanes=  16384 device {mont:.4f} ms per "
        "launch by profiler (wrapper 0.0308 ms per call, plain 1.6884 ms), "
        "bound 0.00293 ms by bytes",
        f"[report] G2 cmadd           lanes=   1336 device {cmadd:.4f} ms per "
        "launch by profiler (wrapper 0.1817 ms per call, plain 14.1717 ms), "
        "bound 0.00221 ms by operations",
        f"[report] G2 cmsm_row_scan   lanes=  85504 rows=128 device {scan:.4f}"
        " ms per launch by cuda events (wrapper 49.8486 ms per call, plain "
        "13120.5752 ms), bound 23.39125 ms by operations",
    ])


def test_report_times_reads_each_shape():
    got = SC.report_times(_log((0.0063, 0.0217, 49.81)))
    assert got == {
        ("Fq", "mont_mul", 16384, None): (0.0063, "profiler", 0.0308),
        ("G2", "cmadd", 1336, None): (0.0217, "profiler", 0.1817),
        ("G2", "cmsm_row_scan", 85504, "128"): (49.81, "cuda events",
                                                49.8486)}


def test_compare_medians_and_verdicts():
    parent = [SC.report_times(_log(t)) for t in
              ((0.0063, 0.2800, 49.80), (0.0064, 0.2790, 60.00),
               (0.0063, 0.2810, 49.90))]
    change = [SC.report_times(_log(t)) for t in
              ((0.0063, 0.0217, 49.85), (0.0063, 0.0218, 49.87))]
    rows = {r[0][1]: r for r in SC.compare(parent, change, 0.05)}
    assert rows["mont_mul"][1:3] == (0.0063, 0.0063)
    assert rows["mont_mul"][-1] == "held"
    assert rows["cmadd"][1] == 0.2800
    assert abs(rows["cmadd"][3] - 0.02175 / 0.28) < 1e-12
    assert rows["cmadd"][-1] == "moved"
    assert rows["cmsm_row_scan"][-1] == "undecided"     # a parent run 20 % off
    only_change = SC.compare([{}], change, 0.05)
    assert {r[-1] for r in only_change} == {"new"}


def test_compare_shapes_timed_two_ways():
    """Profiler and event times differ by the host's issue time: compared
    only among the profiler's runs, or else by the wrapper's times."""
    key = ("G1", "cadd", 81940, None)
    parent = [{key: (0.112, "profiler", 0.28)}, {key: (0.112, "profiler",
                                                       0.15)}]
    both = [{key: (0.113, "profiler", 0.18)}, {key: (0.24, "cuda events",
                                                    0.18)}]
    row = SC.compare(parent, both, 0.05)[0]
    assert row[1:3] == (0.112, 0.113) and row[-1] == "held (profiler runs)"
    events = [{key: (0.19, "cuda events", 0.178)},
              {key: (0.25, "cuda events", 0.177)}]
    row = SC.compare(parent, events, 0.05)[0]
    assert abs(row[1] - 0.215) < 1e-12 and abs(row[2] - 0.1775) < 1e-12
    assert row[-1] == "undecided (wrapper times)"   # the parent's spread
