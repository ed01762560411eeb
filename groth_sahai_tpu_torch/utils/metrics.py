"""Lightweight host-side counters and timers (observability).

The port's copy of ``groth_sahai_tpu/utils/metrics.py``, verbatim (pure
Python): the batch verifier counts its equations here, the chunked MSM its
points, chunks and resumed partials.

The reference has none (SURVEY.md section 5: criterion is its only
measurement surface). Here: a process-global registry of counters
(points, pairings, collective bytes) plus wall-clock spans, emitted as one
JSON-able dict. The sharded kernels record their collective traffic so a
run can report bytes-over-ICI next to points/s.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager

_counters = defaultdict(float)
_spans = defaultdict(float)


def count(name: str, value: float = 1.0) -> None:
    _counters[name] += value


@contextmanager
def span(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _spans[name] += time.perf_counter() - t0


def collective_bytes(n_devices: int, payload_bytes: int, kind: str) -> None:
    """Record an O(D) merge collective (all-gather of per-device partials)."""
    count(f"collective_bytes_{kind}", n_devices * payload_bytes)


def rate(name_count: str, name_span: str):
    c, s = _counters.get(name_count, 0.0), _spans.get(name_span, 0.0)
    return (c / s) if s else None


def snapshot() -> dict:
    out = {f"count/{k}": v for k, v in _counters.items()}
    out.update({f"seconds/{k}": round(v, 6) for k, v in _spans.items()})
    return out


def reset() -> None:
    _counters.clear()
    _spans.clear()


def emit(extra: dict = None) -> str:
    d = snapshot()
    if extra:
        d.update(extra)
    return json.dumps(d, sort_keys=True)
