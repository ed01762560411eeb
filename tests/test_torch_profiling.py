"""The port's `profiling.trace` (groth_sahai_tpu_torch.utils.profiling): a
block of port work on the CPU leaves a TensorBoard-readable trace with its
CPU events under the log directory; asking for a card where none is
present raises. The card's case (CUDA kernel events of the ported
kernels) is checked by chip_smoke.py's `trace` path."""

import json

import pytest
import torch

from groth_sahai_tpu_torch.ops.fp import FQ
from groth_sahai_tpu_torch.utils.profiling import trace

from .test_torch_tower import one_thread  # noqa: F401


def test_trace_writes_cpu_events(tmp_path):
    a = FQ.from_ints([3, 5, 7], device="cpu")
    with trace(str(tmp_path), device="cpu") as prof:
        out = FQ.mul(a, a)
    assert FQ.to_ints(out) == [9, 25, 49]
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("ph") == "X"}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    assert not any(e.get("cat") == "kernel" for e in events)
    assert any(e.key.startswith("aten::") for e in prof.key_averages())


def test_trace_on_a_missing_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(tmp_path)):
            pass
    assert not list(tmp_path.iterdir())
