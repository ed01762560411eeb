"""Tracing: the port of ``groth_sahai_tpu/utils/profiling.py``'s `trace`.

`trace(log_dir)` records what runs inside it with `torch.profiler` (CPU
activity, and the card's kernels when `device` is a card) and, when the
block ends, writes a trace that TensorBoard's profiler plugin reads
(`torch.profiler.tensorboard_trace_handler`: `<host>_<pid>.<time>.pt.trace.json`
under `log_dir`) -- the counterpart of `jax.profiler.trace`. The JAX
module's `cost_table` and `compile_seconds` read XLA's cost analysis and
compile times, which have no counterpart here.
"""

from __future__ import annotations

from contextlib import contextmanager

from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

from ..ops.fp import resolve_device


@contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the block and write its trace under `log_dir`; yields the
    `torch.profiler.profile` (its `key_averages()` and `events()` hold the
    same records). A card as `device` with none present raises."""
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
