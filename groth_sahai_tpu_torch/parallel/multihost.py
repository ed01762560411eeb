"""Multi-process execution: torch.distributed init + ("host", "chip") mesh.

The port of ``groth_sahai_tpu/parallel/multihost.py``. Every process calls
`init_distributed` (the store's address, world size and rank from the
arguments or from torch's standard environment, as `torchrun` sets it),
then `make_global_mesh` lays the ranks' devices out as a ("host", "chip")
mesh: row r is rank r's devices. Under torchrun's one process a card,
LOCAL_RANK / LOCAL_WORLD_SIZE split a host's cards between its ranks, so
the ranks' devices are disjoint. Every rank passes the whole input to the
sharded functions of :mod:`.sharded` and computes the shards of its own
row; the partials merge by `torch.distributed.all_gather`, so every rank
gets the same value.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from ..ops.fp import resolve_device
from .mesh import Mesh

# A collective that waits longer than this fails instead of hanging.
TIMEOUT_S = 300


def _local_cards() -> list:
    """This process's cards: all it sees, or, when LOCAL_WORLD_SIZE /
    LOCAL_RANK are set (torchrun), local rank l's contiguous share of
    them: card l alone under one process a card."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not count:
        raise RuntimeError("no CUDA device is available; pass "
                           "local_devices= (make_global_mesh) or "
                           "device='cpu' (init_distributed)")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    per = count // local_world
    if not per or not 0 <= local_rank < local_world:
        raise RuntimeError(f"local rank {local_rank} of {local_world} on "
                           f"{count} CUDA device(s): a rank needs a card "
                           f"of its own")
    return [torch.device("cuda", local_rank * per + i) for i in range(per)]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> bool:
    """Start the process group (NCCL for a card, gloo on the CPU).

    The address ("host:port" or a URL such as "tcp://127.0.0.1:29500")
    defaults to MASTER_ADDR:MASTER_PORT, the world size to WORLD_SIZE, the
    rank to RANK. Returns False, and starts nothing, in a single process:
    no address, or a world of one taken from the environment. A world of
    one with an address given here is started (one rank through the
    collectives). Returns True when a group is up. For NCCL the current
    card becomes `device`'s index, or else this process's first card
    (LOCAL_RANK's under torchrun).
    """
    import torch.distributed as dist
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR") and \
            os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", "0"))
    if not addr or (world <= 1 and coordinator_address is None):
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None
                              else _local_cards()[0])
    dist.init_process_group(
        backend, init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def make_global_mesh(axes=("host", "chip"), local_devices=None) -> Mesh:
    """Every rank's devices as a ("host", "chip") mesh: row r holds rank
    r's `local_devices` (default: this process's cards, LOCAL_RANK's
    share under torchrun; every rank must have as many). Without a
    process group: one row. With one axis name, the rows are flattened
    into it."""
    import torch.distributed as dist
    if local_devices is None:
        local_devices = _local_cards()
    local = [torch.device(d) for d in local_devices]
    world = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    grid = [local] * world
    ranks = np.repeat(np.arange(world)[:, None], len(local), axis=1)
    if len(axes) == 1:
        return flatten_mesh(Mesh(grid, ("host", "chip"), ranks), axes[0])
    return Mesh(grid, tuple(axes), ranks)


def flatten_mesh(mesh: Mesh, name: str = "chips") -> Mesh:
    """Collapse a multi-axis mesh to one axis (for the sharded functions:
    the point / pair / equation axis shards over every entry)."""
    return Mesh(mesh.devices.reshape(-1), (name,),
                None if mesh.ranks is None else mesh.ranks.reshape(-1))
