"""Device mesh helpers: the port of ``groth_sahai_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a `jax.sharding.Mesh` and lets
XLA place the shards. Here a `Mesh` is a plain 1-D or 2-D grid of
`torch.device`s with axis names (`mesh.shape[axis]` as in JAX); the
sharded functions of :mod:`.sharded` cut their batch axis into one
contiguous shard per entry, run each entry's shards on its device and
merge the partials. A device may appear more than once: `[cuda:0] * 4`
is four shards on one card, the counterpart of the JAX package's
virtual CPU mesh. A mesh made by `multihost.make_global_mesh` spans
processes: each entry carries the rank of the process that computes it.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A 1-D or 2-D grid of devices with axis names.

    `ranks` is None for a mesh of this process alone; otherwise an int
    array of the grid's shape holding the torch.distributed rank that
    owns each entry.
    """

    def __init__(self, devices, axis_names, ranks=None):
        grid = np.array(devices, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(grid[idx])
        names = tuple(axis_names)
        if grid.ndim not in (1, 2) or len(names) != grid.ndim or \
                len(set(names)) != len(names) or not grid.size:
            raise ValueError(f"a mesh is a 1-D or 2-D grid of devices with "
                             f"one distinct name an axis: shape "
                             f"{grid.shape}, axes {names}")
        if ranks is not None:
            ranks = np.asarray(ranks, dtype=np.int64)
            if ranks.shape != grid.shape:
                raise ValueError(f"ranks {ranks.shape} for a mesh of shape "
                                 f"{grid.shape}")
        self.devices = grid
        self.axis_names = names
        self.ranks = ranks
        self.shape = dict(zip(names, grid.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def local_shards(mesh: Mesh, axis: str = "chips"):
    """(D, [(shard index, device)] this process computes) for the shards of
    a 1-D mesh over `axis` (a 2-D mesh: `multihost.flatten_mesh` first)."""
    if mesh.axis_names != (axis,):
        raise ValueError(f"shards go over a 1-D mesh with axis {axis!r}; "
                         f"this mesh has axes {mesh.axis_names} "
                         f"(flatten_mesh a 2-D mesh first)")
    devs = mesh.devices
    if mesh.ranks is None:
        return devs.size, list(enumerate(devs))
    me = _rank()
    return devs.size, [(i, d) for i, d in enumerate(devs)
                       if mesh.ranks[i] == me]


def make_mesh(n_devices: int | None = None, axis: str = "chips",
              devices=None) -> Mesh:
    """A 1-D mesh over the first n_devices (default: all) of `devices`, or
    of this process's cards when `devices` is None.

    Unlike the JAX package's, it never falls back to other devices: with
    too few cards and no `devices`, it raises. Pass the devices, repeats
    allowed, for a mesh of several shards a device (`[torch.device("cpu")]
    * 4`, `[torch.device("cuda", 0)] * 4`).
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(count)]
        where = f"{count} CUDA device(s)"
        if not devs:
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices= "
                "(e.g. [torch.device('cpu')] * n) for a mesh on the CPU")
    else:
        devs = [torch.device(d) for d in devices]
        where = f"{len(devs)} device(s) given"
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(f"make_mesh: need {n_devices} devices, have "
                               f"{where}; pass devices= to put several "
                               f"shards on one device")
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def shard_batch(mesh: Mesh, arr, batch_axis_in_array: int,
                axis: str = "chips"):
    """The D contiguous shards of `arr` along `batch_axis_in_array`, shard
    i on the mesh's device i; None for a shard another process computes.
    The axis must divide by D."""
    D, mine = local_shards(mesh, axis)
    n = arr.shape[batch_axis_in_array]
    if n % D:
        raise ValueError(f"batch axis of {n} not divisible by {D} shards")
    parts = arr.split(n // D, batch_axis_in_array)
    out = [None] * D
    for i, dev in mine:
        out[i] = parts[i].to(dev)
    return out
