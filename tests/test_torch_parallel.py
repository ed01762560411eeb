"""The port's multi-device layer (groth_sahai_tpu_torch.parallel) on the CPU.

The five cases of tests/test_sharding.py, with the same seeds, on a mesh of
four CPU shards (`make_mesh(4, devices=[cpu] * 4)`, the counterpart of the
JAX package's virtual CPU mesh), each held to tests/oracle.py: the sum
(sum k_i s_i) G for an MSM, e(G1, G2)^(sum a_i b_i) for a multi-pairing.
`test_sharded_msm_g2` passes here: the JAX package's G2 sharded MSM
fails on `curve.F.n`, which its Fq2 lacks. `test_sharded_msm_large`
runs at 2^9 points a shard, not 2^14: the plain versions of the MSM
kernels on this CPU would take minutes at 2^16 points. Then `make_mesh`
without enough cards, and a two-process gloo run of both sharded
functions through the `all_gather` merge (`init_distributed` from
torchrun's environment variables). The batch verifiers over a mesh are
in test_torch_batch.py, beside its proofs.
"""

import json
import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from groth_sahai_tpu_torch.ops.curve import (G1, G2, g1_affine_from_ints,
                                             g1_affine_to_ints,
                                             g2_affine_from_ints,
                                             g2_affine_to_ints)
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.parallel.mesh import make_mesh, shard_batch
from groth_sahai_tpu_torch.parallel.multihost import (flatten_mesh,
                                                      init_distributed,
                                                      make_global_mesh)
from groth_sahai_tpu_torch.parallel.sharded import (sharded_msm,
                                                    sharded_multi_pairing)
from groth_sahai_tpu_torch.utils import hostcrypto as H
from groth_sahai_tpu_torch.utils import metrics

from . import oracle as O
from .test_torch_matrix import dev_fr as fr, o_g1, o_g2
from .test_torch_tower import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def affine_ints(curve, jac):
    to_ints = g2_affine_to_ints if curve is G2 else g1_affine_to_ints
    return to_ints(curve.to_affine(tuple(c[..., None] for c in jac)))[0]


def gt_ints(e):
    return H.f12_pow(H.pairing_gen(), e % O.R)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(4, devices=[CPU] * 4)


def test_sharded_msm(mesh):
    rng = random.Random(41)
    N = 4 * 8
    ks = [rng.randrange(1, 99) for _ in range(N)]
    ss = [rng.randrange(O.R) for _ in range(N)]
    pts = g1_affine_from_ints([o_g1(O.g1_mul(O.G1_GEN, k)) for k in ks],
                              device=CPU)
    metrics.reset()
    out = sharded_msm(mesh, G1, pts, fr(ss), window=4, lanes=4)
    want = O.g1_mul(O.G1_GEN, sum(k * s for k, s in zip(ks, ss)) % O.R)
    assert affine_ints(G1, out) == o_g1(want)
    snap = metrics.snapshot()
    assert snap["count/sharded_msm_points"] == N
    assert snap["count/collective_bytes_msm_merge"] == 4 * 3 * 25 * 8
    metrics.reset()


def test_sharded_multi_pairing(mesh):
    rng = random.Random(42)
    K = 8
    ka = [rng.randrange(1, 50) for _ in range(K)]
    kb = [rng.randrange(1, 50) for _ in range(K)]
    P = g1_affine_from_ints([o_g1(O.g1_mul(O.G1_GEN, k)) for k in ka],
                            device=CPU)
    Q = g2_affine_from_ints([o_g2(O.g2_mul(O.G2_GEN, k)) for k in kb],
                            device=CPU)
    out = sharded_multi_pairing(mesh, P, Q)
    assert FQ12.to_ints(out)[0] == gt_ints(sum(a * b for a, b in zip(ka, kb)))


def test_sharded_multi_pairing_k64(mesh):
    """K = 64 pairs: prod e(ka G1, kb G2) = e(G1, G2)^(sum ka kb)."""
    rng = random.Random(43)
    K = 64
    ka = [rng.randrange(1, 1 << 16) for _ in range(K)]
    kb = [rng.randrange(1, 1 << 16) for _ in range(K)]
    P = g1_affine_from_ints([H.g1_mul((H.C.G1_GEN_X, H.C.G1_GEN_Y), k)
                             for k in ka], device=CPU)
    Q = g2_affine_from_ints([H.g2_mul((H.C.G2_GEN_X, H.C.G2_GEN_Y), k)
                             for k in kb], device=CPU)
    out = sharded_multi_pairing(mesh, P, Q)
    assert FQ12.to_ints(out)[0] == gt_ints(sum(a * b for a, b in zip(ka, kb)))


def test_sharded_msm_g2(mesh):
    """G2 MSM through the sharded path, oracle-checked (the JAX package's
    fails here on `curve.F.n`)."""
    rng = random.Random(44)
    N = 4 * 8
    ks = [rng.randrange(1, 99) for _ in range(N)]
    ss = [rng.randrange(O.R) for _ in range(N)]
    pts = g2_affine_from_ints([o_g2(O.g2_mul(O.G2_GEN, k)) for k in ks],
                              device=CPU)
    metrics.reset()
    out = sharded_msm(mesh, G2, pts, fr(ss), window=4, lanes=4)
    want = O.g2_mul(O.G2_GEN, sum(k * s for k, s in zip(ks, ss)) % O.R)
    assert affine_ints(G2, out) == o_g2(want)
    assert metrics.snapshot()["count/collective_bytes_msm_merge"] == \
        4 * 3 * 25 * 2 * 8
    metrics.reset()


def test_sharded_msm_large(mesh):
    """2^9 points a shard (the JAX test's 2^14 cut for the plain
    versions on the CPU), window 8. Points repeat a 16-point base; the
    oracle check is one host multiplication by sum(s_i k_(i mod 16))."""
    rng = random.Random(45)
    per = 1 << 9
    N = 4 * per
    base_k = [rng.randrange(1, 1 << 30) for _ in range(16)]
    base = g1_affine_from_ints(
        [H.g1_mul((H.C.G1_GEN_X, H.C.G1_GEN_Y), k) for k in base_k],
        device=CPU)
    pts = tuple(l.repeat((1,) * (l.ndim - 1) + (N // 16,)) for l in base)
    ss = [rng.randrange(O.R) for _ in range(N)]
    out = sharded_msm(mesh, G1, pts, fr(ss), window=8)
    k_tot = sum(s * base_k[i % 16] for i, s in enumerate(ss)) % O.R
    assert affine_ints(G1, out) == H.g1_mul((H.C.G1_GEN_X, H.C.G1_GEN_Y),
                                            k_tot)


def test_mesh_needs_devices(mesh):
    """No fallback: without enough cards and no devices=, make_mesh
    raises; shards must divide the batch; a 2-D mesh is flattened first."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="make_mesh"):
        make_mesh(have + 1)
    assert mesh.shape["chips"] == 4 and mesh.size == 4
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, torch.zeros(6), 0)
    parts = shard_batch(mesh, torch.arange(8).reshape(1, 8), 1)
    assert [p.tolist() for p in parts] == [[[0, 1]], [[2, 3]], [[4, 5]],
                                           [[6, 7]]]
    grid = make_global_mesh(local_devices=[CPU] * 2)
    assert grid.shape == {"host": 1, "chip": 2}
    with pytest.raises(ValueError, match="flatten_mesh"):
        shard_batch(grid, torch.zeros(2), 0)
    assert flatten_mesh(grid).shape == {"chips": 2}
    assert init_distributed() is False


@pytest.mark.parametrize("cards,want", [(2, [1]), (4, [2, 3])])
def test_torchrun_local_rank_cards(monkeypatch, cards, want):
    """Under torchrun (LOCAL_RANK 1 of LOCAL_WORLD_SIZE 2, here with a
    stubbed card count) a rank's default devices are its own share of the
    host's cards, and init_distributed makes the first one current before
    it starts NCCL; a rank without a card of its own is refused."""
    import torch.distributed as dist
    from groth_sahai_tpu_torch.parallel import multihost
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    grid = make_global_mesh()
    assert grid.shape == {"host": 1, "chip": len(want)}
    assert list(grid.devices.reshape(-1)) == [torch.device("cuda", i)
                                              for i in want]
    seen = []
    monkeypatch.setattr(torch.cuda, "set_device", seen.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    assert multihost.init_distributed("127.0.0.1:1", 2, 1)
    (current, (backend, kw)) = seen
    assert current == torch.device("cuda", want[0]) and backend == "nccl"
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert kw["init_method"] == "tcp://127.0.0.1:1"
    assert kw["timeout"].total_seconds() == multihost.TIMEOUT_S
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(cards + 1))
    with pytest.raises(RuntimeError, match="card of its own"):
        make_global_mesh()


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------

WORKER = r"""
import json, sys
sys.modules['jax'] = None
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from groth_sahai_tpu_torch.ops.curve import (G1, g1_affine_from_ints,
                                             g1_affine_to_ints,
                                             g2_affine_from_ints)
from groth_sahai_tpu_torch.ops.fp import FR
from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.parallel.multihost import (
    flatten_mesh, init_distributed, make_global_mesh)
from groth_sahai_tpu_torch.parallel.sharded import (sharded_msm,
                                                    sharded_multi_pairing)
case = json.loads(sys.argv[1])
assert init_distributed(device="cpu")
mesh = flatten_mesh(make_global_mesh(local_devices=["cpu"] * 2))
pts = g1_affine_from_ints([tuple(p) for p in case["msm_points"]],
                          device="cpu")
s = torch.as_tensor(ints_to_limbs(case["scalars"], FR.n).astype("int64"))
msm = sharded_msm(mesh, G1, pts, s, window=4)
msm = g1_affine_to_ints(G1.to_affine(tuple(c[..., None] for c in msm)))[0]
P = g1_affine_from_ints([tuple(p) for p in case["P"]], device="cpu")
Q = g2_affine_from_ints([tuple(map(tuple, q)) for q in case["Q"]],
                        device="cpu")
gt = FQ12.to_ints(sharded_multi_pairing(mesh, P, Q))[0]
print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(),
                  "shards": mesh.shape["chips"], "msm": msm, "gt": gt}))
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def as_lists(x):
    return json.loads(json.dumps(x))


def test_two_ranks_over_gloo():
    """Two processes, RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT as
    torchrun sets them, two CPU shards each: both ranks return the
    oracle's sharded_msm (G1, 16 points) and sharded_multi_pairing (4
    pairs)."""
    rng = random.Random(46)
    g1 = (H.C.G1_GEN_X, H.C.G1_GEN_Y)
    g2 = (H.C.G2_GEN_X, H.C.G2_GEN_Y)
    ks = [rng.randrange(1, 1 << 20) for _ in range(16)]
    ss = [rng.randrange(O.R) for _ in range(16)]
    ka = [rng.randrange(1, 1 << 20) for _ in range(4)]
    kb = [rng.randrange(1, 1 << 20) for _ in range(4)]
    case = {"msm_points": [H.g1_mul(g1, k) for k in ks], "scalars": ss,
            "P": [H.g1_mul(g1, k) for k in ka],
            "Q": [H.g2_mul(g2, k) for k in kb]}
    env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, json.dumps(case)], cwd=REPO,
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    want_msm = H.g1_mul(g1, sum(k * s for k, s in zip(ks, ss)) % O.R)
    want_gt = gt_ints(sum(a * b for a, b in zip(ka, kb)))
    assert sorted(o["rank"] for o in outs) == [0, 1]
    for o in outs:
        assert (o["world"], o["shards"]) == (2, 4)
        assert o["msm"] == as_lists(want_msm)
        assert o["gt"] == as_lists(want_gt)
