"""The port's field core (groth_sahai_tpu_torch.ops.fp / cuda_fp) against
the JAX package, limb for limb.

Inputs are made with numpy from a seed and passed to both packages as
numpy arrays. Tolerance: exact equality of every limb (both packages keep
the same redundant forms, so no normalization is needed before comparing).
On the CPU the port's kernel wrappers run their plain PyTorch versions;
the kernels themselves are held against those on the card (`gpu` tests
here and `chip_smoke.py`).
"""

import os
import subprocess
import sys
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from groth_sahai_tpu.ops import bls12_381 as JC
from groth_sahai_tpu.ops import pallas_fp
from groth_sahai_tpu.ops.fp import FQ as JFQ, FR as JFR, PrimeField as JPrimeField
from groth_sahai_tpu.ops.tower import FQ12 as JFQ12

from groth_sahai_tpu_torch.ops import bls12_381 as C
from groth_sahai_tpu_torch.ops import cuda_fp
from groth_sahai_tpu_torch.ops.fp import FQ, FR, PrimeField
from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
from groth_sahai_tpu_torch.ops.tower import FQ12
from groth_sahai_tpu_torch.utils.convert import (affine_from_numpy,
                                                 limbs_from_numpy, to_numpy)

REPO = pathlib.Path(__file__).resolve().parent.parent

# 61-bit Mersenne prime with 5 limbs: the JAX package's Pallas kernels run in
# interpret mode on this field (tests/test_pallas_fp.py); full width is too
# slow to interpret on XLA:CPU.
TOY_P = (1 << 61) - 1
J_TOY = JPrimeField(TOY_P, 5, "Toy61")
TOY = PrimeField(TOY_P, 5, "Toy61")

FIELDS = [(FQ, JFQ), (FR, JFR)]
FIELD_IDS = ["Fq", "Fr"]


def rand_vals(rng, count, bound):
    """`count` ints uniform below `bound` (numpy seeded), as Python ints."""
    nwords = bound.bit_length() // 32 + 2
    words = rng.integers(0, 1 << 32, size=(count, nwords), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]
    return [v % bound for v in vals]


def limbs(vals, n):
    return ints_to_limbs(vals, n)          # numpy uint32[n, len]


def mul_inputs(field, seed, lanes=6):
    """a, b with value(a)*value(b) <= 2^16 p^2, edge lanes first."""
    p = field.p
    rng = np.random.default_rng(seed)
    edge_a = [0, 1, p - 1, 2 * p - 1, p << 8, p << 16, (p << 16) - 1]
    edge_b = [p - 1, 1, p - 1, 2 * p - 1, p << 8, p, p]
    a = edge_a + rand_vals(rng, lanes, p << 8)
    b = edge_b + rand_vals(rng, lanes, p << 8)
    assert all(x * y <= (p * p) << 16 for x, y in zip(a, b))
    return limbs(a, field.n), limbs(b, field.n)


def wide_input(field, seed, lanes=6):
    """t < p R (2n+1 limbs), edge lanes first."""
    p, R = field.p, field.R_int
    rng = np.random.default_rng(seed)
    t = [p * R - 1, 0, 1, p, (p * p) << 16] + rand_vals(rng, lanes, p * R)
    return limbs(t, 2 * field.n + 1)


def port(x):
    return limbs_from_numpy(x, device="cpu")


def same(port_out, jax_out):
    np.testing.assert_array_equal(to_numpy(port_out), np.asarray(jax_out))


# ------------------------------------------------ the four kernels' functions

@pytest.mark.parametrize("fields", FIELDS, ids=FIELD_IDS)
def test_plain_kernels_match_jax_field(fields):
    """mont_mul / mul_wide / redc plain versions == JAX FQ/FR (non-Pallas)."""
    F, JF = fields
    a, b = mul_inputs(F, 1)
    t = wide_input(F, 2)
    same(cuda_fp.mul_wide(F, port(a), port(b)),
         jax.jit(JF.mul_wide)(jnp.asarray(a), jnp.asarray(b)))
    same(cuda_fp.redc(F, port(t)), jax.jit(JF.redc)(jnp.asarray(t)))
    want = jax.jit(JF.mul)(jnp.asarray(a), jnp.asarray(b))
    same(cuda_fp.mont_mul(F, port(a), port(b)), want)
    same(F.mul(port(a), port(b)), want)


def test_plain_kernels_match_jax_field_on_wide_batches():
    """From cuda_fp.SHIFT_ADD_LANES lanes on, the plain versions form their
    product columns by shifted row sums: the same limbs as the JAX FQ."""
    a, b = mul_inputs(FQ, 9, lanes=cuda_fp.SHIFT_ADD_LANES + 40)
    t = wide_input(FQ, 10, lanes=cuda_fp.SHIFT_ADD_LANES + 40)
    same(cuda_fp.mul_wide(FQ, port(a), port(b)),
         jax.jit(JFQ.mul_wide)(jnp.asarray(a), jnp.asarray(b)))
    same(cuda_fp.redc(FQ, port(t)), jax.jit(JFQ.redc)(jnp.asarray(t)))
    same(cuda_fp.mont_mul(FQ, port(a), port(b)),
         jax.jit(JFQ.mul)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("fields", FIELDS, ids=FIELD_IDS)
def test_pow_const_and_inv_match_jax_field(fields):
    F, JF = fields
    rng = np.random.default_rng(3)
    a = limbs([0, 1, F.p - 1, 2 * F.p - 1] + rand_vals(rng, 3, 2 * F.p), F.n)
    same(F.inv(port(a)), jax.jit(JF.inv)(jnp.asarray(a)))
    for e in (1, 0x10001):
        same(cuda_fp.pow_const(F, port(a), e),
             jax.jit(lambda x, e=e: JF.pow_const(x, e))(jnp.asarray(a)))
    same(F.pow_const(port(a), 0), JF.pow_const(jnp.asarray(a), 0))


# the port's field ops against the JAX package's, at Fq width
_OPS = {
    "add": (lambda F, a, b: F.add(a, b), 2),
    "sub": (lambda F, a, b: F.sub(a, b, k=4), 2),
    "neg": (lambda F, a, b: F.neg(b, k=4), 2),
    "double": (lambda F, a, b: F.double(a), 2),
    "mul_small": (lambda F, a, b: F.mul_small(a, 37), 2),
    "fold": (lambda F, a, b: F.fold(a), 2),
    "normalize": (lambda F, a, b: F.normalize(a, k=4), 2),
    "is_zero": (lambda F, a, b: F.is_zero(F.sub(a, a, k=4), k=8), 2),
    "eq": (lambda F, a, b: F.eq(a, b, k=4), 2),
    "sqr": (lambda F, a, b: F.sqr(a), 2),
    "to_mont": (lambda F, a, b: F.to_mont(a), 2),
    "from_mont": (lambda F, a, b: F.from_mont(a), 2),
    "select": (lambda F, a, b: F.select(F.is_zero(a, k=4), a, b), 2),
}


@pytest.mark.parametrize("name", sorted(_OPS))
def test_field_op_matches_jax(name):
    fn, _ = _OPS[name]
    p = C.P
    rng = np.random.default_rng(4)
    va = [0, p, 2 * p, 4 * p - 1] + rand_vals(rng, 4, 4 * p)
    vb = [0, p - 1, 3 * p, 1] + rand_vals(rng, 4, 4 * p)
    a, b = limbs(va, FQ.n), limbs(vb, FQ.n)
    got = fn(FQ, port(a), port(b))
    want = jax.jit(lambda x, y: fn(JFQ, x, y))(jnp.asarray(a), jnp.asarray(b))
    same(got, want)


def test_wide_ops_match_jax():
    p = C.P
    rng = np.random.default_rng(5)
    nw = 2 * FQ.n + 1
    a = limbs(rand_vals(rng, 6, (p * p) << 12), nw)
    b = limbs(rand_vals(rng, 6, (p * p) << 12), nw)
    same(FQ.add_wide(port(a), port(b)),
         jax.jit(JFQ.add_wide)(jnp.asarray(a), jnp.asarray(b)))
    same(FQ.double_wide(port(a)), jax.jit(JFQ.double_wide)(jnp.asarray(a)))
    same(FQ.sub_wide(port(a), port(b), k2=1 << 12),
         jax.jit(lambda x, y: JFQ.sub_wide(x, y, k2=1 << 12))(
             jnp.asarray(a), jnp.asarray(b)))


def test_from_ints_to_ints_match_jax():
    rng = np.random.default_rng(6)
    vals = rand_vals(rng, 5, C.P)
    t = FQ.from_ints(vals, device="cpu")
    np.testing.assert_array_equal(to_numpy(t), np.asarray(JFQ.from_ints(vals)))
    assert FQ.to_ints(t) == vals
    rvals = rand_vals(rng, 5, C.R)
    assert FR.to_ints(FR.from_ints(rvals, device="cpu")) == rvals


# -------------------------------------------- against the Pallas kernels (TOY)

def test_plain_versions_match_pallas_interpret_toy():
    """The port's plain versions == pallas_fp kernels in interpret mode."""
    rng = np.random.default_rng(7)
    p = TOY_P
    a = limbs([0, 1, p - 1, p << 8] + rand_vals(rng, 4, p << 8), 5)
    b = limbs([p - 1, 1, p - 1, p << 8] + rand_vals(rng, 4, p << 8), 5)
    t = limbs([p * TOY.R_int - 1, 0] + rand_vals(rng, 6, p * TOY.R_int), 11)
    ja, jb, jt = jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)
    same(cuda_fp.mul_wide(TOY, port(a), port(b)),
         pallas_fp.mul_wide(J_TOY, ja, jb, interpret=True))
    same(cuda_fp.redc(TOY, port(t)), pallas_fp.redc(J_TOY, jt, interpret=True))
    same(cuda_fp.mont_mul(TOY, port(a), port(b)),
         pallas_fp.mont_mul(J_TOY, ja, jb, interpret=True))
    same(cuda_fp.pow_const(TOY, port(a), p - 2),
         pallas_fp.pow_const(J_TOY, ja, p - 2, interpret=True))


# ------------------------------------------------------ contract and imports

def test_port_constants_equal_jax():
    for name in ("P", "R", "X", "B_G1", "B_G2", "G1_GEN_X", "G1_GEN_Y",
                 "G2_GEN_X", "G2_GEN_Y", "FROB_FQ6_C1", "FROB_FQ6_C2",
                 "FROB_FQ12_C1", "FINAL_EXP_HARD"):
        assert getattr(C, name) == getattr(JC, name), name
    for F, JF in FIELDS:
        assert (F.n, F.n0, F.r_mod_p, F.r2_mod_p) == (JF.n, JF.n0, JF.r_mod_p,
                                                     JF.r2_mod_p)
        np.testing.assert_array_equal(F.p_limbs, JF.p_limbs)
    for power in (1, 2):
        same(FQ12._frob_consts(power, torch.device("cpu")),
             JFQ12._frob_consts(power))


def test_convert_round_trip():
    rng = np.random.default_rng(8)
    x = limbs(rand_vals(rng, 3, C.P), FQ.n)
    y = limbs(rand_vals(rng, 3, C.P), FQ.n)
    inf = np.array([False, True, False])
    px, py, pinf = affine_from_numpy((x, y, inf), device="cpu")
    assert px.dtype == torch.int64 and pinf.dtype == torch.bool
    np.testing.assert_array_equal(to_numpy(px), x)
    np.testing.assert_array_equal(to_numpy(py), y)
    np.testing.assert_array_equal(to_numpy(pinf), inf)
    with pytest.raises(ValueError):
        limbs_from_numpy(np.array([1 << 16], dtype=np.uint32), device="cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import groth_sahai_tpu_torch\n"
        "import groth_sahai_tpu_torch.ops.pairing, groth_sahai_tpu_torch.ops.curve\n"
        "import groth_sahai_tpu_torch.models.kernels\n"
        "import groth_sahai_tpu_torch.utils.convert, groth_sahai_tpu_torch.utils.hostcrypto\n"
        "import groth_sahai_tpu_torch.ops.proj, groth_sahai_tpu_torch.ops.cuda_curve\n"
        "import groth_sahai_tpu_torch.models.prover, groth_sahai_tpu_torch.models.verifier\n"
        "import groth_sahai_tpu_torch.models.crs, groth_sahai_tpu_torch.utils.rng\n"
        "import groth_sahai_tpu_torch.ops.msm, groth_sahai_tpu_torch.models.commit_group\n"
        "import groth_sahai_tpu_torch.utils.curve_variants\n"
        "import groth_sahai_tpu_torch.models.batch, groth_sahai_tpu_torch.utils.metrics\n"
        "import groth_sahai_tpu_torch.utils.serde, groth_sahai_tpu_torch.utils.native\n"
        "import groth_sahai_tpu_torch.ops.msm_chunked\n"
        "import groth_sahai_tpu_torch.models.matrix, groth_sahai_tpu_torch.utils.profiling\n"
        "import groth_sahai_tpu_torch.parallel.mesh, groth_sahai_tpu_torch.parallel.sharded\n"
        "import groth_sahai_tpu_torch.parallel.multihost\n"
        "import chip_smoke\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and (\n"
        "       m == 'groth_sahai_tpu' or m.startswith('groth_sahai_tpu.')\n"
        "       or m == 'jax' or m.startswith('jax.'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_default_device_is_the_card():
    """Constructors default to CUDA; without a card they raise (no CPU)."""
    if torch.cuda.is_available():
        assert FQ.zeros((2,)).device.type == "cuda"
        assert FQ.from_ints([1, 2]).device.type == "cuda"
        return
    for make in (lambda: FQ.zeros((2,)), lambda: FQ.one((2,)),
                 lambda: FQ.from_ints([1, 2]), lambda: FQ12.one((1,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_cuda_wrapper_refuses_mixed_devices():
    """A wrapper never falls back: a non-CPU input goes to the kernel path,
    which checks the device and raises for anything but CUDA."""
    a = torch.zeros((FQ.n, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        cuda_fp.mont_mul(FQ, a, a)


# --------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("fields", FIELDS, ids=FIELD_IDS)
def test_kernels_match_plain_on_card(fields):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    F, _ = fields
    a, b = (x.cuda() for x in map(port, mul_inputs(F, 9, lanes=500)))
    t = port(wide_input(F, 10, lanes=500)).cuda()
    for kern, args in ((cuda_fp.mont_mul, (a, b)), (cuda_fp.mul_wide, (a, b)),
                       (cuda_fp.redc, (t,)), (cuda_fp.pow_const, (a, F.p - 2))):
        before = kern.launches
        got = kern(F, *args)
        want = cuda_fp.PLAIN[kern](F, *args)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert torch.equal(got, want), kern.__name__
