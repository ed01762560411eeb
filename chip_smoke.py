#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. build   -- nvcc builds the kernel libraries from groth_sahai_tpu_torch/csrc
                for sm_90a, one process per source, all at once; prints the
                build time, the compiler's resource report, the card's
                name and power limit, and from cuobjdump the instructions of
                the packed-word kernels (cadd, cmsm_row_scan, cdbl_n_add,
                cmadd, fq12_mul, cyc_pow, cyc_sqr, f12_pow_dyn,
                miller_iter_dbl, miller_iter_add, miller_dbl_step,
                miller_add_step, pow_const, mont_mul over Fq and Fr) and
                of their Montgomery product, with the grouped kernels'
                frames, spills and registers;
  2. kernels -- each of the sixteen kernels against its plain PyTorch version on
                the card, bit-exact, at the paths' main shapes: the field
                kernels at Fq width over the pairing's stacks (16384,
                442368, 98304 and 8192 lanes) and at Fr width over 8192
                lanes, pow_const also at Fq width over 4 and 21 lanes
                (verify's inverses) and the ragged 1, 3 and 1001;
                fq12_mul over 4096, 2048 and 4 lanes and the ragged 1, 3
                and 1000, cyc_pow over 4096 and 4 for the final
                exponentiation's three exponents and over the ragged 1, 3
                and 1000 lanes; the Miller iterations and cyc_sqr over
                4096, the Miller iterations also over 1, 3, 1000 and 4099
                lanes and miller_iter_add over 128 (gs-e2e's), f12_pow_dyn
                over 4096 and 1024 and the ragged 3; cmadd and
                cdbl_n_add (n = 4) on G1 over 4096, 1336 and 4 lanes and on
                G2 over 1336 and 4, cmadd on G1 and G2 also over the ragged
                1 and 1001, cdbl_n_add on G2 with n = 8 over 668
                (verify-ppe-334's window combination), on G1 with n = 13
                over 1 lane (msm-g1-65536's) and on G1 and G2 with n = 8
                over 1000 lanes and n = 13 over 3; cadd
                and cmsm_row_scan at the MSM paths' widest calls (G2 at
                verify-ppe-334's 668 MSMs, G1 at msm-g1-65536's, G2 at
                prove-ppe-334's) and at ragged widths of 1000 and 4 lanes;
                miller_dbl_step and miller_add_step over 4096 lanes, and
                their R against the Miller iterations' on the same inputs;
                cyc_sqr and the two steps also over the ragged 1, 3, 1000
                and 4099 lanes.
                Seeded random inputs plus edge lanes at the
                top of each kernel's input bound (0, 1, p-1, 2p-1,
                value(a)*value(b) = 2^16 p^2, wide t = p R - 1; Fq12
                coefficients 32p - 1 or 2p - 1; Miller R with Y = 10p - 1,
                P and Q at p - 1 and at the padding point (0, 0); scalars 0,
                r - 1, 2^272 - 1; curve points with the accumulator at
                infinity, the affine point at infinity, P + P, P + (-P),
                coordinates at 4p - 1 and 2p - 1; a scan column that is all
                infinity);
  3. paths   -- twenty-four runs through the port's entry points, each against
                the host oracle:
                pairing-8192: `pairing(P, Q)` over 8192 pairs (P_i = a_i G1,
                  Q_i = b_i G2, a few infinity lanes); sampled lanes and the
                  GT product of all lanes against e(G1, G2)^(sum a_i b_i);
                signed-2048: the verifier's signed Miller product at
                  Kp = 2048 with a mixed conjugation mask, then `final_exp`;
                  each (i, j) entry against e(G1, G2)^(sum_k +-a_ik b_jk);
                pairing-4096: as pairing-8192 over 4096 pairs, the largest
                  batch the fused Miller iterations take; then
                  `FQ12.cyclotomic_sqr` of the outputs against `FQ12.sqr`;
                signed-1024: the PPE of the reference's verify_ppe_334
                  (K = 1006 pairs padded to Kp = 1024, 1002 lhs then 4 rhs
                  terms), each entry against the host and the whole (2, 2)
                  result through `comt_eq`;
                gt-exp-4096: the rho-weighting of the reference's
                  batch_verify_randomized_1024: `gt_exp` on (1024, 2, 2)
                  with one 255-bit rho per equation (the GT outputs of
                  pairing-4096; the product of all lanes against
                  e(G1, G2)^(sum a_i b_i rho_i)), then on (1024) lanes with
                  raw Miller outputs (not in GT) among them;
                commit-g1-334, commit-g2-334, commit-scalar-b1-334,
                  commit-scalar-b2-334: `batch_commit_*` of 334 variables
                  (the reference's commit_*_334 rows), every commitment
                  against its discrete log on the host;
                scalar-mul-g1-4096: `G1.scalar_mul` of 4096 points, 517
                  lanes (edge scalars 0, 1, r - 1, 2^254 - 1, a point at
                  infinity) and the sum of all lanes against the host;
                gs-e2e: generate_crs, then commit_and_prove and verify of
                  the four equations of tests/test_gs_e2e.py, each verifying
                  and failing with a wrong target;
                prove-verify-ppe-8x8: a PPE with m = n = 8 (K = 28 Miller
                  pairs), verifying and failing with one element of pi
                  replaced;
                msm-g1-65536: the Pippenger `msm` over 65536 G1 points
                  (window 13: one cmsm_row_scan over 4096 lanes x 320 rows)
                  against (sum s_i a_i) G1 on the host;
                prove-ppe-334: `commit_and_prove` of the reference's
                  make_ppe(334, 334); pi, theta and sampled commitments
                  against their discrete logs (four Com products take a
                  batched msm of 4 MSMs of 512 points);
                verify-ppe-334: `verify` of that proof (True), with pi
                  changed and with a wrong target (False); Gamma d (668 G2
                  MSMs of 512 points) entry by entry against the host;
                miller-steps-4096: the Miller loop's point schedule through
                  the step entry points miller_dbl_step and
                  miller_add_step, against the host's twin;
                batch-verify-ppe-1024: the reference's
                  batch_verify_randomized_1024 row: 1024 slots of one
                  make_ppe(2, 1) statement over distinct proofs from
                  commit_and_prove; verify_ppe_batch_randomized True, False
                  with slot 517's pi changed, verify_ppe_batch false only
                  at 517; sampled slots against verify alone, sampled ratios
                  limb for limb against miller_product_signed, every tower
                  launch at most 4096 lanes (16 tiles of the Miller batch);
                  proofs and the CRS through the wire format and back;
                msm-chunked-g1-262144: 262144 G1 and 8192 G2 points through
                  the bulk codec (compressed; decompressed and validated on
                  the card) and back; msm_chunked in four chunks with
                  checkpoints, one partial deleted and the run resumed,
                  against (sum s_i a_i) G1 on the host; a point outside the
                  r-torsion and an x off the curve refused;
                matrix-334: the Mat / B1 / B2 / BT parity API
                  (models/matrix.py) at make_ppe(334, 334)'s width:
                  com_left_mul of a 334 x 334 Fr matrix by a Com1 vector
                  (223,112 G1 scalar_mul lanes), com_right_mul of a Com2
                  vector by its transpose, comt_pairing_sum of the two and
                  the BT ops; every Com entry against the host, the GT
                  laws on the card;
                sharded-msm-x4: sharded_msm over a mesh of four shards on
                  the one card: msm-g1-65536's inputs (equal to its
                  result) and 4 x 4096 G2 points (against the host);
                sharded-pairing-4096-x4: sharded_multi_pairing of 4096
                  pairs in four shards against e(G1, G2)^(sum a_i b_i);
                batch-verify-ppe-1024-x4: batch-verify-ppe-1024's three
                  batches over four shards, the same verdicts;
                nccl-1rank: init_distributed with one NCCL rank,
                  make_global_mesh, sharded_msm and sharded_multi_pairing
                  through the all_gather merge, equal to the unsharded
                  results;
                trace: profiling.trace over a verify of
                  prove-verify-ppe-8x8's proof; the trace file holds CUDA
                  kernel events of the ported kernels;
                each counted run records the shape (and exponent) of every
                launch, and every kernel is then held bit-exact, with
                inputs made as in phase 2, at each recorded shape that
                phase 2 did not cover (the lazy tower's stacks, the tree
                product's halvings, the final exponentiation's inverse;
                Fr's mont_mul shapes are listed on a line of their own);
  4. report  -- launch counts of each path (every kernel the reference takes
                there must have run on it, each launch recorded with its
                shape; the Miller iterations exactly 63 + 5 times per
                Miller loop, the curve kernels 14 + 64 times per
                scalar_mul and as `msm_launches` derives them per msm
                call), each
                kernel's device time per launch
                (profiler) at its path shape beside its bound, the plain
                version's time (CUDA events); mont_mul also at the three
                shapes of each field that verify-ppe-334 launches most
                (over a field it launches none of, all the paths);
                one `kernels` JSON line, a profile of each path, then the
                result line.

Imports nothing of JAX or of the JAX package. Needs one card.
"""

from __future__ import annotations

import collections
import contextlib
import json
import random
import subprocess
import sys
import time
import traceback

BATCH = 8192          # pairs of pairing-8192
K_SIGNED = 2000       # pairs per entry of signed-2048 (padded to Kp = 2048)
FUSED = 4096          # pairs of pairing-4096: the fused Miller loop's cap
K_PPE = 1006          # verify_ppe_334's pairs, n + 2m + 4 (padded to 1024)
K_PPE_RHS = 4         # its rhs terms (conjugated): u_used, theta
EQUATIONS = 1024      # batch_verify_randomized_1024's equations
SEED = 20261017

# H100 SXM peaks (NVIDIA data sheet; CUDA programming guide throughput table):
# HBM3 3.35 TB/s; 32-bit integer multiply-add 64 per clock per SM x 132 SMs
# x 1.98 GHz = 16.7e12 per second. Both assume the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_IMAD_PER_S = 64 * 132 * 1.98e9

FP_SOURCE = "groth_sahai_tpu_torch/csrc/fp_kernels.cu"
TOWER_SOURCE = "groth_sahai_tpu_torch/csrc/tower_kernels.cu"
CURVE_SOURCE = "groth_sahai_tpu_torch/csrc/curve_kernels.cu"
ORIGIN = {   # kernel -> (the TPU kernel it replaces, its source in the port)
    "mont_mul": ("groth_sahai_tpu/ops/pallas_fp.py:188", FP_SOURCE),
    "mul_wide": ("groth_sahai_tpu/ops/pallas_fp.py:169", FP_SOURCE),
    "redc": ("groth_sahai_tpu/ops/pallas_fp.py:179", FP_SOURCE),
    "pow_const": ("groth_sahai_tpu/ops/pallas_fp.py:223", FP_SOURCE),
    "fq12_mul": ("groth_sahai_tpu/ops/pallas_tower.py:387", TOWER_SOURCE),
    "cyc_pow": ("groth_sahai_tpu/ops/pallas_tower.py:743", TOWER_SOURCE),
    "cyc_sqr": ("groth_sahai_tpu/ops/pallas_tower.py:404", TOWER_SOURCE),
    "miller_iter_dbl": ("groth_sahai_tpu/ops/pallas_tower.py:666",
                        TOWER_SOURCE),
    "miller_iter_add": ("groth_sahai_tpu/ops/pallas_tower.py:688",
                        TOWER_SOURCE),
    "f12_pow_dyn": ("groth_sahai_tpu/ops/pallas_tower.py:832", TOWER_SOURCE),
    "cmadd": ("groth_sahai_tpu/ops/pallas_curve.py:437", CURVE_SOURCE),
    "cdbl_n_add": ("groth_sahai_tpu/ops/pallas_curve.py:475", CURVE_SOURCE),
    "cadd": ("groth_sahai_tpu/ops/pallas_curve.py:457", CURVE_SOURCE),
    "cmsm_row_scan": ("groth_sahai_tpu/ops/pallas_curve.py:529", CURVE_SOURCE),
    "miller_dbl_step": ("groth_sahai_tpu/ops/pallas_tower.py:879",
                        TOWER_SOURCE),
    "miller_add_step": ("groth_sahai_tpu/ops/pallas_tower.py:901",
                        TOWER_SOURCE),
}
FIELD = ("mont_mul", "mul_wide", "redc", "pow_const")
NEW = ("cyc_sqr", "miller_iter_dbl", "miller_iter_add", "f12_pow_dyn")
MILLER = ("miller_iter_dbl", "miller_iter_add")
CURVE = ("cmadd", "cdbl_n_add")
MSM_KERNELS = ("cadd", "cmsm_row_scan")
STEPS = ("miller_dbl_step", "miller_add_step")
TOWER = ("fq12_mul", "cyc_pow", "cyc_sqr", "f12_pow_dyn") + MILLER
# The kernels each path must launch, as the reference takes them: above
# 4096 lanes the Miller loop runs the lazy tower over the field kernels
# alone; the signed product's reduction and final exponentiation run at
# <= 4096 lanes and take the tower kernels; at <= 4096 lanes each Miller
# iteration is one fused launch. `None`: the kernels the path must not
# launch (the big batches stay above the fused kernels' cap).
# The group commits, the scalar commits and scalar-mul-g1-4096 run
# Curve.scalar_mul (the curve kernels), the Jacobian glue on mont_mul (G1)
# or mul_wide + redc (G2), and to_affine's batched inverse on pow_const;
# none of them pairs anything. The prove/verify paths run all of that and
# the verifier's signed Miller product at Kp <= 1024 (fused Miller loop).
G1_GLUE = ("mont_mul",)
G2_GLUE = ("mont_mul", "mul_wide", "redc")
PATH_KERNELS = {
    "pairing-8192": (FIELD, NEW + CURVE),
    "signed-2048": (FIELD + ("fq12_mul", "cyc_pow"), NEW + CURVE),
    "pairing-4096": (FIELD + ("fq12_mul", "cyc_pow", "cyc_sqr") + MILLER,
                     ("f12_pow_dyn",) + CURVE),
    "signed-1024": (FIELD + ("fq12_mul", "cyc_pow") + MILLER,
                    ("cyc_sqr", "f12_pow_dyn") + CURVE),
    "gt-exp-4096": (("f12_pow_dyn",), MILLER + ("cyc_sqr", "cyc_pow") + CURVE),
    "commit-g1-334": (CURVE + G1_GLUE + ("pow_const",), TOWER),
    "commit-g2-334": (CURVE + G2_GLUE + ("pow_const",), TOWER),
    "commit-scalar-b1-334": (CURVE + G1_GLUE + ("pow_const",), TOWER),
    "commit-scalar-b2-334": (CURVE + G2_GLUE + ("pow_const",), TOWER),
    "scalar-mul-g1-4096": (CURVE + G1_GLUE, TOWER + ("pow_const",)),
    "gs-e2e": (FIELD + CURVE + MILLER + ("fq12_mul", "cyc_pow"),
               ("cyc_sqr", "f12_pow_dyn")),
    "prove-verify-ppe-8x8": (FIELD + CURVE + MILLER + ("fq12_mul", "cyc_pow"),
                             ("cyc_sqr", "f12_pow_dyn")),
    # the MSM paths: msm-g1-65536 runs the MSM alone (and to_jacobian's
    # G1 products); the prover's Com products at K = 334 take the MSM, its
    # commitments and K = 2 products scalar_mul; the verifier's Gamma d
    # takes the MSM, its Miller half the fused iterations
    "msm-g1-65536": (MSM_KERNELS + ("cdbl_n_add",) + G1_GLUE,
                     TOWER + ("cmadd", "pow_const")),
    "prove-ppe-334": (MSM_KERNELS + CURVE + G2_GLUE + ("pow_const",), TOWER),
    "verify-ppe-334": (MSM_KERNELS + ("cdbl_n_add",) + FIELD + MILLER
                       + ("fq12_mul", "cyc_pow"),
                       ("cmadd", "cyc_sqr", "f12_pow_dyn")),
    # the batch verifier: Gamma d of all equations is one scalar_mul (K =
    # 1), the Miller loop runs in tiles of 4096 lanes (fused iterations),
    # the rho-weighting one f12_pow_dyn launch per gt_exp
    "batch-verify-ppe-1024": (FIELD + CURVE + MILLER
                              + ("fq12_mul", "cyc_pow", "f12_pow_dyn"),
                              ("cyc_sqr",)),
    # the bulk codec (decompression on pow_const and the Jacobian glue,
    # validation on scalar_mul by r) and the chunked MSM
    "msm-chunked-g1-262144": (MSM_KERNELS + CURVE + FIELD, TOWER),
    # the parity API: two scalar_mul (G1, G2), Jacobian sums, to_affine,
    # one fused Miller loop, final_exp, GT inverse and one gt_exp
    "matrix-334": (CURVE + FIELD + ("fq12_mul", "cyc_pow", "f12_pow_dyn")
                   + MILLER, ("cyc_sqr",)),
    # one batched msm a curve; the merges are Jacobian glue
    "sharded-msm-x4": (MSM_KERNELS + ("cdbl_n_add",) + G2_GLUE,
                       TOWER + ("cmadd", "pow_const")),
    "sharded-pairing-4096-x4": (FIELD + ("fq12_mul", "cyc_pow") + MILLER,
                                ("cyc_sqr", "f12_pow_dyn") + CURVE),
    "batch-verify-ppe-1024-x4": (FIELD + CURVE + MILLER
                                 + ("fq12_mul", "cyc_pow", "f12_pow_dyn"),
                                 ("cyc_sqr",)),
    "nccl-1rank": (MSM_KERNELS + ("cdbl_n_add",) + FIELD + MILLER
                   + ("fq12_mul", "cyc_pow"),
                   ("cmadd", "cyc_sqr", "f12_pow_dyn")),
    "trace": (FIELD + CURVE + MILLER + ("fq12_mul", "cyc_pow"),
              ("cyc_sqr", "f12_pow_dyn")),
}
# No path but the MSM paths runs the MSM; no path but miller-steps-4096
# runs the Miller step entry points (no caller in either package).
for _path, (_need, _never) in list(PATH_KERNELS.items()):
    PATH_KERNELS[_path] = (_need, _never + STEPS + tuple(
        k for k in MSM_KERNELS if k not in _need))
PATH_KERNELS["miller-steps-4096"] = (STEPS, tuple(k for k in ORIGIN
                                                  if k not in STEPS))
EXACT = {("pairing-4096", "miller_iter_dbl"): 63,
         ("pairing-4096", "miller_iter_add"): 5,
         ("signed-1024", "miller_iter_dbl"): 63,
         ("signed-1024", "miller_iter_add"): 5,
         ("gt-exp-4096", "f12_pow_dyn"): 2}
# Curve.scalar_mul: 14 cmadd launches (the table 2P .. 15P) and 64
# cdbl_n_add launches (one per 4-bit window of 256 bits) per call.
SCALAR_MUL_LAUNCHES = {"cmadd": 14, "cdbl_n_add": 64}
M_COMMIT = 334           # variables of the reference's commit_*_334 rows
SCALAR_LANES = 4096      # points of scalar-mul-g1-4096 (benches/suite.py)
PPE_SIDE = 8             # m = n of prove-verify-ppe-8x8: the largest PPE
                         # whose com_matvec stays below K = 16
MSM_POINTS = 65536       # points of msm-g1-65536 (the reference's msm_65536)
PPE_M = 334              # m = n of prove-ppe-334 and verify-ppe-334
STEP_LANES = 4096        # Q points of miller-steps-4096
BAD_SLOT = 517           # batch-verify-ppe-1024's slot with another proof's pi
MIN_PROOFS = 64          # distinct proofs of batch-verify-ppe-1024, at least,
PROOF_SECONDS = 45.0     # and as many more as this much card time makes
CHUNKED_POINTS = 262144  # G1 points of msm-chunked-g1-262144
CHUNK = 65536            # its chunk size: four chunks
MATRIX_SIDE = 334        # matrix-334: Gamma's side, the Com vectors' length
SHARDS = 4               # shards of the virtual mesh, all on the one card
G2_SHARD_POINTS = 4096   # sharded-msm-x4's G2 points a shard


def e2e_scalar_muls(x_scalar: bool, y_scalar: bool, quad: bool,
                    verifies: int) -> int:
    """Curve.scalar_mul calls of one commit_and_prove and `verifies`
    verify calls of one equation, as models/prover.py and verifier.py make
    them: a group side commits with one com_matvec (R times the key), a
    scalar side with two (iota_prime and scalar_mul_vec); the prover makes
    six com_matvec (pi1, pi2, pi3, th1, th2, th3) and, per scalar side, two
    iota_prime (the constants' and the variables' _iota_side); `verify`
    makes one com_matvec (Gamma d), one iota_prime per scalar side (the
    constants) and, for a quadratic equation, the target pair's
    scalar_mul_vec. Each com_matvec here has K < 16: one scalar_mul (at
    K >= 16 it is one `msm` call instead, see `msm_calls`)."""
    commit = (2 if x_scalar else 1) + (2 if y_scalar else 1)
    prove = 6 + 2 * x_scalar + 2 * y_scalar
    return commit + prove + verifies * (1 + x_scalar + y_scalar + quad)


# gs-e2e: the four equations of tests/test_gs_e2e.py, each proved, then
# verified and verified again with a wrong target: 10 + 15 + 15 + 22 = 62
# scalar multiplications, and 8 signed Miller products at Kp <= 1024, each
# 63 + 5 fused Miller iterations. prove-verify-ppe-8x8: one PPE, verified
# and verified again with a changed pi.
E2E_TYPES = {"PPE": (False, False, False), "MSMEG1": (False, True, False),
             "MSMEG2": (True, False, False), "QuadEqu": (True, True, True)}
SCALAR_MULS = {
    "commit-g1-334": 1, "commit-g2-334": 1, "commit-scalar-b1-334": 2,
    "commit-scalar-b2-334": 2, "scalar-mul-g1-4096": 1,
    "gs-e2e": sum(e2e_scalar_muls(*t, verifies=2)
                  for t in E2E_TYPES.values()),
    "prove-verify-ppe-8x8": e2e_scalar_muls(False, False, False, 2)}
# prove-ppe-334: the two commitments and pi3, theta3 (K = 2) are
# scalar_mul calls; pi1, pi2, theta1, theta2 (K = 334) are msm calls.
# verify-ppe-334 verifies three times (an honest proof, a changed pi, a
# wrong target): each Gamma d is one msm call.
SCALAR_MULS["prove-ppe-334"] = 4
# batch-verify-ppe-1024 runs three batches (randomized, randomized with
# slot BAD_SLOT changed, per-equation verdicts): each one Gamma d scalar_mul
# over all equations, 16 tiles of 4096 Miller lanes (1024 equations x 2 x
# 2 x Kp = 16), and the randomized two gt_exp calls each. msm-chunked-
# g1-262144 validates two bulk reads (G1, G2) and three resumed partials
# with one scalar_mul by r each.
SCALAR_MULS["batch-verify-ppe-1024"] = 3
SCALAR_MULS["msm-chunked-g1-262144"] = 2 + 3
BATCH_TILES = -(-EQUATIONS // (FUSED // (4 * 16)))
VERIFIES = {"gs-e2e": 2 * len(E2E_TYPES), "prove-verify-ppe-8x8": 2,
            "verify-ppe-334": 3}
for _path, _calls in SCALAR_MULS.items():
    for _name, _per in SCALAR_MUL_LAUNCHES.items():
        EXACT[_path, _name] = _calls * _per
for _path, _calls in VERIFIES.items():
    EXACT[_path, "miller_iter_dbl"] = 63 * _calls
    EXACT[_path, "miller_iter_add"] = 5 * _calls
EXACT["miller-steps-4096", "miller_dbl_step"] = 63
EXACT["miller-steps-4096", "miller_add_step"] = 5
EXACT["batch-verify-ppe-1024", "miller_iter_dbl"] = 3 * BATCH_TILES * 63
EXACT["batch-verify-ppe-1024", "miller_iter_add"] = 3 * BATCH_TILES * 5
EXACT["batch-verify-ppe-1024", "f12_pow_dyn"] = 2 * 2
# matrix-334: two scalar_mul, one Miller loop, one gt_exp. The sharded
# pairings: one Miller loop a device. batch-verify-ppe-1024-x4: per batch
# each of the SHARDS groups runs its Gamma d scalar_mul and its tiles (as
# many in all as unsharded), each randomized group two gt_exp. trace: one
# verify of prove-verify-ppe-8x8.
for _path, _calls in (("matrix-334", 2), ("batch-verify-ppe-1024-x4",
                                          3 * SHARDS), ("trace", 1)):
    for _name, _per in SCALAR_MUL_LAUNCHES.items():
        EXACT[_path, _name] = _calls * _per
for _path, _loops in (("matrix-334", 1), ("sharded-pairing-4096-x4", 1),
                      ("batch-verify-ppe-1024-x4", 3 * SHARDS * -(
                          -(EQUATIONS // SHARDS) // (FUSED // (4 * 16)))),
                      ("nccl-1rank", 1), ("trace", 1)):
    EXACT[_path, "miller_iter_dbl"] = 63 * _loops
    EXACT[_path, "miller_iter_add"] = 5 * _loops
EXACT["matrix-334", "f12_pow_dyn"] = 1
EXACT["batch-verify-ppe-1024-x4", "f12_pow_dyn"] = 2 * SHARDS * 2


def msm_geometry(n_points: int, window: int = 0):
    """(window, width, rows, n_windows, nbuck) of one `msm` call over
    n_points points, from ops/msm.py's rules."""
    from groth_sahai_tpu_torch.ops import msm as MS
    window = window or (8 if n_points < 16384 else 13)
    n_windows = -(-MS.NBITS // window)
    width = MS._pick_width(n_points * n_windows, None)
    rows = -(-n_points * n_windows // width)
    return window, width, rows, n_windows, (1 << (window - 1)) + 1


def ppe_window(k: int) -> int:
    """com_matvec's MSM window at K (padded to Kp): 4 below 512, else 8."""
    from groth_sahai_tpu_torch.models.kernels import next_pow2
    return 4 if next_pow2(k) < 512 else 8


def msm_launches(n_points: int, window: int = 0) -> dict:
    """Kernel launches of one `msm` call (ops/msm.py): one row scan; cadd
    log2(width) times for the lane prefix, once for the prefix lookups,
    once for the bucket differences, once per halving of the digit axis
    above 1024 lanes and log2 of the rest for its prefix; one cdbl_n_add
    (n = window) per window."""
    window, width, _, n_windows, nbuck = msm_geometry(n_points, window)
    L, halvings = nbuck - 1, 0
    while L > 1024:
        L //= 2
        halvings += 1
    return {"cmsm_row_scan": 1,
            "cadd": width.bit_length() - 1 + 2 + halvings + L.bit_length() - 1,
            "cdbl_n_add": n_windows}


def msm_calls() -> dict:
    """path -> the (points, window) of each msm call it makes: points
    of one MSM of the call's batch (a sharded msm is one call over a batch
    of SHARDS MSMs a device; `msm_launches` counts one call, whatever its
    batch: each launch covers every MSM's lanes)."""
    from groth_sahai_tpu_torch.models.kernels import next_pow2
    kp = next_pow2(PPE_M)
    return {"msm-g1-65536": [(MSM_POINTS, 0)],
            "prove-ppe-334": [(kp, ppe_window(PPE_M))] * 4,
            "verify-ppe-334": [(kp, ppe_window(PPE_M))] * VERIFIES[
                "verify-ppe-334"],
            # four chunks, then one recomputed after a partial is deleted
            "msm-chunked-g1-262144": [(CHUNK, 0)] * 5,
            "sharded-msm-x4": [(MSM_POINTS // SHARDS, 13),
                               (G2_SHARD_POINTS, 8)],
            "nccl-1rank": [(MSM_POINTS // SHARDS, 13)]}


def exact_counts() -> dict:
    """EXACT plus each path's msm launches."""
    exact = dict(EXACT)
    for path, calls in msm_calls().items():
        for n_points, window in calls:
            for name, k in msm_launches(n_points, window).items():
                exact[path, name] = exact.get((path, name), 0) + k
    return exact


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def kernel_modules():
    from groth_sahai_tpu_torch.ops import cuda_curve, cuda_fp, cuda_tower
    return cuda_fp, cuda_tower, cuda_curve


def kernels():
    """name -> wrapper of every ported kernel."""
    return {k.__name__: k for m in kernel_modules() for k in m.KERNELS}


def reset_counts():
    for m in kernel_modules():
        m.reset_counts()


def read_counts():
    return {name: k.launches for name, k in kernels().items()}


def reset_peak():
    import torch
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def peak_gib() -> float:
    """The card's peak allocated memory since `reset_peak` (0 without a
    card)."""
    import torch
    return (torch.cuda.max_memory_allocated() / 2 ** 30
            if torch.cuda.is_available() else 0.0)


def counted(fn, shapes, module=None):
    """One counted run of a path: launch counts from 0, every launch's
    shape recorded, the card's peak memory. With `module` (a kernel
    module the path calls itself), fn takes its recording copy. Returns
    (output, counts, seconds, peak GiB)."""
    reset_counts()
    reset_peak()
    with recording(shapes) as proxies:
        t0 = time.perf_counter()
        out = fn(proxies[module.__name__]) if module else fn()
        sync()
        secs = time.perf_counter() - t0
    return out, read_counts(), secs, peak_gib()


def time_ms(fn, reps: int) -> float:
    """Mean time of one call by CUDA events over `reps` back-to-back calls
    (device time plus whatever the host's issue of each call adds)."""
    import torch
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    sync()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernel: str) -> tuple:
    """Device time of one launch of `kernel` (the profiler's CUPTI record,
    without the host's issue time), averaged over the launches of `reps`
    calls that the profiler recorded (it may miss the first of a window);
    where it records none (as for some long launches), the call's time by
    CUDA events. Returns (ms, "profiler" or "cuda events")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel + "_kernel" in e.key]
    count = sum(e.count for e in rows)
    if count > reps:
        raise AssertionError(f"the profiler saw {count} launches of {kernel} "
                             f"in {reps} calls")
    if not count:
        return time_ms(fn, reps), "cuda events"
    return sum(e.self_device_time_total for e in rows) / count / 1e3, \
        "profiler"


# ----------------------------------------------------------------- phase 2

def rand_limbs(rows: int, lanes: int, bits: int, gen, device):
    """Random exact limbs of values < 2^bits, from a seeded generator (on
    the device, from a seed the generator draws, above 2^24 limbs)."""
    import torch
    if rows * lanes > 1 << 24:
        dev_gen = torch.Generator(device).manual_seed(
            int(torch.randint(1 << 62, (1,), generator=gen)))
        x = torch.randint(0, 1 << 16, (rows, lanes), generator=dev_gen,
                          dtype=torch.int64, device=device)
    else:
        x = torch.randint(0, 1 << 16, (rows, lanes), generator=gen,
                          dtype=torch.int64).to(device)
    for i in range(rows):
        keep = max(0, min(16, bits - 16 * i))
        x[i] &= (1 << keep) - 1
    return x


def edge_limbs(values, rows: int, device):
    import numpy as np
    import torch
    from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
    return torch.as_tensor(ints_to_limbs(values, rows).astype(np.int64),
                           device=device)


def field_inputs(field, lanes: int, gen, device):
    """(a, b, t) for one field: random lanes with value(a), value(b) < 2^8 p
    (so value(a)*value(b) <= 2^16 p^2) and t < p R, then the edge lanes."""
    p, n = field.p, field.n
    top = (p << 8).bit_length() - 1                  # 2^top <= 2^8 p
    wide_top = (p * field.R_int).bit_length() - 1    # 2^wide_top <= p R
    a = rand_limbs(n, lanes, top, gen, device)
    b = rand_limbs(n, lanes, top, gen, device)
    t = rand_limbs(2 * n + 1, lanes, wide_top, gen, device)
    edge_a = [0, 1, p - 1, 2 * p - 1, p << 8, p << 16, (p << 16) - 1, p - 1]
    edge_b = [p - 1, 1, p - 1, 2 * p - 1, p << 8, p, p, 0]
    assert all(x * y <= (p * p) << 16 for x, y in zip(edge_a, edge_b))
    edge_t = [p * field.R_int - 1, 0, 1, p, (p * p) << 16, p * field.R_int // 2,
              field.R_int, field.R_int - 1]
    k = min(len(edge_a), lanes)
    a[:, :k] = edge_limbs(edge_a[:k], n, device)
    b[:, :k] = edge_limbs(edge_b[:k], n, device)
    t[:, :k] = edge_limbs(edge_t[:k], 2 * n + 1, device)
    return a, b, t


def fq12_inputs(lanes: int, bound_p: int, gen, device, edges):
    """int64 [25, 12, lanes] with coefficients < bound_p * p; lane k of the
    first len(edges) has every coefficient equal to edges[k]."""
    from groth_sahai_tpu_torch.ops.fp import FQ
    bits = (bound_p * FQ.p).bit_length() - 1         # 2^bits <= bound_p p
    x = rand_limbs(FQ.n, 12 * lanes, bits, gen, device).reshape(
        FQ.n, 12, lanes)
    for k, v in enumerate(edges[:lanes]):
        x[:, :, k] = edge_limbs([v], FQ.n, device)
    return x


# The shape that carries most of each kernel's work on the paths, in
# lanes, at which the report times it: at 8192 pairs mont_mul runs over an
# Fq2 batch (FQ2.mul_fq in the Miller steps), mul_wide over the Fq12
# product's 54 stacked Fq products, redc over its 12 coefficients,
# pow_const over the Fq inverse of final_exp; on the signed product
# fq12_mul takes the first tree-reduction step, (2, 2, 1024) = 4096 lanes;
# cyc_pow runs pairing-4096's final exponentiation over 4096 lanes (and the
# signed products' over (2, 2) = 4, timed too); the Miller iterations run
# on (2, 2, 1024) = 4096 lanes on signed-1024 and on 4096 on pairing-4096,
# cyc_sqr on pairing-4096's outputs, f12_pow_dyn on (1024, 2, 2) = 4096
# lanes (and on 1024). The paths' other shapes are recorded as they run.
# The curve kernels are timed on G1 over scalar-mul-g1-4096's 4096 lanes,
# and over the group commits' (2, 334, 2) = 1336 lanes on G1 and G2.
COMMIT_LANES = 4 * M_COMMIT
PATH_LANES = {"mont_mul": 2 * BATCH, "mul_wide": 54 * BATCH,
              "redc": 12 * BATCH, "pow_const": BATCH,
              "fq12_mul": 4096, "cyc_pow": FUSED, "cyc_sqr": FUSED,
              "miller_iter_dbl": FUSED, "miller_iter_add": FUSED,
              "f12_pow_dyn": FUSED, "cmadd": SCALAR_LANES,
              "cdbl_n_add": SCALAR_LANES, "miller_dbl_step": STEP_LANES,
              "miller_add_step": STEP_LANES}
MAIN_FIELD = {"cmadd": "G1", "cdbl_n_add": "G1"}     # others: Fq
# verify-ppe-334's Gamma d combines its windows with one cdbl_n_add per
# window over its 2 PPE_M G2 MSMs, n_dbl = the window (ppe_window(PPE_M))
GAMMA_D_SHIFT = ("G2", 2 * PPE_M, 8)
# msm-g1-65536 combines its windows over one lane, n_dbl = 13
MSM_G1_SHIFT = ("G1", 1, 13)
ALSO_TIMED = {"fq12_mul": [("Fq", 4), ("Fq", 2048)],
              "cyc_pow": [("Fq", 4)], "f12_pow_dyn": [("Fq", EQUATIONS)],
              "pow_const": [("Fq", 4), ("Fq", 21)],
              "miller_iter_add": [("Fq", 128)],
              "cmadd": [("G2", COMMIT_LANES), ("G1", COMMIT_LANES)],
              "cdbl_n_add": [("G2", COMMIT_LANES, 4), ("G1", COMMIT_LANES, 4),
                             GAMMA_D_SHIFT, MSM_G1_SHIFT]}
# ragged widths of the grouped kernels (lanes not a multiple of a block's)
RAGGED = (1, 3, 1000)


def fq2_inputs(lanes: int, bound_p: int, gen, device, edges):
    """int64 [25, 2, lanes] with components < bound_p * p; lane k of the
    first len(edges) has both components equal to edges[k]."""
    from groth_sahai_tpu_torch.ops.fp import FQ
    bits = (bound_p * FQ.p).bit_length() - 1
    x = rand_limbs(FQ.n, 2 * lanes, bits, gen, device).reshape(FQ.n, 2, lanes)
    for k, v in enumerate(edges[:lanes]):
        x[:, :, k] = edge_limbs([v], FQ.n, device)
    return x


def miller_inputs(lanes: int, gen, device):
    """(f, R, Q, P) for the Miller iterations: f < 2p; R = (X, Y, Z) with
    X, Z < 2p, Y < 10p; Q, P affine < p. Lane 0 at the top of each bound,
    lane 1 with P = Q = (0, 0) (the padding point) and R zero, lane 2 with
    P = (0, 0) alone, lane 3 with Q = (0, 0) alone."""
    from groth_sahai_tpu_torch.ops.fp import FQ
    p = FQ.p
    f = fq12_inputs(lanes, 2, gen, device, [2 * p - 1, 2 * p - 1])
    R = (fq2_inputs(lanes, 2, gen, device, [2 * p - 1, 0]),
         fq2_inputs(lanes, 10, gen, device, [10 * p - 1, 0]),
         fq2_inputs(lanes, 2, gen, device, [2 * p - 1, 0]))
    Q = tuple(fq2_inputs(lanes, 1, gen, device, [p - 1, 0]) for _ in range(2))
    P = tuple(fq2_inputs(lanes, 1, gen, device, [p - 1, 0])[:, 0]
              for _ in range(2))
    for x in P:
        x[:, 2:3] = 0
    for x in Q:
        x[:, :, 3:4] = 0
    return f, R, Q, P


def scalar_inputs(lanes: int, gen, device):
    """Fr standard-form limbs [17, lanes]: random 255-bit scalars, then
    0, r - 1, 2^272 - 1 and 1 in the first lanes."""
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.fp import FR
    s = rand_limbs(FR.n, lanes, 255, gen, device)
    edges = [0, C.R - 1, (1 << 272) - 1, 1][:lanes]
    s[:, :len(edges)] = edge_limbs(edges, FR.n, device)
    return s


def curve_edge_lanes(curve):
    """Montgomery ints (G1) or int pairs (G2) of the curve kernels' edge
    lanes, (P, Q, A, inf): lane 0 P at infinity (0 : 1 : 0); lane 1 A and
    Q at infinity; lane 2 P = A = Q (P + P, Q with another Z); lane 3
    Q = -P and A = -P (P + (-P)); lane 4 every coordinate at the top of
    its bound (4p - 1 projective, 2p - 1 affine)."""
    from groth_sahai_tpu_torch.ops.fp import FQ
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    p = FQ.p
    g2 = curve.ns == 2
    gen = ((H.C.G2_GEN_X, H.C.G2_GEN_Y) if g2 else (H.C.G1_GEN_X,
                                                     H.C.G1_GEN_Y))
    mul = H.g2_mul if g2 else H.g1_mul
    pts = [mul(gen, k) for k in (7, 11, 13)]
    scale = lambda v, k: (tuple(c * k % p for c in v) if g2 else v * k % p)
    mont = lambda v: scale(v, FQ.r_mod_p)
    zero, one = ((0, 0), (1, 0)) if g2 else (0, 1)
    const = lambda v: (v, v) if g2 else v

    def proj(pt, lam, negate=False):
        y = (scale(pt[1], p - 1) if negate else pt[1])
        return tuple(mont(scale(c, lam)) for c in (pt[0], y, one))

    inf = (zero, mont(one), zero)
    P = [inf, proj(pts[0], 3), proj(pts[1], 5), proj(pts[2], 7),
         (const(4 * p - 1),) * 3]
    Q = [proj(pts[0], 9), inf, proj(pts[1], 11), proj(pts[2], 13, True),
         (const(4 * p - 1),) * 3]
    A = [tuple(mont(c) for c in pts[1]), (zero, zero),
         tuple(mont(c) for c in pts[1]), (mont(pts[2][0]),
                                          mont(scale(pts[2][1], p - 1))),
         (const(2 * p - 1),) * 2]
    return P, Q, A, [False, True, False, False, False]


def curve_args(name, curve, lanes, n_dbl, gen, device):
    """(P, A, curve) or (P, n_dbl, Q, curve): seeded random coordinates
    (< 4p projective, < 2p affine, a quarter of the affine points at
    infinity), then the edge lanes of `curve_edge_lanes`."""
    import torch
    from groth_sahai_tpu_torch.ops.fp import FQ

    def coord(bound_p, edges):
        x = fq2_inputs(lanes, bound_p, gen, device, [])
        if curve.ns == 1:
            x = x[:, 0].contiguous()
        for k, v in enumerate(edges[:lanes]):
            vals = list(v) if curve.ns == 2 else [v]
            x[..., k] = edge_limbs(vals, FQ.n, device).reshape(x[..., k].shape)
        return x

    P, Q, A, inf = curve_edge_lanes(curve)
    p = tuple(coord(4, [pt[c] for pt in P]) for c in range(3))
    if name in ("cdbl_n_add", "cadd"):
        q = tuple(coord(4, [pt[c] for pt in Q]) for c in range(3))
        return (p, n_dbl, q, curve) if name == "cdbl_n_add" else (p, q, curve)
    flags = torch.rand(lanes, generator=gen) < 0.25
    flags[:len(inf)] = torch.tensor(inf[:lanes])
    flags = flags.to(device)
    a = [coord(2, [pt[c] for pt in A]) for c in range(2)]
    for x in a:                        # affine infinity is (0, 0)
        x[..., flags] = 0
    return p, (a[0], a[1], flags), curve


def scan_args(curve, lanes, rows, gen, device):
    """(pts, curve) for cmsm_row_scan over `rows` rows of `lanes` lanes:
    seeded random affine coordinates < 2p, a quarter of them flagged
    infinite; lane 0 a column that is all infinity; lane 1 the same point
    A in every row (P + P from row 1 on); lane 2 A, then -A, alternately
    (P + (-P)); lane 3 every coordinate at 2p - 1. The accumulator starts
    at infinity in every lane."""
    import torch
    from groth_sahai_tpu_torch.ops.fp import FQ
    p = FQ.p
    lead = (2,) if curve.ns == 2 else ()

    def coord(bound_p):
        x = rand_limbs(FQ.n, (2 if curve.ns == 2 else 1) * rows * lanes,
                       (bound_p * p).bit_length() - 1, gen, device)
        return x.reshape((FQ.n,) + lead + (rows, lanes))

    x, y = coord(2), coord(2)
    inf = (torch.rand((rows, lanes), generator=gen) < 0.25).to(device)
    A = curve_edge_lanes(curve)[2][0]              # affine, Montgomery
    neg = (tuple(-c % p for c in A[1]) if curve.ns == 2 else -A[1] % p)
    cols = {1: [A] * rows, 2: [A if r % 2 == 0 else (A[0], neg)
                               for r in range(rows)],
            3: [((2 * p - 1,) * 2 if curve.ns == 2 else 2 * p - 1,) * 2] * rows}
    for lane, pts in cols.items():
        if lane >= lanes:
            continue
        for c, t in ((0, x), (1, y)):
            vals = [v for pt in pts for v in
                    (pt[c] if curve.ns == 2 else (pt[c],))]
            limbs = edge_limbs(vals, FQ.n, device)      # (25, rows ns)
            t[..., lane] = limbs.reshape((FQ.n, rows) + lead).movedim(
                1, -1) if curve.ns == 2 else limbs
        inf[:, lane] = False
    inf[:, 0] = True
    return (x, y, inf), curve


def case_args(name, field, lanes, e, gen, device):
    """The arguments of one kernel call over `lanes` lanes: seeded random
    values plus the edge lanes; `e` is the exponent of pow_const and
    cyc_pow, the number of doublings of cdbl_n_add, the rows of
    cmsm_row_scan; `field` is the curve of a curve kernel."""
    if name == "cmsm_row_scan":
        return scan_args(field, lanes, e, gen, device)
    if name in CURVE + ("cadd",):
        return curve_args(name, field, lanes, e, gen, device)
    if name in STEPS:
        from groth_sahai_tpu_torch.ops.fp import FQ
        _, R, Q, _ = miller_inputs(lanes, gen, device)
        return (R, (FQ.p + 1) // 2) if name == "miller_dbl_step" else (R, Q)
    p = field.p
    if name in FIELD:
        a, b, t = field_inputs(field, lanes, gen, device)
        return {"mont_mul": (field, a, b), "mul_wide": (field, a, b),
                "redc": (field, t), "pow_const": (field, a, e)}[name]
    if name == "fq12_mul":
        top = 32 * p - 1                 # bound(a) bound(b) <= 1024 p^2
        return (fq12_inputs(lanes, 32, gen, device, [top, top, 0, p - 1]),
                fq12_inputs(lanes, 32, gen, device, [top, 1, top, p - 1]))
    if name in MILLER:
        f, R, Q, P = miller_inputs(lanes, gen, device)
        return (f, R, *P) if name == "miller_iter_dbl" else (f, R, Q, *P)
    a = fq12_inputs(lanes, 2, gen, device, [2 * p - 1, 0, 2 * p - 1])
    return {"cyc_pow": (a, e), "cyc_sqr": (a,),
            "f12_pow_dyn": (a, scalar_inputs(lanes, gen, device))}[name]


def phase2_shapes():
    """(kernel, field, lanes, exponent) of every phase-2 check: each kernel
    at its path shapes (Fq), the field kernels at Fr width too."""
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.fp import FQ, FR
    v_abs = abs(C.X) + 1                 # the final exp's three exponents
    shapes = [(name, field, PATH_LANES[name] if field is FQ else BATCH,
               field.p - 2 if name == "pow_const" else None)
              for field in (FQ, FR) for name in FIELD]
    shapes += [("fq12_mul", FQ, m, None)
               for m in (PATH_LANES["fq12_mul"], 2048, 4) + RAGGED]
    shapes += [("cyc_pow", FQ, m, e)
               for m in [FUSED] + [m for _, m in ALSO_TIMED["cyc_pow"]]
               for e in (v_abs // 3, v_abs, abs(C.X))]
    shapes += [("cyc_pow", FQ, m, abs(C.X)) for m in RAGGED]
    shapes += [("pow_const", FQ, m, FQ.p - 2)
               for m in [m for _, m in ALSO_TIMED["pow_const"]]
               + [1, 3, 1001]]
    shapes += [(name, FQ, FUSED, None) for name in ("cyc_sqr",) + MILLER]
    shapes += [(name, FQ, m, None) for name in MILLER
               for m in RAGGED + (FUSED + 3,)]
    shapes += [("miller_iter_add", FQ, m, None)
               for _, m in ALSO_TIMED["miller_iter_add"]]
    shapes += [("f12_pow_dyn", FQ, m, None) for m in (FUSED, EQUATIONS, 3)]
    from groth_sahai_tpu_torch.ops.curve import G1, G2
    for name in CURVE:
        e = 4 if name == "cdbl_n_add" else None
        shapes += [(name, G1, m, e) for m in (SCALAR_LANES, COMMIT_LANES, 4)]
        shapes += [(name, G2, m, e) for m in (COMMIT_LANES, 4)]
    shapes += [("cmadd", c, m, None) for c in (G1, G2) for m in (1, 1001)]
    assert ppe_window(PPE_M) == GAMMA_D_SHIFT[2]
    assert msm_geometry(MSM_POINTS)[0] == MSM_G1_SHIFT[2]
    shapes.append(("cdbl_n_add", G2) + GAMMA_D_SHIFT[1:])
    shapes.append(("cdbl_n_add", G1) + MSM_G1_SHIFT[1:])
    shapes += [("cdbl_n_add", c, m, n) for c in (G1, G2)
               for m, n in ((1000, 8), (3, 13))]
    curves = {"G1": G1, "G2": G2}
    for name in MSM_KERNELS:      # the report's shapes, then ragged widths
        shapes += [(name, curves[c], m, e) for c, m, e in msm_shapes(name)]
        e = 6 if name == "cmsm_row_scan" else None
        shapes += [(name, c, m, e) for c in (G1, G2) for m in (1000, 4)]
    shapes += [(name, FQ, STEP_LANES, None) for name in STEPS]
    shapes += [(name, FQ, m, None) for name in ("cyc_sqr",) + STEPS
               for m in RAGGED + (STEP_LANES + 3,)]
    return shapes


def msm_shapes(name):
    """The report's shapes of an MSM kernel, main first: (curve name,
    lanes, rows or None). cmsm_row_scan over verify-ppe-334's 2 PPE_M
    MSMs (G2), msm-g1-65536's one (G1) and prove-ppe-334's four (G2);
    cadd at the prefix lookups of the same calls (n_windows nbuck lanes
    per MSM), the widest cadd of each path."""
    from groth_sahai_tpu_torch.models.kernels import next_pow2
    _, width, rows, nw, nb = msm_geometry(MSM_POINTS)
    _, pwidth, prows, pnw, pnb = msm_geometry(next_pow2(PPE_M),
                                              ppe_window(PPE_M))
    if name == "cmsm_row_scan":
        return [("G2", 2 * PPE_M * pwidth, prows), ("G1", width, rows),
                ("G2", 4 * pwidth, prows)]
    return [("G2", 2 * PPE_M * pnw * pnb, None), ("G1", nw * nb, None),
            ("G2", 4 * pnw * pnb, None)]


def plain_of(name):
    plain = {}
    for m in kernel_modules():
        plain.update(m.PLAIN)
    return plain[kernels()[name]]


def flat(x):
    """The tensors of a kernel's output (a tensor or nested tuples)."""
    import torch
    return [x] if torch.is_tensor(x) else [y for z in x for y in flat(z)]


def compare(name, args):
    """Kernel and plain version on the same inputs; max |difference| over
    every output tensor."""
    got, want = flat(kernels()[name](*args)), flat(plain_of(name)(*args))
    sync()
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} against "
                                 f"{tuple(w.shape)}")
        err = max(err, int((g - w).abs().max().item()))
    return err


def check_shape(name, field, lanes, e, gen, device, worst, tag):
    """Kernel against plain version on fresh inputs of one shape; returns
    the arguments."""
    args = case_args(name, field, lanes, e, gen, device)
    err = compare(name, args)
    worst[name] = max(worst[name], err)
    print(f"[{tag}] {field.name} {name:15s} lanes={lanes:6d} "
          f"max_abs_err={err}", flush=True)
    if err != 0:
        raise AssertionError(f"{name} on {field.name} over {lanes} lanes "
                             f"differs from its plain version")
    return args


def moved(x, device):
    """A kernel's arguments (tensors in nested tuples) on `device`."""
    import torch
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(moved(y, device) for y in x)
    return x


def check_kernels(device):
    """Phase 2: every kernel bit-exact against its plain version at its
    path's main shapes. Returns (worst error by kernel, the report's
    timing cases by (kernel, field, lanes), kept on the host, the shapes
    checked)."""
    import torch
    from groth_sahai_tpu_torch.ops import cuda_fp as K
    from groth_sahai_tpu_torch.ops.fp import FQ, FR
    gen = torch.Generator().manual_seed(SEED)
    worst = {name: 0 for name in ORIGIN}
    timing, checked = {}, set()
    timed = {(name, f, m) for name in ORIGIN for f, m, _ in
             report_shapes(name)}
    for name, field, lanes, e in phase2_shapes():
        args = check_shape(name, field, lanes, e, gen, device, worst,
                           "kernels")
        checked.add((name, field.name, lanes, e))
        if (name, field.name, lanes) in timed:     # kept on the host
            timing[name, field.name, lanes] = moved(args, "cpu")
        del args
    # the Miller steps give the Miller iterations' R update, limb for limb
    from groth_sahai_tpu_torch.ops import cuda_tower as CT
    f, R, Q, P = miller_inputs(STEP_LANES, gen, device)
    pairs = ((CT.miller_dbl_step(R, (FQ.p + 1) // 2)[0],
              CT.miller_iter_dbl(f, R, *P)[1]),
             (CT.miller_add_step(R, Q)[0], CT.miller_iter_add(f, R, Q, *P)[1]))
    for stepped, iterated in pairs:
        if not all(torch.equal(a, b) for a, b in zip(stepped, iterated)):
            raise AssertionError("a Miller step's R differs from the "
                                 "Miller iteration's")
    print(f"[kernels] miller_dbl_step and miller_add_step over {STEP_LANES} "
          f"lanes: R equals miller_iter_dbl's and miller_iter_add's",
          flush=True)
    # the Fermat inverse really inverts: a * a^(p-2) == 1 on random lanes
    gen = torch.Generator().manual_seed(SEED + 1)
    fq_a = field_inputs(FQ, 256, gen, device)[0][:, 8:]
    prod = FQ.normalize(FQ.mul(FQ.normalize(fq_a, k=256),
                               K.pow_const(FQ, fq_a, FQ.p - 2)))
    one = FQ.normalize(FQ.one((fq_a.shape[1],), device=device))
    if not bool((prod == one).all()):
        raise AssertionError("pow_const(a, p-2) is not the inverse of a")
    return worst, timing, checked


@contextlib.contextmanager
def recording(shapes):
    """While inside, every call of a kernel's wrapper through the port's
    modules that launches adds one to shapes[(kernel, field name, lanes,
    exponent)]. The modules that call the wrappers (fp, tower, pairing,
    ...) see a copy of `cuda_fp`, `cuda_tower` and `cuda_curve` whose
    wrappers record;
    the wrappers themselves and their counts stay as they are. A curve
    kernel's shape is (kernel, curve name, lanes, n_dbl or the row scan's
    rows). Yields the recording copies by module name, for a path that
    calls the wrappers itself."""
    import types
    from groth_sahai_tpu_torch.ops.fp import FQ
    K, CT, CC = kernel_modules()

    def shim(kern, lead):
        def call(*args):
            out = kern(*args)
            if lead is None:                 # curve kernels: (..., curve)
                field, lead_ = args[-1], args[-1].ns
                e = args[1] if isinstance(args[1], int) else None
                if kern.__name__ == "cmsm_row_scan":
                    e = args[0][2].shape[0]          # its rows
            else:
                field = args[0] if lead == 1 else FQ
                e = args[-1] if isinstance(args[-1], int) else None
                lead_ = lead
                if kern.__name__ in STEPS:           # 1/2, not an exponent
                    e = None
            lanes = flat(out)[0][(0,) * lead_].numel()
            if lanes:
                shapes[kern.__name__, field.name, lanes, e] += 1
            return out
        return call

    proxies = []
    for module, lead in ((K, 1), (CT, 2), (CC, None)):
        proxy = types.ModuleType(module.__name__)
        proxy.__dict__.update(vars(module))
        for kern in module.KERNELS:
            setattr(proxy, kern.__name__, shim(kern, lead))
        proxies.append((module, proxy))
    saved = []
    for mod in list(sys.modules.values()):
        name = getattr(mod, "__name__", "")
        if not name.startswith("groth_sahai_tpu_torch.") or \
                name == K.__package__:
            continue
        for attr, val in list(vars(mod).items()):
            for module, proxy in proxies:
                if val is module:
                    saved.append((mod, attr, val))
                    setattr(mod, attr, proxy)
    try:
        yield {module.__name__: proxy for module, proxy in proxies}
    finally:
        for mod, attr, val in saved:
            setattr(mod, attr, val)


def check_path_shapes(device, shapes_by_path, checked, worst):
    """Every kernel bit-exact against its plain version at each shape the
    paths launched it with that phase 2 did not check."""
    import torch
    from groth_sahai_tpu_torch.ops.curve import G1, G2
    from groth_sahai_tpu_torch.ops.fp import FQ, FR
    fields = {F.name: F for F in (FQ, FR, G1, G2)}
    gen = torch.Generator().manual_seed(SEED + 2)
    todo = sorted({key for shapes in shapes_by_path.values()
                   for key in shapes} - checked, key=str)
    for name, field, lanes, e in todo:
        check_shape(name, fields[field], lanes, e, gen, device, worst,
                    "shapes")
        checked.add((name, field, lanes, e))
    return len(todo)


# ------------------------------------------------------------------ phase 3

def host_multiples(count: int):
    """[k G1 for k = 1..count], [k G2 for k = 1..count] by repeated addition."""
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    g1 = (H.C.G1_GEN_X, H.C.G1_GEN_Y)
    g2 = (H.C.G2_GEN_X, H.C.G2_GEN_Y)
    p1, p2 = [g1], [g2]
    for _ in range(count - 1):
        p1.append(H.g1_add(p1[-1], g1))
        p2.append(H.g2_add(p2[-1], g2))
    return p1, p2


def gt_power(e: int):
    """e(G1, G2)^e on the host, in the port's Fq12 int layout."""
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    return H.f12_pow(H.pairing_gen(), e % H.R)


def pairing_inputs(n: int, mult1, mult2, rng):
    """Scalars a_i, b_i (0 = infinity) and the affine point lists."""
    a = list(range(1, n + 1))
    b = list(range(1, n + 1))
    rng.shuffle(b)
    for lane in (3, n // 2):                 # infinity P
        a[lane] = 0
    for lane in (n // 3, n - 2):             # infinity Q
        b[lane] = 0
    a[n - 1] = b[n - 1] = 0                  # infinity on both sides
    P = [None if k == 0 else mult1[k - 1] for k in a]
    Q = [None if k == 0 else mult2[k - 1] for k in b]
    return a, b, P, Q


def run_pairing(path, n, device, mult1, mult2, rng, shapes):
    """pairing-8192 and pairing-4096: `pairing(P, Q)` over n pairs (and, at
    n <= 4096, `FQ12.cyclotomic_sqr` of the outputs, inside the counted
    run, whose launch shapes go to `shapes`). Returns (counts, seconds,
    checks seconds, inputs, outputs)."""
    import torch
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_from_ints,
                                                 g2_affine_from_ints)
    from groth_sahai_tpu_torch.ops.pairing import pairing, _product_reduce
    from groth_sahai_tpu_torch.ops.tower import FQ12, FUSED_MAX_LANES
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    a, b, P_pts, Q_pts = pairing_inputs(n, mult1, mult2, rng)
    P = g1_affine_from_ints(P_pts, device=device)
    Q = g2_affine_from_ints(Q_pts, device=device)
    sync()

    reset_counts()
    reset_peak()
    with recording(shapes):
        t0 = time.perf_counter()
        e = pairing(P, Q)
        sync()
        secs = time.perf_counter() - t0
        csq = FQ12.cyclotomic_sqr(e) if n <= FUSED_MAX_LANES else None
        sync()
    counts, peak = read_counts(), peak_gib()

    t0 = time.perf_counter()
    if tuple(e.shape) != (25, 12, n):
        raise AssertionError(f"{path}: output shape {tuple(e.shape)}")
    sample = [0, 3, n // 3, n - 1] + rng.sample(range(n), 6)
    got = FQ12.to_ints(e[:, :, torch.as_tensor(sample, device=device)])
    for lane, g in zip(sample, got):
        if g != H.pairing(P_pts[lane], Q_pts[lane]):
            raise AssertionError(f"{path}: lane {lane} differs from the host")
    total = FQ12.to_ints(_product_reduce(e, axis=0))[0]
    if total != gt_power(sum(x * y for x, y in zip(a, b))):
        raise AssertionError(f"{path}: GT product of all lanes is wrong")
    extra = ""
    if csq is not None:
        if not bool(FQ12.eq(csq, FQ12.sqr(e), k=2).all()):
            raise AssertionError(f"{path}: cyclotomic_sqr differs from sqr")
        extra = "; cyclotomic_sqr of all lanes equals sqr"
    print(f"[{path}] {n} pairs: {secs:.3f} s on the card, peak "
          f"{peak:.2f} GiB; lanes {sample} match the host; GT product "
          f"of all lanes matches{extra}", flush=True)
    return counts, secs, time.perf_counter() - t0, (P, Q), (e, a, b)


def signed_inputs(k, mult1, mult2, rng, device):
    """Com vectors (2, k) of random multiples, a few at infinity."""
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_from_ints,
                                                 g2_affine_from_ints)
    sa = [[rng.randrange(1, len(mult1) + 1) for _ in range(k)]
          for _ in range(2)]
    sb = [[rng.randrange(1, len(mult2) + 1) for _ in range(k)]
          for _ in range(2)]
    sa[0][k // 2] = 0                              # infinity commitments
    sb[1][k // 3] = 0

    def com(pts_of, scal, from_ints):
        flat_pts = [None if v == 0 else pts_of[v - 1]
                    for row in scal for v in row]
        x, y, inf = from_ints(flat_pts, device=device)
        shape = lambda t: t.reshape(t.shape[:-1] + (2, k))
        return (shape(x), shape(y), inf.reshape(2, k))

    return (com(mult1, sa, g1_affine_from_ints),
            com(mult2, sb, g2_affine_from_ints), sa, sb)


def run_signed(path, k, mask, device, mult1, mult2, rng, shapes):
    """signed-2048 and signed-1024: `miller_product_signed` + `final_exp`
    (launch shapes to `shapes`); each (i, j) entry against
    e(G1, G2)^(sum_k +-a_ik b_jk), and the whole (2, 2) result through
    `comt_eq` against the host's entries."""
    from groth_sahai_tpu_torch.models import commit_group as CG
    from groth_sahai_tpu_torch.models import kernels as MK
    from groth_sahai_tpu_torch.ops.tower import FQ12
    com1, com2, sa, sb = signed_inputs(k, mult1, mult2, rng, device)
    sync()

    out, counts, secs, peak = counted(lambda: MK.final_exp(
        MK.miller_product_signed(com1, com2, mask)), shapes)

    t0 = time.perf_counter()
    if tuple(out.shape) != (25, 12, 2, 2):
        raise AssertionError(f"{path}: shape {tuple(out.shape)}")
    got = FQ12.to_ints(out.reshape(25, 12, 4))
    want = [gt_power(sum((-1 if mask[q] else 1) * sa[i][q] * sb[j][q]
                         for q in range(k)))
            for i in range(2) for j in range(2)]
    for ij, (g, w) in enumerate(zip(got, want)):
        if g != w:
            raise AssertionError(f"{path}: entry {divmod(ij, 2)} is wrong")
    host = FQ12.from_ints(want, device=out.device).reshape(25, 12, 2, 2)
    if not bool(CG.comt_eq(out, host)):
        raise AssertionError(f"{path}: comt_eq against the host is false")
    changed = FQ12.from_ints(want[:3] + [want[0]], device=out.device)
    if bool(CG.comt_eq(out, changed.reshape(25, 12, 2, 2))):
        raise AssertionError(f"{path}: comt_eq holds on a changed entry")
    print(f"[{path}] Kp={MK.next_pow2(k)} (K={k}): {secs:.3f} s on the "
          f"card, peak {peak:.2f} GiB; all four entries match the host; "
          f"comt_eq true, and false with one entry changed", flush=True)
    return counts, secs, time.perf_counter() - t0, (com1, com2, mask)


def run_gt_exp(device, pair_out, rng, shapes):
    """gt-exp-4096: `gt_exp` on (1024, 2, 2) with one 255-bit rho per
    equation broadcast over (2, 2) (batch.py:206), then on (1024) lanes
    (batch.py:210). Part 1's bases are pairing-4096's GT outputs; part 2's
    are those of lanes 0..1023 with raw Miller outputs (not in GT, as the
    batch verifier's ratios are not) in eight lanes. Launch shapes go to
    `shapes`."""
    import torch
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.fp import FR
    from groth_sahai_tpu_torch.ops.pairing import gt_exp, _product_reduce
    from groth_sahai_tpu_torch.ops.tower import FQ12
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    e, a, b = pair_out
    n = EQUATIONS
    rho = [rng.getrandbits(255) for _ in range(n)]
    rho_t = edge_limbs(rho, FR.n, device)
    base1 = e.reshape(25, 12, n, 2, 2)
    g1 = (C.G1_GEN_X, C.G1_GEN_Y)
    g2 = (C.G2_GEN_X, C.G2_GEN_Y)
    raw_lanes = list(range(0, n, max(1, n // 8)))
    raw = [H.miller_loop(H.g1_mul(g1, 3 + i), H.g2_mul(g2, 5 + i))
           for i in range(len(raw_lanes))]
    base2 = e[:, :, :n].clone()
    base2[:, :, raw_lanes] = FQ12.from_ints(raw, device=device)
    sync()

    (out1, out2), counts, secs, peak = counted(lambda: (
        gt_exp(base1, rho_t.reshape(FR.n, n, 1, 1)), gt_exp(base2, rho_t)),
        shapes)

    t0 = time.perf_counter()
    if tuple(out1.shape) != (25, 12, n, 2, 2) or \
            tuple(out2.shape) != (25, 12, n):
        raise AssertionError("gt-exp-4096: output shapes")
    total = FQ12.to_ints(_product_reduce(out1.reshape(25, 12, 4 * n)))[0]
    ex = sum(x * y * rho[i // 4] for i, (x, y) in enumerate(zip(a, b)))
    if total != gt_power(ex):
        raise AssertionError("gt-exp-4096: the product of all (n, 2, 2) "
                             "lanes is wrong")
    sample = raw_lanes + [1, n - 1] + rng.sample(range(n), 4)
    bases = FQ12.to_ints(base2[:, :, sample])
    got = FQ12.to_ints(out2[:, :, sample])
    for lane, bv, g in zip(sample, bases, got):
        if g != H.f12_pow(bv, rho[lane]):
            raise AssertionError(f"gt-exp-4096: lane {lane} of the ({n}) "
                                 f"call differs from the host")
    print(f"[gt-exp-4096] ({n}, 2, 2) and ({n}): {secs:.3f} s on the "
          f"card, peak {peak:.2f} GiB; product of all {4 * n} lanes matches; "
          f"lanes {sample} (raw "
          f"Miller outputs at {raw_lanes}) match the host", flush=True)
    return counts, secs, time.perf_counter() - t0, (base1, base2, rho_t)


# ------------------------------------------------------- phase 3: GS paths

def fr_limbs(values, device):
    """Standard-form Fr limbs int64[17, len(values)]."""
    from groth_sahai_tpu_torch.ops.fp import FR
    return edge_limbs([v % FR.p for v in values], FR.n, device)


def crs_logs(seed: int):
    """The discrete logs, base G1 and G2, of generate_crs(GsRng(seed))'s
    keys, from its first six draws (r1, r2, a1, a2, t1, t2): u[c][j] of
    G1 and v[c][j] of G2 for component c and element j ([[p, u], [q, v]],
    binding), and the GsRng left after those draws."""
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.utils.rng import GsRng
    twin = GsRng(seed)
    r1, r2, a1, a2, t1, t2 = twin.fr_ints(6)
    key = lambda r, a, t: ((r, t * r % C.R), (a * r % C.R, t * a * r % C.R))
    return key(r1, a1, t1), key(r2, a2, t2), twin


def run_commit(path, device, logs, rng, shapes):
    """The four commit paths of M_COMMIT variables through `batch_commit_*`
    with GsRng draws; every commitment against its discrete log on the
    host: iota(X) + r1 u1 + r2 u2 for a group side, x (u2 + (O, g)) + r u1
    for a scalar side (u = v for G2). Returns (counts, seconds, checks
    seconds, a callable re-running the path)."""
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_from_ints,
                                                 g1_affine_to_ints,
                                                 g2_affine_from_ints,
                                                 g2_affine_to_ints)
    from groth_sahai_tpu_torch.models import prover as PV
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    from groth_sahai_tpu_torch.utils.rng import GsRng
    crs, (k1, k2), seed = logs
    g2 = path.endswith(("g2-334", "b2-334"))
    scalar = "scalar" in path
    gen = (C.G2_GEN_X, C.G2_GEN_Y) if g2 else (C.G1_GEN_X, C.G1_GEN_Y)
    mul = H.g2_mul if g2 else H.g1_mul
    key = k2 if g2 else k1
    m = M_COMMIT
    xs = [rng.randrange(C.R) for _ in range(m)]
    xs[m // 2] = 0                          # a variable at infinity / zero
    if scalar:
        fn = PV.batch_commit_scalar_B2 if g2 else PV.batch_commit_scalar_B1
        args = (fr_limbs(xs, device),)
    else:
        fn = PV.batch_commit_G2 if g2 else PV.batch_commit_G1
        from_ints = g2_affine_from_ints if g2 else g1_affine_from_ints
        args = (from_ints([mul(gen, x) for x in xs], device=device),)
    sync()

    def run():
        return fn(*args, crs, GsRng(seed))

    com, counts, secs, peak = counted(run, shapes)

    t0 = time.perf_counter()
    x, _, inf = com.coms
    if tuple(inf.shape) != (2, m):
        raise AssertionError(f"{path}: commitments of shape {tuple(inf.shape)}")
    w = 1 if scalar else 2
    r = GsRng(seed).fr_ints(m * w)
    if scalar:      # x (u2 + (O, g)) + r u1; (O, g) = (O, p) with g = p
        logs_of = lambda i: ((xs[i] * key[0][1] + r[i] * key[0][0]),
                             (xs[i] * (key[1][1] + key[0][0])
                              + r[i] * key[1][0]))
    else:           # iota(X) + r1 u1 + r2 u2
        logs_of = lambda i: ((r[2 * i] * key[0][0] + r[2 * i + 1] * key[0][1]),
                             (xs[i] + r[2 * i] * key[1][0]
                              + r[2 * i + 1] * key[1][1]))
    got = (g2_affine_to_ints if g2 else g1_affine_to_ints)(com.coms)
    for i in range(m):
        for c, e in enumerate(logs_of(i)):
            if got[c * m + i] != mul(gen, e % C.R):
                raise AssertionError(f"{path}: commitment {i}, component {c} "
                                     f"differs from the host")
    print(f"[{path}] {m} commitments ({2 * m * w} Fr draws): {secs:.3f} s "
          f"on the card, peak {peak:.2f} GiB; all {2 * m} points match the "
          f"host", flush=True)
    return counts, secs, time.perf_counter() - t0, run


def run_scalar_mul(device, mult1, rng, shapes):
    """scalar-mul-g1-4096: `G1.scalar_mul` of SCALAR_LANES points a_i G1
    by random scalars; edge lanes: scalars 0, 1, r - 1, 2^254 - 1 (every
    nibble 15 but the top one), a point at infinity. 512 seeded lanes and
    the edges against the host, and the sum of all lanes against
    (sum a_i s_i) G1."""
    import torch
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.curve import (G1, g1_affine_from_ints,
                                                 g1_affine_to_ints)
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    n = SCALAR_LANES
    a = [rng.randrange(1, len(mult1) + 1) for _ in range(n)]
    sc = [rng.randrange(C.R) for _ in range(n)]
    sc[:4] = [0, 1, C.R - 1, (1 << 254) - 1]
    a[4] = 0
    pts = g1_affine_from_ints([None if k == 0 else mult1[k - 1] for k in a],
                              device=device)
    s = fr_limbs(sc, device)
    sync()

    def run():
        return G1.scalar_mul(pts, s)

    out, counts, secs, peak = counted(run, shapes)
    t0 = time.perf_counter()
    g1 = (C.G1_GEN_X, C.G1_GEN_Y)
    lanes = list(range(5)) + sorted(rng.sample(range(5, n), min(512, n - 5)))
    idx = torch.as_tensor(lanes, device=device)
    got = g1_affine_to_ints(G1.to_affine(tuple(c[:, idx] for c in out)))
    for lane, g in zip(lanes, got):
        if g != H.g1_mul(g1, a[lane] * sc[lane]):
            raise AssertionError(f"scalar-mul-g1-4096: lane {lane} differs "
                                 f"from the host")
    total = g1_affine_to_ints(G1.to_affine(tuple(
        c[:, None] for c in G1.sum_reduce(out, 0))))[0]
    if total != H.g1_mul(g1, sum(x * y for x, y in zip(a, sc))):
        raise AssertionError("scalar-mul-g1-4096: the sum of all lanes is "
                             "wrong")
    print(f"[scalar-mul-g1-4096] {n} points: {secs:.3f} s on the card, peak "
          f"{peak:.2f} GiB; {len(lanes)} lanes (edges 0..4) and the sum of "
          f"all lanes match the host", flush=True)
    return counts, secs, time.perf_counter() - t0, run


def e2e_cases(crs, device):
    """The four equations of tests/test_gs_e2e.py (the reference's
    tests/prover.rs scenarios) over the CRS's generators g1 = p1, g2 = p2,
    with their targets from discrete logs (gt = e(p1, p2)) and a wrong
    target each: [(name, statement, wrong statement, X, Y)]."""
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_from_ints,
                                                 g1_affine_to_ints,
                                                 g2_affine_from_ints,
                                                 g2_affine_to_ints)
    from groth_sahai_tpu_torch.ops.fp import FR
    from groth_sahai_tpu_torch.ops.tower import FQ12
    from groth_sahai_tpu_torch.models import statement as ST
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    g1 = g1_affine_to_ints(crs.g1_gen)[0]
    g2 = g2_affine_to_ints(crs.g2_gen)[0]
    gt = FQ12.to_ints(crs.gt_gen[:, :, None])[0]
    G1s = lambda ks: g1_affine_from_ints([None if k is None else
                                          H.g1_mul(g1, k) for k in ks],
                                         device=device)
    G2s = lambda ks: g2_affine_from_ints([None if k is None else
                                          H.g2_mul(g2, k) for k in ks],
                                         device=device)
    G1pt = lambda k: tuple(c[..., 0] for c in G1s([k]))
    G2pt = lambda k: tuple(c[..., 0] for c in G2s([k]))
    frs = lambda vs: fr_limbs(vs, device)
    gamma = frs([5, 0]).reshape(FR.n, 2, 1)
    gtp = lambda e: FQ12.from_ints([H.f12_pow(gt, e)], device=device)[:, :, 0]
    # X = [2, 3], Y = [4] (group or scalar); Gamma = [[5], [0]]
    ppe = 3 * 23 + 17 * 4 + 2 * 4 * 5
    msm1 = 3 * 31 + 29 * 4 + 2 * 4 * 5
    msm2 = 3 * 41 + 37 * 4 + 2 * 4 * 5
    quad = 3 * 47 + 43 * 4 + 2 * 4 * 5
    return [
        ("PPE", lambda t: ST.PPE(G1s([17]), G2s([None, 23]), gamma, gtp(t)),
         ppe, G1s([2, 3]), G2s([4])),
        ("MSMEG1", lambda t: ST.MSMEG1(G1s([29]), frs([0, 31]), gamma,
                                        G1pt(t)), msm1, G1s([2, 3]), frs([4])),
        ("MSMEG2", lambda t: ST.MSMEG2(frs([37]), G2s([None, 41]), gamma,
                                        G2pt(t)), msm2, frs([2, 3]), G2s([4])),
        ("QuadEqu", lambda t: ST.QuadEqu(frs([43]), frs([0, 47]), gamma,
                                          frs([t])[:, 0]),
         quad, frs([2, 3]), frs([4])),
    ]


def run_e2e(device, shapes):
    """gs-e2e: generate_crs, then for each of the four equations
    commit_and_prove and verify (must hold), and verify with target + 1
    (must fail)."""
    from groth_sahai_tpu_torch.models.crs import generate_crs
    from groth_sahai_tpu_torch.models.prover import commit_and_prove
    from groth_sahai_tpu_torch.models.verifier import verify
    from groth_sahai_tpu_torch.utils.rng import GsRng

    def run():
        crs = generate_crs(GsRng(SEED + 20), device=device)
        cases = e2e_cases(crs, device)
        sync()
        out = []
        for k, (name, make, t, X, Y) in enumerate(cases):
            proof = commit_and_prove(make(t), X, Y, crs, GsRng(SEED + 21 + k))
            out.append((name, verify(make(t), proof, crs),
                        verify(make(t + 1), proof, crs)))
        return out

    out, counts, secs, peak = counted(run, shapes)
    t0 = time.perf_counter()
    for name, good, bad in out:
        if not good or bad:
            raise AssertionError(f"gs-e2e: {name} verifies {good}, with a "
                                 f"wrong target {bad}")
    print(f"[gs-e2e] {', '.join(n for n, _, _ in out)}: {secs:.3f} s with "
          f"the host's CRS and targets, peak {peak:.2f} GiB; each verifies, "
          f"and fails with a wrong target", flush=True)
    return counts, secs, time.perf_counter() - t0, run


def run_ppe_8x8(device, rng, shapes):
    """prove-verify-ppe-8x8: a PPE with m = n = PPE_SIDE over random
    discrete logs (X_i = x_i p1, Y_j = y_j p2, A_j, B_i likewise, random
    Gamma), target gt^(sum x_i b_i + sum a_j y_j + sum Gamma_ij x_i y_j);
    commit_and_prove, verify (must hold), then verify with pi's first
    element replaced by p2 (must fail). Returns (counts, seconds, 0,
    the run, (statement, honest proof, CRS))."""
    import dataclasses
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_from_ints,
                                                 g1_affine_to_ints,
                                                 g2_affine_from_ints,
                                                 g2_affine_to_ints)
    from groth_sahai_tpu_torch.ops.fp import FR
    from groth_sahai_tpu_torch.ops.tower import FQ12
    from groth_sahai_tpu_torch.models import statement as ST
    from groth_sahai_tpu_torch.models.crs import generate_crs
    from groth_sahai_tpu_torch.models.prover import commit_and_prove
    from groth_sahai_tpu_torch.models.verifier import verify
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    from groth_sahai_tpu_torch.utils.rng import GsRng
    m = n = PPE_SIDE
    crs = generate_crs(GsRng(SEED + 30), device=device)
    g1 = g1_affine_to_ints(crs.g1_gen)[0]
    g2 = g2_affine_to_ints(crs.g2_gen)[0]
    gt = FQ12.to_ints(crs.gt_gen[:, :, None])[0]
    x, b = ([rng.randrange(C.R) for _ in range(m)] for _ in range(2))
    y, a = ([rng.randrange(C.R) for _ in range(n)] for _ in range(2))
    gam = [[rng.randrange(C.R) for _ in range(n)] for _ in range(m)]
    e = (sum(xi * bi for xi, bi in zip(x, b))
         + sum(aj * yj for aj, yj in zip(a, y))
         + sum(gam[i][j] * x[i] * y[j] for i in range(m) for j in range(n)))
    G1s = lambda ks: g1_affine_from_ints([H.g1_mul(g1, k) for k in ks],
                                         device=device)
    G2s = lambda ks: g2_affine_from_ints([H.g2_mul(g2, k) for k in ks],
                                         device=device)
    equ = ST.PPE(G1s(a), G2s(b), fr_limbs(sum(gam, []), device).reshape(
        FR.n, m, n), FQ12.from_ints([H.f12_pow(gt, e % C.R)],
                                    device=device)[:, :, 0])
    X, Y = G1s(x), G2s(y)
    sync()
    made = {}

    def run():
        proof = commit_and_prove(equ, X, Y, crs, GsRng(SEED + 31))
        good = verify(equ, proof, crs)
        ep = proof.equ_proofs[0]
        bad_pi = tuple(c.clone() for c in ep.pi)
        for c in range(3):                   # pi[0][0] <- p2 = crs.v[0][0]
            bad_pi[c][..., 0, 0] = crs.v[c][..., 0, 0]
        made["proof"] = proof
        return good, verify(equ, dataclasses.replace(proof, equ_proofs=[
            dataclasses.replace(ep, pi=bad_pi)]), crs)

    (good, bad), counts, secs, peak = counted(run, shapes)
    if not good or bad:
        raise AssertionError(f"prove-verify-ppe-8x8: verifies {good}, with "
                             f"pi changed {bad}")
    print(f"[prove-verify-ppe-8x8] m = n = {m} (K = {n + 2 * m + 4} Miller "
          f"pairs): {secs:.3f} s, peak {peak:.2f} GiB; verifies, and fails "
          f"with pi changed", flush=True)
    return counts, secs, 0.0, run, (equ, made["proof"], crs)


# ---------------------------------------------------- phase 3: MSM paths

def run_msm_g1(device, mult1, rng, shapes):
    """msm-g1-65536: `msm(G1, ...)` over MSM_POINTS points a_i G1 (a_i
    drawn from 1..len(mult1), so many repeat; three at infinity) with
    seeded Fr scalars and the edges 0, 1, r - 1 (window 13 at 65536
    points); against (sum s_i a_i mod r) G1, one host multiplication."""
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.curve import (G1, g1_affine_from_ints,
                                                 g1_affine_to_ints)
    from groth_sahai_tpu_torch.ops.msm import msm
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    n = MSM_POINTS
    a = [rng.randrange(1, len(mult1) + 1) for _ in range(n)]
    for lane in (7, n // 2, n - 1):
        a[lane] = 0
    sc = [rng.randrange(C.R) for _ in range(n)]
    sc[:3] = [0, 1, C.R - 1]
    pts = g1_affine_from_ints([None if k == 0 else mult1[k - 1] for k in a],
                              device=device)
    s = fr_limbs(sc, device)
    sync()

    def run():
        return msm(G1, pts, s)

    out, counts, secs, peak = counted(run, shapes)
    t0 = time.perf_counter()
    got = g1_affine_to_ints(G1.to_affine(tuple(c[..., None] for c in out)))
    want = H.g1_mul((C.G1_GEN_X, C.G1_GEN_Y),
                    sum(x * y for x, y in zip(a, sc)) % C.R)
    if got != [want]:
        raise AssertionError("msm-g1-65536: the MSM differs from the host")
    window, width, rows = msm_geometry(n)[:3]
    print(f"[msm-g1-65536] {n} points, window {window}, {width} lanes x "
          f"{rows} rows: {secs:.3f} s on the card, peak {peak:.2f} GiB; "
          f"matches (sum s_i a_i) G1 on the host", flush=True)
    return counts, secs, time.perf_counter() - t0, run, (pts, s, got[0])


def ppe_334(device, mult1, mult2, rng, m=PPE_M, n=PPE_M):
    """The statement of prove-ppe-334 and verify-ppe-334, shaped as the
    reference's make_ppe(m, n) (benches/suite.py; m = n = PPE_M here,
    m = 2, n = 1 for batch-verify-ppe-1024): X_i = x_i G1,
    Y_j = y_j G2, A_j = a_j G1, B_i = b_i G2 with discrete logs drawn from
    1..len(mult), a random Gamma (m x n), and the target from the logs
    alone: t = e(G1, G2)^(sum x_i b_i + sum a_j y_j + sum Gamma_ij x_i
    y_j). Returns (statement, the statement with target t e(G1, G2), X, Y,
    logs (x, y, a, b, Gamma))."""
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_from_ints,
                                                 g2_affine_from_ints)
    from groth_sahai_tpu_torch.ops.fp import FR
    from groth_sahai_tpu_torch.ops.tower import FQ12
    from groth_sahai_tpu_torch.models import statement as ST
    draw = lambda mult, k: [rng.randrange(1, len(mult) + 1) for _ in range(k)]
    x, a = draw(mult1, m), draw(mult1, n)
    y, b = draw(mult2, n), draw(mult2, m)
    gam = [[rng.randrange(C.R) for _ in range(n)] for _ in range(m)]
    e = (sum(xi * bi for xi, bi in zip(x, b))
         + sum(aj * yj for aj, yj in zip(a, y))
         + sum(x[i] * sum(g * yj for g, yj in zip(gam[i], y))
               for i in range(m)))
    G1s = lambda ks: g1_affine_from_ints([mult1[k - 1] for k in ks],
                                         device=device)
    G2s = lambda ks: g2_affine_from_ints([mult2[k - 1] for k in ks],
                                         device=device)
    gamma = fr_limbs(sum(gam, []), device).reshape(FR.n, m, n)
    target = lambda v: FQ12.from_ints([gt_power(v)], device=device)[:, :, 0]
    A, B = G1s(a), G2s(b)
    return (ST.PPE(A, B, gamma, target(e)), ST.PPE(A, B, gamma, target(e + 1)),
            G1s(x), G2s(y), (x, y, a, b, gam))


def draws_334(seed: int):
    """The prover's GsRng draws, replayed: R (m x 2) of the X commitments,
    S (n x 2) of the Y commitments, T (2 x 2) of the proof, row-major."""
    from groth_sahai_tpu_torch.utils.rng import GsRng
    twin = GsRng(seed)
    rows = lambda v, k: [v[i * k:(i + 1) * k] for i in range(len(v) // k)]
    return (rows(twin.fr_ints(2 * PPE_M), 2), rows(twin.fr_ints(2 * PPE_M), 2),
            rows(twin.fr_ints(4), 2))


def run_prove_334(device, crs, keys, stmt, rng, shapes):
    """prove-ppe-334: `commit_and_prove` of the PPE of `ppe_334`. pi and
    theta against their discrete logs on the host, from the replayed draws
    and the CRS's logs:
      pi[k]    = sum_i R_ik (O, B_i) + sum_j (R^T Gamma)_kj (O, Y_j)
                 + sum_l (R^T Gamma S - T^T)_kl v_l,
      theta[l] = sum_j S_jl (O, A_j) + sum_i (S^T Gamma^T)_li (O, X_i)
                 + sum_k T_lk u_k;
    and a seeded sample of 16 commitments of each side (both components).
    Returns (counts, seconds, checks seconds, a re-run, the proof)."""
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_to_ints,
                                                 g2_affine_to_ints)
    from groth_sahai_tpu_torch.models.prover import commit_and_prove
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    from groth_sahai_tpu_torch.utils.rng import GsRng
    equ, _, X, Y, (x, y, a, b, gam) = stmt
    k1, k2 = keys
    seed = SEED + 40
    m = n = PPE_M
    sync()

    def run():
        return commit_and_prove(equ, X, Y, crs, GsRng(seed))

    proof, counts, secs, peak = counted(run, shapes)
    t0 = time.perf_counter()
    r = C.R
    Rm, Sm, Tm = draws_334(seed)
    rg = [[sum(Rm[i][k] * gam[i][j] for i in range(m)) % r for j in range(n)]
          for k in range(2)]
    pf = [[(sum(rg[k][j] * Sm[j][l] for j in range(n)) - Tm[l][k]) % r
           for l in range(2)] for k in range(2)]
    sg = [[sum(Sm[j][l] * gam[i][j] for j in range(n)) % r for i in range(m)]
          for l in range(2)]
    pi_log = lambda c, k: (c * (sum(Rm[i][k] * b[i] for i in range(m))
                                + sum(rg[k][j] * y[j] for j in range(n)))
                           + sum(pf[k][l] * k2[c][l] for l in range(2)))
    th_log = lambda c, l: (c * (sum(Sm[j][l] * a[j] for j in range(n))
                                + sum(sg[l][i] * x[i] for i in range(m)))
                           + sum(Tm[l][k] * k1[c][k] for k in range(2)))
    g1 = (C.G1_GEN_X, C.G1_GEN_Y)
    g2 = (C.G2_GEN_X, C.G2_GEN_Y)
    ep = proof.equ_proofs[0]
    checks = [("pi", g2_affine_to_ints(ep.pi), H.g2_mul, g2, pi_log, 2),
              ("theta", g1_affine_to_ints(ep.theta), H.g1_mul, g1, th_log, 2)]
    sample = sorted(rng.sample(range(m), min(16, m)))
    com_log = lambda logs, key, vs: lambda c, i: (
        c * vs[i] + logs[i][0] * key[c][0] + logs[i][1] * key[c][1])
    checks += [("X commitments", g1_affine_to_ints(proof.xcoms.coms),
                H.g1_mul, g1, com_log(Rm, k1, x), m),
               ("Y commitments", g2_affine_to_ints(proof.ycoms.coms),
                H.g2_mul, g2, com_log(Sm, k2, y), n)]
    for what, got, mul, gen, log, width in checks:
        for c in range(2):
            for k in (sample if width == m else range(width)):
                if got[c * width + k] != mul(gen, log(c, k) % r):
                    raise AssertionError(f"prove-ppe-334: {what} [{c}][{k}] "
                                         f"differs from the host")
    print(f"[prove-ppe-334] m = n = {m}: {secs:.3f} s on the card, peak "
          f"{peak:.2f} GiB; pi, theta and commitments {sample} of X and Y "
          f"match their discrete logs", flush=True)
    return counts, secs, time.perf_counter() - t0, run, proof


def run_verify_334(device, crs, keys, stmt, proof, shapes):
    """verify-ppe-334: `verify` three times: the honest proof (True), pi's
    first element replaced by p2 = v[0][0] (False), a wrong target
    (False). Then Gamma d, the verifier's 2 m MSMs of the Y commitments
    (padded to 512 points), entry by entry against its discrete log:
    (Gamma d)[c][i] = sum_j Gamma_ij log(d_j[c]), log(d_j[c]) =
    c y_j + S_j0 v[c][0] + S_j1 v[c][1]."""
    import dataclasses
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.curve import G2, g2_affine_to_ints
    from groth_sahai_tpu_torch.models import kernels as MK
    from groth_sahai_tpu_torch.models.verifier import verify
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    equ, wrong, _, _, (x, y, a, b, gam) = stmt
    _, k2 = keys
    m = n = PPE_M
    ep = proof.equ_proofs[0]
    bad_pi = tuple(c.clone() for c in ep.pi)
    for c in range(3):
        bad_pi[c][..., 0, 0] = crs.v[c][..., 0, 0]
    changed = dataclasses.replace(proof, equ_proofs=[
        dataclasses.replace(ep, pi=bad_pi)])
    sync()

    def run():
        return (verify(equ, proof, crs), verify(equ, changed, crs),
                verify(wrong, proof, crs))

    (good, bad, wrong_t), counts, secs, peak = counted(run, shapes)
    if (good, bad, wrong_t) != (True, False, False):
        raise AssertionError(f"verify-ppe-334: verifies {good}, with pi "
                             f"changed {bad}, with a wrong target {wrong_t}")
    t0 = time.perf_counter()
    gd = g2_affine_to_ints(MK.to_affine(G2, MK.com_matvec(
        G2, equ.gamma, proof.ycoms.coms)))
    Sm = draws_334(SEED + 40)[1]
    d_log = [[c * y[j] + Sm[j][0] * k2[c][0] + Sm[j][1] * k2[c][1]
              for j in range(n)] for c in range(2)]
    g2 = (C.G2_GEN_X, C.G2_GEN_Y)
    for c in range(2):
        for i in range(m):
            log = sum(g * d for g, d in zip(gam[i], d_log[c])) % C.R
            if gd[c * m + i] != H.g2_mul(g2, log):
                raise AssertionError(f"verify-ppe-334: (Gamma d)[{c}][{i}] "
                                     f"differs from the host")
    print(f"[verify-ppe-334] m = n = {m} (K = {n + 2 * m + 4} Miller pairs), "
          f"three verifies: {secs:.3f} s on the card, peak {peak:.2f} GiB; "
          f"True, False with pi changed, False with a wrong target; all "
          f"{2 * m} entries of Gamma d match their discrete logs", flush=True)
    return counts, secs, time.perf_counter() - t0, run


def run_miller_steps(device, mult2, rng, shapes):
    """miller-steps-4096: the point schedule of one Miller loop (63
    doubling steps, an addition step on each of the 5 set bits of |x|
    after the first) through the step entry points `miller_dbl_step` and
    `miller_add_step` over STEP_LANES points Q_i = b_i G2, from R = (xQ,
    yQ, 1); the final R = |x| Q and the last lines of each kind on sampled
    lanes against the host's twin of the schedule (hostcrypto._dbl_step,
    _add_step), values mod p."""
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops import cuda_tower as CT
    from groth_sahai_tpu_torch.ops.curve import g2_affine_from_ints
    from groth_sahai_tpu_torch.ops.fp import FQ
    from groth_sahai_tpu_torch.ops.tower import FQ2
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    n = STEP_LANES
    qs = [mult2[rng.randrange(len(mult2))] for _ in range(n)]
    Q = g2_affine_from_ints(qs, device=device)
    bits = [int(c) for c in bin(abs(C.X))[3:]]
    two_inv = (FQ.p + 1) // 2
    sync()

    def run(steps=CT):
        R = (Q[0], Q[1], FQ2.one((n,), device=device))
        last = {}
        for bit in bits:
            R, last["dbl"] = steps.miller_dbl_step(R, two_inv)
            if bit:
                R, last["add"] = steps.miller_add_step(R, Q[:2])
        return R, last

    (R, last), counts, secs, peak = counted(run, shapes, module=CT)
    t0 = time.perf_counter()
    sample = [0, n - 1] + rng.sample(range(1, n - 1), 6)
    vals = lambda t: [tuple(c % FQ.p for c in v)
                      for v in FQ2.to_ints(t[..., sample])]
    got_R = [vals(c) for c in R]
    got_l = {k: [vals(c) for c in v] for k, v in last.items()}
    for s_i, lane in enumerate(sample):
        q = qs[lane]
        Rp, want = (q[0], q[1], (1, 0)), {}
        for bit in bits:
            Rp, want["dbl"] = H._dbl_step(Rp)
            if bit:
                Rp, want["add"] = H._add_step(Rp, q)
        ok = all(got_R[c][s_i] == Rp[c] for c in range(3)) and all(
            got_l[k][c][s_i] == want[k][c] for k in want for c in range(3))
        if not ok:
            raise AssertionError(f"miller-steps-4096: lane {lane} differs "
                                 f"from the host's schedule")
    print(f"[miller-steps-4096] {n} lanes, {len(bits)} doubling and "
          f"{sum(bits)} addition steps: {secs:.3f} s on the card, peak "
          f"{peak:.2f} GiB; R and the last lines of lanes {sample} match the "
          f"host", flush=True)
    return counts, secs, time.perf_counter() - t0, run


def run_batch_verify(device, crs, mult1, mult2, rng, shapes):
    """batch-verify-ppe-1024: the reference's batch_verify_randomized_1024
    row (benches/suite.py): EQUATIONS slots of one make_ppe(2, 1)
    statement (K = 9 Miller pairs, padded to 16), slot b holding proof
    b mod n of n distinct proofs from commit_and_prove(..., GsRng(6 + i))
    (at least MIN_PROOFS, and as many more as PROOF_SECONDS of the card
    make). The counted run: `verify_ppe_batch_randomized` of all slots
    (True), the same with slot BAD_SLOT's pi taken from another proof
    (False), and `verify_ppe_batch` of those (True but at BAD_SLOT). Then
    eight slots (BAD_SLOT among them) against `verify` of their proof
    alone, four of the last batch's ratios limb for limb against
    `miller_product_signed` of the batch's pairs of that slot, every
    tower launch at most FUSED lanes wide, and eight proofs and the CRS
    through the wire format (validated) and back. Returns (counts,
    seconds, checks seconds, the run, (equations, slots, slots with
    BAD_SLOT changed, CRS, the three results))."""
    import dataclasses
    import torch
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_to_ints,
                                                 g2_affine_to_ints)
    from groth_sahai_tpu_torch.models import batch as BT
    from groth_sahai_tpu_torch.models import commit_group as CG
    from groth_sahai_tpu_torch.models import kernels as MK
    from groth_sahai_tpu_torch.models.prover import commit_and_prove
    from groth_sahai_tpu_torch.models.verifier import verify
    from groth_sahai_tpu_torch.ops.curve import G1, G2
    from groth_sahai_tpu_torch.utils import serde as S
    from groth_sahai_tpu_torch.utils.rng import GsRng
    equ, _, X, Y, _ = ppe_334(device, mult1, mult2, rng, m=2, n=1)
    B = EQUATIONS
    t0 = time.perf_counter()
    proofs = []
    while len(proofs) < min(B, MIN_PROOFS) or (
            len(proofs) < B and time.perf_counter() - t0 < PROOF_SECONDS):
        proofs.append(commit_and_prove(equ, X, Y, crs,
                                       GsRng(6 + len(proofs))))
    sync()
    made = time.perf_counter() - t0
    n = len(proofs)
    slots = [proofs[b % n] for b in range(B)]
    bad = list(slots)
    ep = slots[BAD_SLOT].equ_proofs[0]
    bad[BAD_SLOT] = dataclasses.replace(slots[BAD_SLOT], equ_proofs=[
        dataclasses.replace(ep, pi=proofs[(BAD_SLOT + 1) % n]
                            .equ_proofs[0].pi)])
    equs = [equ] * B
    seen = {}

    def run():
        return (BT.verify_ppe_batch_randomized(equs, slots, crs, GsRng(9)),
                BT.verify_ppe_batch_randomized(equs, bad, crs, GsRng(10)),
                BT.verify_ppe_batch(equs, bad, crs))

    real = BT._ratios

    def spy(P, Q, mask):                  # the last batch's pairs and ratios
        seen["pairs"], seen["ratio"] = (P, Q, mask), real(P, Q, mask)
        return seen["ratio"]

    BT._ratios = spy
    try:
        (good, with_bad, verdicts), counts, secs, peak = counted(run, shapes)
    finally:
        BT._ratios = real

    t0 = time.perf_counter()
    want = [b != BAD_SLOT for b in range(B)]
    if good is not True or with_bad is not False or \
            verdicts.tolist() != want:
        raise AssertionError(
            f"batch-verify-ppe-1024: randomized {good}, with slot {BAD_SLOT} "
            f"changed {with_bad}; per-slot verdicts false at "
            f"{[b for b in range(B) if not verdicts[b]]}")
    sample = sorted({BAD_SLOT, 0, B - 1} | set(rng.sample(range(B), min(5, B))))
    for b in sample:
        if verify(equ, bad[b], crs) != bool(verdicts[b]):
            raise AssertionError(f"batch-verify-ppe-1024: slot {b}'s verdict "
                                 f"differs from verify of its proof alone")
    (P, Q, mask), ratio = seen["pairs"], seen["ratio"]
    for b in [BAD_SLOT, 0, B - 1, rng.randrange(B)]:
        Pb = CG.aff_map(G1, P, lambda l: l[:, b, :, 0], lambda f: f[b, :, 0])
        Qb = CG.aff_map(G2, Q, lambda l: l[:, :, b, 0], lambda f: f[b, 0])
        one = MK.miller_product_signed(Pb, Qb, mask.cpu().numpy())
        if not torch.equal(one, ratio[:, :, b]):
            raise AssertionError(f"batch-verify-ppe-1024: slot {b}'s ratio "
                                 f"differs from miller_product_signed")
    wide = {k for k in shapes if k[0] in TOWER and k[2] > FUSED}
    if wide:
        raise AssertionError(f"batch-verify-ppe-1024: tower launches wider "
                             f"than {FUSED} lanes: {sorted(wide)}")
    for p in proofs[:8]:
        blob = S.cproof_to_bytes(p)
        back, off = S.cproof_from_bytes(blob, device=device)
        if off != len(blob) or S.cproof_to_bytes(back) != blob or any(
                to_ints(getattr(back, c).coms) != to_ints(getattr(p, c).coms)
                or not torch.equal(getattr(back, c).rand, getattr(p, c).rand)
                for c, to_ints in (("xcoms", g1_affine_to_ints),
                                   ("ycoms", g2_affine_to_ints))):
            raise AssertionError("batch-verify-ppe-1024: a proof does not "
                                 "come back from its bytes")
    blob = S.crs_to_bytes(crs)
    back, off = S.crs_from_bytes(blob, device=device)
    if off != len(blob) or S.crs_to_bytes(back) != blob or \
            g1_affine_to_ints(back.u_base) != g1_affine_to_ints(crs.u_base) \
            or g2_affine_to_ints(back.v_base) != g2_affine_to_ints(crs.v_base):
        raise AssertionError("batch-verify-ppe-1024: the CRS does not come "
                             "back from its bytes")
    print(f"[batch-verify-ppe-1024] {B} slots over {n} distinct proofs "
          f"({made:.1f} s to make): {secs:.3f} s for the three batches on the "
          f"card, peak {peak:.2f} GiB; randomized True, False with slot "
          f"{BAD_SLOT}'s pi changed; verdicts false only at {BAD_SLOT}; "
          f"slots {sample} equal verify alone; four ratios equal "
          f"miller_product_signed; 8 proofs and the CRS round-trip through "
          f"their bytes", flush=True)
    return counts, secs, time.perf_counter() - t0, run, (
        equs, slots, bad, crs, (good, with_bad, verdicts))


def curve_xs(g2: bool):
    """(x, y) for x = 1, 2, ... (x = (k, 1) on G2): y a square root of
    x^3 + b, or None where there is none (no point of the curve has x)."""
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.utils import serde as S
    p, k = C.P, 0
    while True:
        k += 1
        if g2:
            x = (k, 1)
            sq = ((k * k - 1) % p, 2 * k % p)
            cube = ((sq[0] * k - sq[1]) % p, (sq[0] + sq[1] * k) % p)
            yield x, S._sqrt_fq2(((cube[0] + C.B_G2[0]) % p,
                                  (cube[1] + C.B_G2[1]) % p))
        else:
            yield k, S._sqrt_fq((pow(k, 3, p) + C.B_G1) % p)


def off_curve_x(g2: bool):
    return next(x for x, y in curve_xs(g2) if y is None)


def outside_subgroup(g2: bool):
    """The first point of `curve_xs` outside the r-torsion."""
    from groth_sahai_tpu_torch.utils import hostmath
    inside = hostmath.g2_in_subgroup if g2 else hostmath.g1_in_subgroup
    return next((x, y) for x, y in curve_xs(g2)
                if y is not None and not inside((x, y)))


def run_msm_chunked(device, mult1, mult2, rng, shapes):
    """msm-chunked-g1-262144: CHUNKED_POINTS points a_i G1 (a_i from
    1..len(mult1), three at infinity) and seeded Fr scalars (edges 0, 1,
    r - 1). The counted run: the points through `g1_vec_to_bytes_bulk`
    (compressed) and back through `g1_vec_from_bytes_bulk_compressed`
    (decompressed and validated on the card), the 8192 points of mult2 the
    same way through the G2 codec, then `msm_chunked` in chunks of CHUNK
    with checkpoints in a temporary directory, partial 2 deleted, and
    `msm_chunked` again (three partials read back and validated, one
    chunk recomputed); the directory removed. Checked: the points read
    back equal the points written, both MSMs equal (sum s_i a_i) G1 on the
    host, the counters (4 chunks, then 3 resumed and 65536 points); the
    G1 and G2 readers refuse the batch with one point outside the
    r-torsion and with one x off the curve."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.curve import (G1, g1_affine_from_ints,
                                                 g1_affine_to_ints,
                                                 g2_affine_from_ints)
    from groth_sahai_tpu_torch.ops.fp import FQ, FR
    from groth_sahai_tpu_torch.ops.limbs import ints_to_limbs
    from groth_sahai_tpu_torch.ops.msm_chunked import msm_chunked
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    from groth_sahai_tpu_torch.utils import metrics, serde as S
    n = CHUNKED_POINTS
    gen = np.random.default_rng(rng.getrandbits(32))
    a = gen.integers(1, len(mult1) + 1, size=n)
    a[[11, n // 3, n - 1]] = 0
    base = g1_affine_from_ints(mult1, device=device)
    idx = torch.as_tensor(np.maximum(a - 1, 0), device=device)
    inf = torch.as_tensor(a == 0, device=device)
    pts = tuple(torch.where(inf, 0, c[:, idx]) for c in base[:2]) + (inf,)
    limbs = gen.integers(0, 1 << 16, size=(FR.n, n), dtype=np.int64)
    limbs[FR.n - 2] &= (1 << 14) - 1                 # scalars < 2^254 < r
    limbs[FR.n - 1] = 0
    limbs[:, :3] = ints_to_limbs([0, 1, C.R - 1], FR.n)
    s = torch.as_tensor(limbs, device=device)
    q = g2_affine_from_ints(mult2, device=device)
    sync()

    def run():
        back1, _ = S.g1_vec_from_bytes_bulk_compressed(
            S.g1_vec_to_bytes_bulk(pts, compressed=True), device=device)
        back2, _ = S.g2_vec_from_bytes_bulk_compressed(
            S.g2_vec_to_bytes_bulk(q, compressed=True), device=device)
        ckpt = tempfile.mkdtemp(prefix="msm_chunked_")
        try:
            metrics.reset()
            first = msm_chunked(G1, pts, s, chunk_size=CHUNK, ckpt_dir=ckpt)
            m1 = metrics.snapshot()
            os.remove(os.path.join(ckpt, "msm_partial_000002.bin"))
            metrics.reset()
            again = msm_chunked(G1, pts, s, chunk_size=CHUNK, ckpt_dir=ckpt)
            m2 = metrics.snapshot()
            metrics.reset()
        finally:
            shutil.rmtree(ckpt)
        return back1, back2, first, again, m1, m2

    (back1, back2, first, again, m1, m2), counts, secs, peak = counted(
        run, shapes)
    t0 = time.perf_counter()
    std = lambda aff: [FQ.from_mont(aff[0]), FQ.from_mont(aff[1]), aff[2]]
    for what, got, want in (("G1", back1, pts), ("G2", back2, q)):
        if not all(torch.equal(x, y) for x, y in zip(std(got), std(want))):
            raise AssertionError(f"msm-chunked-g1-262144: the {what} points "
                                 f"read back differ from those written")
    total = sum(int(limbs[l] @ a) << (16 * l) for l in range(FR.n)) % C.R
    host = H.g1_mul((C.G1_GEN_X, C.G1_GEN_Y), total)
    for what, out in (("first", first), ("resumed", again)):
        if g1_affine_to_ints(G1.to_affine(tuple(c[..., None]
                                                for c in out))) != [host]:
            raise AssertionError(f"msm-chunked-g1-262144: the {what} run "
                                 f"differs from the host")
    got_counts = (m1.get("count/msm_chunks_resumed", 0),
                  m1.get("count/msm_points"), m2.get("count/msm_chunks_resumed"),
                  m2.get("count/msm_points"))
    if got_counts != (0, n, 3, CHUNK):
        raise AssertionError(f"msm-chunked-g1-262144: counters (resumed, "
                             f"points) first, then again: {got_counts}")
    refused = []
    for g2, pts_w, size in ((False, pts, 48), (True, q, 96)):
        write = S.g2_vec_to_bytes_bulk if g2 else S.g1_vec_to_bytes_bulk
        read = (S.g2_vec_from_bytes_bulk_compressed if g2
                else S.g1_vec_from_bytes_bulk_compressed)
        blob = bytearray(write(pts_w, compressed=True))
        lane = 8 + size * (77 % pts_w[2].shape[0])
        x = off_curve_x(g2)
        cases = (("subgroup", (S.g2_point_to_bytes if g2 else
                               S.g1_point_to_bytes)(outside_subgroup(g2))),
                 ("not on curve", (S.fq_to_bytes(x[0]) + S.fq_to_bytes(x[1])
                                   if g2 else S.fq_to_bytes(x))))
        for match, point in cases:
            bad = bytearray(blob)
            bad[lane:lane + size] = point
            try:
                read(bytes(bad), device=device)
            except ValueError as exc:
                if match not in str(exc):
                    raise
                refused.append(f"{'G2' if g2 else 'G1'} {match}")
                continue
            raise AssertionError(f"msm-chunked-g1-262144: a batch with a "
                                 f"point {match} was read")
    print(f"[msm-chunked-g1-262144] {n} G1 and {q[2].shape[0]} G2 points "
          f"through the bulk codec, then {n} points in chunks of {CHUNK}, "
          f"resumed: {secs:.3f} s on the card, peak {peak:.2f} GiB; points "
          f"read back equal; both MSMs match (sum s_i a_i) G1 on the host; "
          f"3 partials resumed, one chunk recomputed; refused: "
          f"{', '.join(refused)}", flush=True)
    return counts, secs, time.perf_counter() - t0, run


def keeper(by_path, phases, runs):
    """keep(path, result): file a path's (counts, seconds, checks seconds,
    the run) and return the rest of its result."""
    def keep(path, out):
        by_path[path], phases[path], phases[path + "_checks"], runs[path] = \
            out[:4]
        return out[4:]
    return keep


# ----------------------------------------------- phase 3: the parallel layer

def fixed_base_muls(g2: bool, base, ks):
    """[k base for k in ks] (affine ints, None for infinity) on the host by
    a 4-bit comb: a table of d 16^j base (j < 64, d < 16), then one mixed
    addition a nonzero digit: ~5x fewer operations than double-and-add."""
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    from groth_sahai_tpu_torch.utils import hostmath as HM
    ops = HM._OPS2 if g2 else HM._OPS1
    add = H.g2_add if g2 else H.g1_add
    to_affine = H._jac_to_affine2 if g2 else H._jac_to_affine1
    table, step = [], base
    for _ in range(64):
        row = [None, step]
        for _ in range(14):
            row.append(add(row[-1], step))
        table.append(row)
        step = add(row[-1], step)                      # 16 step
    out = []
    for k in ks:
        k %= C.R
        acc = (ops.one, ops.one, ops.zero)
        for j in range(64):
            d = (k >> (4 * j)) & 15
            if d:
                acc = HM._add_mixed(ops, acc, table[j][d])
        out.append(to_affine(acc))
    return out


def run_matrix(device, mult1, mult2, rng, shapes):
    """matrix-334: the Mat / B1 / B2 / BT parity API (models/matrix.py) at
    the width of make_ppe(334, 334): `com_left_mul` of a seeded
    MATRIX_SIDE x MATRIX_SIDE Fr matrix Gamma by a Com1 vector of
    MATRIX_SIDE entries (batch (MATRIX_SIDE, 2): 223,112 scalar_mul lanes)
    on G1, `com_right_mul` of a Com2 vector (2, MATRIX_SIDE) by Gamma^T on
    G2, `comt_pairing_sum` of the two, then `comt_scalar_mul` by 2,
    `comt_add`, `comt_neg`, `comt_sub` and `comt_sum` on it. Every Com
    entry against c G on the host, c = Gamma a mod r over the inputs'
    discrete logs (drawn from 0..len(mult); 0 is infinity); each entry of
    the pairing sum against e(G1, G2)^(sum_j c1 c2); the GT laws 2 a =
    a + a, a + (-a) = 1, a - a = 1, a + a + (-a) = a on the card."""
    from groth_sahai_tpu_torch.models import matrix as M
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.curve import (G1, G2, g1_affine_from_ints,
                                                 g1_affine_to_ints,
                                                 g2_affine_from_ints,
                                                 g2_affine_to_ints)
    from groth_sahai_tpu_torch.ops.fp import FR
    from groth_sahai_tpu_torch.ops.tower import FQ12
    n = MATRIX_SIDE
    gam = [[rng.randrange(C.R) for _ in range(n)] for _ in range(n)]
    a = [[rng.randrange(len(mult1) + 1) for _ in range(2)] for _ in range(n)]
    b = [[rng.randrange(len(mult2) + 1) for _ in range(n)] for _ in range(2)]
    a[n // 2][0] = b[1][n // 3] = 0                    # infinity entries
    G = fr_limbs(sum(gam, []), device).reshape(FR.n, n, n)
    x, y, inf = g1_affine_from_ints([mult1[k - 1] if k else None
                                     for row in a for k in row], device)
    com1 = (x.reshape(-1, n, 2), y.reshape(-1, n, 2), inf.reshape(n, 2))
    x, y, inf = g2_affine_from_ints([mult2[k - 1] if k else None
                                     for row in b for k in row], device)
    com2 = (x.reshape(-1, 2, 2, n), y.reshape(-1, 2, 2, n),
            inf.reshape(2, n))
    two = fr_limbs([2], device)[:, 0]
    sync()

    def run():
        left = M.com_left_mul(G1, G, com1)                      # (n, 2)
        right = M.com_right_mul(G2, com2, M.fr_mat_transpose(G))  # (2, n)
        t = M.comt_pairing_sum(M.com_transpose(G1, left), right)
        neg = M.comt_neg(t)
        return left, right, t, (M.comt_scalar_mul(two, t), M.comt_add(t, t),
                                M.comt_add(t, neg), M.comt_sub(t, t),
                                M.comt_sum([t, t, neg]))

    (left, right, t, laws), counts, secs, peak = counted(run, shapes)
    t0 = time.perf_counter()
    c1 = [[sum(gam[j][k] * a[k][i] for k in range(n)) % C.R
           for i in range(2)] for j in range(n)]            # left[j][i]
    c2 = [[sum(gam[j][k] * b[i][k] for k in range(n)) % C.R
           for j in range(n)] for i in range(2)]            # right[i][j]
    g1 = (C.G1_GEN_X, C.G1_GEN_Y)
    g2 = (C.G2_GEN_X, C.G2_GEN_Y)
    if g1_affine_to_ints(left) != fixed_base_muls(False, g1, sum(c1, [])):
        raise AssertionError("matrix-334: com_left_mul differs from the host")
    if g2_affine_to_ints(right) != fixed_base_muls(True, g2, sum(c2, [])):
        raise AssertionError("matrix-334: com_right_mul differs from the "
                             "host")
    want = [gt_power(sum(c1[j][i] * c2[i2][j] for j in range(n)))
            for i in range(2) for i2 in range(2)]
    if FQ12.to_ints(t.reshape(t.shape[:2] + (4,))) != want:
        raise AssertionError("matrix-334: comt_pairing_sum differs from the "
                             "host")
    one = FQ12.one((2, 2), device=device)
    for name, got, exp in (("2 a = a + a", laws[0], laws[1]),
                           ("a + (-a) = 1", laws[2], one),
                           ("a - a = 1", laws[3], one),
                           ("a + a + (-a) = a", laws[4], t)):
        if not bool(FQ12.eq(got, exp).all()):
            raise AssertionError(f"matrix-334: {name} fails")
    print(f"[matrix-334] Gamma {n} x {n}: com_left_mul over {2 * n * n} G1 "
          f"lanes, com_right_mul over {2 * n * n} G2 lanes, "
          f"comt_pairing_sum of {n} pairs and the BT ops: {secs:.3f} s on "
          f"the card, peak {peak:.2f} GiB; {4 * n} Com entries and the "
          f"pairing sum match the host; the GT laws hold", flush=True)
    return counts, secs, time.perf_counter() - t0, run


def virtual_mesh(device):
    """SHARDS shards on one card: the counterpart of the JAX package's
    virtual CPU mesh."""
    from groth_sahai_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(SHARDS, devices=[device] * SHARDS)


def jac_ints(curve, jac):
    """One Jacobian point -> affine ints on the host."""
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_to_ints,
                                                 g2_affine_to_ints)
    to_ints = g2_affine_to_ints if curve.ns == 2 else g1_affine_to_ints
    return to_ints(curve.to_affine(tuple(c[..., None] for c in jac)))[0]


def run_sharded_msm(device, msm_case, mult2, rng, shapes):
    """sharded-msm-x4: `sharded_msm` over SHARDS shards on the card:
    msm-g1-65536's points and scalars (window 13: one msm call over a
    batch of SHARDS MSMs of 16384 points), held to msm-g1-65536's result;
    then SHARDS x G2_SHARD_POINTS G2 points b_i G2 (b_i from
    1..len(mult2), one at infinity; scalars with 0, 1, r - 1), window 8,
    against (sum b_i s_i) G2 on the host (the JAX package's G2 sharded MSM
    fails)."""
    from groth_sahai_tpu_torch.ops import bls12_381 as C
    from groth_sahai_tpu_torch.ops.curve import G1, G2, g2_affine_from_ints
    from groth_sahai_tpu_torch.parallel.sharded import sharded_msm
    from groth_sahai_tpu_torch.utils import hostcrypto as H
    pts1, s1, want1 = msm_case
    n2 = SHARDS * G2_SHARD_POINTS
    k2 = [rng.randrange(1, len(mult2) + 1) for _ in range(n2)]
    k2[n2 // 3] = 0
    sc2 = [rng.randrange(C.R) for _ in range(n2)]
    sc2[:3] = [0, 1, C.R - 1]
    pts2 = g2_affine_from_ints([mult2[k - 1] if k else None for k in k2],
                               device)
    s2 = fr_limbs(sc2, device)
    mesh = virtual_mesh(device)
    sync()

    def run():
        return (sharded_msm(mesh, G1, pts1, s1, window=13),
                sharded_msm(mesh, G2, pts2, s2, window=8))

    (o1, o2), counts, secs, peak = counted(run, shapes)
    t0 = time.perf_counter()
    if jac_ints(G1, o1) != want1:
        raise AssertionError("sharded-msm-x4: the G1 MSM differs from "
                             "msm-g1-65536's")
    want2 = H.g2_mul((C.G2_GEN_X, C.G2_GEN_Y),
                     sum(k * s for k, s in zip(k2, sc2)) % C.R)
    if jac_ints(G2, o2) != want2:
        raise AssertionError("sharded-msm-x4: the G2 MSM differs from the "
                             "host")
    print(f"[sharded-msm-x4] {SHARDS} shards on {device}: G1 "
          f"{pts1[2].shape[-1]} points (window 13), G2 {n2} points (window "
          f"8): {secs:.3f} s on the card, peak {peak:.2f} GiB; G1 equals "
          f"msm-g1-65536's, G2 (sum b_i s_i) G2 on the host", flush=True)
    return counts, secs, time.perf_counter() - t0, run


def run_sharded_pairing(device, mult1, mult2, rng, shapes):
    """sharded-pairing-4096-x4: `sharded_multi_pairing` of FUSED pairs in
    SHARDS shards on the one card (their Miller loops one fused launch
    an iteration, the shards a leading batch), against e(G1, G2)^(sum
    a_i b_i). Returns (counts,
    seconds, checks seconds, the run, (P, Q))."""
    from groth_sahai_tpu_torch.ops.curve import (g1_affine_from_ints,
                                                 g2_affine_from_ints)
    from groth_sahai_tpu_torch.ops.tower import FQ12
    from groth_sahai_tpu_torch.parallel.sharded import sharded_multi_pairing
    a, b, P_pts, Q_pts = pairing_inputs(FUSED, mult1, mult2, rng)
    P = g1_affine_from_ints(P_pts, device=device)
    Q = g2_affine_from_ints(Q_pts, device=device)
    mesh = virtual_mesh(device)
    sync()

    def run():
        return sharded_multi_pairing(mesh, P, Q)

    out, counts, secs, peak = counted(run, shapes)
    t0 = time.perf_counter()
    if FQ12.to_ints(out)[0] != gt_power(sum(x * y for x, y in zip(a, b))):
        raise AssertionError("sharded-pairing-4096-x4: the product differs "
                             "from the host")
    print(f"[sharded-pairing-4096-x4] {FUSED} pairs in {SHARDS} shards: "
          f"{secs:.3f} s on the card, peak {peak:.2f} GiB; matches "
          f"e(G1, G2)^(sum a_i b_i)", flush=True)
    return counts, secs, time.perf_counter() - t0, run, (P, Q)


def run_batch_verify_x4(device, batch_case, shapes):
    """batch-verify-ppe-1024-x4: batch-verify-ppe-1024's three batches
    (randomized, randomized with slot BAD_SLOT changed, per equation) on
    its proofs, over SHARDS shards (groups of EQUATIONS / SHARDS
    equations, rho drawn before the split): the same verdicts."""
    from groth_sahai_tpu_torch.models import batch as BT
    from groth_sahai_tpu_torch.utils.rng import GsRng
    equs, slots, bad, crs, (good, with_bad, verdicts) = batch_case
    mesh = virtual_mesh(device)

    def run():
        return (BT.verify_ppe_batch_randomized(equs, slots, crs, GsRng(9),
                                               mesh=mesh),
                BT.verify_ppe_batch_randomized(equs, bad, crs, GsRng(10),
                                               mesh=mesh),
                BT.verify_ppe_batch(equs, bad, crs, mesh=mesh))

    (g4, b4, v4), counts, secs, peak = counted(run, shapes)
    if (g4, b4) != (good, with_bad) or v4.tolist() != verdicts.tolist():
        raise AssertionError(
            f"batch-verify-ppe-1024-x4: randomized {g4}, {b4} (unsharded "
            f"{good}, {with_bad}); per-slot verdicts differ at "
            f"{[i for i in range(len(v4)) if v4[i] != verdicts[i]]}")
    print(f"[batch-verify-ppe-1024-x4] {len(equs)} slots in {SHARDS} groups: "
          f"{secs:.3f} s for the three batches on the card, peak "
          f"{peak:.2f} GiB; the verdicts equal the unsharded run's",
          flush=True)
    return counts, secs, 0.0, run


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_nccl(device, msm_case, pair_case, shapes):
    """nccl-1rank: `init_distributed` with one rank on the card (NCCL, a
    store on 127.0.0.1), `make_global_mesh` with SHARDS entries of the
    card, flattened; sharded-msm-x4's G1 `sharded_msm` and
    sharded-pairing-4096-x4's `sharded_multi_pairing` again, at their
    shapes, through the all_gather merge: equal to msm-g1-65536's result
    and to the unsharded `multi_pairing`. The group stays up for the
    profile phase; `main` destroys it."""
    import torch.distributed as dist
    from groth_sahai_tpu_torch.ops.curve import G1
    from groth_sahai_tpu_torch.ops.pairing import multi_pairing
    from groth_sahai_tpu_torch.ops.tower import FQ12
    from groth_sahai_tpu_torch.parallel.multihost import (flatten_mesh,
                                                          init_distributed,
                                                          make_global_mesh)
    from groth_sahai_tpu_torch.parallel.sharded import (sharded_msm,
                                                        sharded_multi_pairing)
    pts, s, want_msm = msm_case
    P, Q = pair_case
    want_gt = FQ12.to_ints(multi_pairing(P, Q))[0]
    t0 = time.perf_counter()
    if not init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                            device=device):
        raise AssertionError("nccl-1rank: no process group")
    backend = dist.get_backend()
    if backend != ("nccl" if device.type == "cuda" else "gloo"):
        raise AssertionError(f"nccl-1rank: backend {backend}")
    init_s = time.perf_counter() - t0
    mesh = flatten_mesh(make_global_mesh(local_devices=[device] * SHARDS))
    sync()

    def run():
        return (sharded_msm(mesh, G1, pts, s, window=13),
                sharded_multi_pairing(mesh, P, Q))

    (o1, o2), counts, secs, peak = counted(run, shapes)
    if jac_ints(G1, o1) != want_msm or FQ12.to_ints(o2)[0] != want_gt:
        raise AssertionError("nccl-1rank: a merged result differs from the "
                             "unsharded one")
    print(f"[nccl-1rank] {backend}, world {dist.get_world_size()}, init "
          f"{init_s:.3f} s; {mesh.shape['chips']} shards: sharded_msm of "
          f"{pts[2].shape[-1]} G1 points and sharded_multi_pairing of "
          f"{P[2].shape[-1]} pairs through all_gather: {secs:.3f} s, peak "
          f"{peak:.2f} GiB; both equal the unsharded results", flush=True)
    return counts, secs, 0.0, run


def run_trace(device, ppe_case, shapes):
    """trace: one `profiling.trace` over a `verify` of
    prove-verify-ppe-8x8's proof (True); the TensorBoard trace file it
    writes must hold CUDA kernel events of the ported kernels."""
    import tempfile
    from pathlib import Path
    from groth_sahai_tpu_torch.models.verifier import verify
    from groth_sahai_tpu_torch.utils.profiling import trace
    equ, proof, crs = ppe_case
    with tempfile.TemporaryDirectory() as log_dir:
        def run():
            with trace(log_dir, device=device):
                ok = verify(equ, proof, crs)
                sync()
            return ok

        ok, counts, secs, peak = counted(run, shapes)
        t0 = time.perf_counter()
        files = list(Path(log_dir).glob("*.pt.trace.json"))
        if not ok or len(files) != 1:
            raise AssertionError(f"trace: verify {ok}, trace files {files}")
        size = files[0].stat().st_size
        events = json.loads(files[0].read_text())["traceEvents"]
    names = collections.Counter(e.get("name", "") for e in events
                                if e.get("cat") == "kernel")
    ported = {k: sum(c for name, c in names.items() if k + "_kernel" in name)
              for k in ORIGIN}
    ported = {k: c for k, c in ported.items() if c}
    if not ported:
        raise AssertionError(f"trace: no ported kernel among the trace's "
                             f"{sum(names.values())} kernel events")
    print(f"[trace] verify of prove-verify-ppe-8x8 under profiling.trace: "
          f"{secs:.3f} s (profiler on), a {size / 2 ** 20:.1f} MiB trace "
          f"with {sum(names.values())} kernel events, of the ported "
          f"kernels {json.dumps(ported)}", flush=True)
    return counts, secs, time.perf_counter() - t0, lambda: verify(
        equ, proof, crs)


def run_parallel_paths(device, mult1, mult2, rng, phases, by_path, shapes,
                       runs, cases):
    """Phase 3, the parity API, the parallel layer and the trace (see
    run_paths); cases: msm-g1-65536's, batch-verify-ppe-1024's and
    prove-verify-ppe-8x8's inputs and results."""
    msm_case, batch_case, ppe_case = cases

    keep = keeper(by_path, phases, runs)

    keep("matrix-334", run_matrix(device, mult1, mult2, rng,
                                  shapes["matrix-334"]))
    keep("sharded-msm-x4", run_sharded_msm(device, msm_case, mult2, rng,
                                           shapes["sharded-msm-x4"]))
    pair_case, = keep("sharded-pairing-4096-x4", run_sharded_pairing(
        device, mult1, mult2, rng, shapes["sharded-pairing-4096-x4"]))
    keep("batch-verify-ppe-1024-x4", run_batch_verify_x4(
        device, batch_case, shapes["batch-verify-ppe-1024-x4"]))
    keep("nccl-1rank", run_nccl(device, msm_case, pair_case,
                                shapes["nccl-1rank"]))
    keep("trace", run_trace(device, ppe_case, shapes["trace"]))


def run_msm_paths(device, crs, keys, mult1, mult2, rng, phases, by_path,
                  shapes, runs):
    """Phase 3, the MSM paths and the Miller steps (see run_paths)."""
    keep = keeper(by_path, phases, runs)

    msm_case, = keep("msm-g1-65536", run_msm_g1(device, mult1, rng,
                                                shapes["msm-g1-65536"]))
    t0 = time.perf_counter()
    stmt = ppe_334(device, mult1, mult2, rng)
    phases["ppe-334_statement"] = time.perf_counter() - t0
    proof, = keep("prove-ppe-334", run_prove_334(
        device, crs, keys, stmt, rng, shapes["prove-ppe-334"]))
    keep("verify-ppe-334", run_verify_334(device, crs, keys, stmt, proof,
                                          shapes["verify-ppe-334"]))
    keep("miller-steps-4096", run_miller_steps(device, mult2, rng,
                                               shapes["miller-steps-4096"]))
    batch_case, = keep("batch-verify-ppe-1024", run_batch_verify(
        device, crs, mult1, mult2, rng, shapes["batch-verify-ppe-1024"]))
    keep("msm-chunked-g1-262144", run_msm_chunked(
        device, mult1, mult2, rng, shapes["msm-chunked-g1-262144"]))
    return msm_case, batch_case


def run_gs_paths(device, mult1, mult2, rng, phases, by_path, shapes, runs):
    """Phase 3, the commit / prove / verify paths (see run_paths)."""
    from groth_sahai_tpu_torch.models.crs import generate_crs
    from groth_sahai_tpu_torch.utils.rng import GsRng
    seed = SEED + 10
    crs = generate_crs(GsRng(seed), device=device)
    k1, k2, _ = crs_logs(seed)
    keep = keeper(by_path, phases, runs)
    for k, path in enumerate(("commit-g1-334", "commit-g2-334",
                              "commit-scalar-b1-334",
                              "commit-scalar-b2-334")):
        keep(path, run_commit(path, device, (crs, (k1, k2), SEED + 11 + k),
                              rng, shapes[path]))
    keep("scalar-mul-g1-4096", run_scalar_mul(device, mult1, rng,
                                              shapes["scalar-mul-g1-4096"]))
    keep("gs-e2e", run_e2e(device, shapes["gs-e2e"]))
    ppe_case, = keep("prove-verify-ppe-8x8", run_ppe_8x8(
        device, rng, shapes["prove-verify-ppe-8x8"]))
    msm_case, batch_case = run_msm_paths(device, crs, (k1, k2), mult1, mult2,
                                         rng, phases, by_path, shapes, runs)
    run_parallel_paths(device, mult1, mult2, rng, phases, by_path, shapes,
                       runs, (msm_case, batch_case, ppe_case))


# ----------------------------------------------------------------- phase 5

def bound_ms(name: str, lanes: int, args) -> tuple:
    """The least time of one launch on this card: (ms, "bytes" or
    "operations"). Bytes: int64 limbs read and written once (8 bytes per
    16-bit limb). Operations: 32-bit multiply-adds of a multiplier on
    packed 32-bit words, two per word product (its low and its high half):
    an Fq value is w = 13 words and p pw = 12, so a Montgomery product at
    R = 2^400 is 2 (w^2 + w pw) = 650 (the product's w^2 word products
    and the reduction's w pw, 12 steps of 2^32 and one of 2^16), a
    schoolbook product 2 w^2 = 338, a reduction 2 w pw = 312 (the field
    kernels over Fr: w = 9, pw = 8, 17 limbs, a product 306); an Fq12
    product is 66 Montgomery products (54 Karatsuba + 12 post-reductions),
    a cyclotomic square 30 (18 + 12), a Miller doubling iteration 176 (66
    for f^2, 49 for the point step, 4 to scale the line, 57 for the sparse
    product), an addition iteration 126 (65 + 4 + 57); a complete mixed
    add 11, a complete doubling 8, a complete add 12 (each Fq2 product on
    G2 five), the row scan 11 per row; the Miller doubling step 49, the
    addition step 65. Each counts what this input needs: a square per
    bit, a product per set bit (for f12_pow_dyn, each lane's own scalar
    bits); the mixed adds of cmadd and the row scan, and their affine
    coordinates, only where the point's flag is clear. One yardstick for
    every kernel, whatever its limbs."""
    from groth_sahai_tpu_torch.ops import cuda_fp as K
    from groth_sahai_tpu_torch.ops import cuda_tower as CT
    from groth_sahai_tpu_torch.ops.fp import FQ, FR
    F = args[0] if name in FIELD else FQ        # Fr: 17 limbs, 9 words
    n = F.n
    w, pw = (n + 1) // 2, (F.p.bit_length() + 31) // 32
    mont = 2 * (w * w + w * pw)
    if name == "pow_const":
        bits = K.exponent_bits(args[-1])
        products = (len(bits) + sum(bits)) * mont
    elif name == "cyc_pow":
        e = args[-1]
        products = (CT.CYC_POW_NBITS * 30 + bin(e).count("1") * 66) * mont
    elif name == "f12_pow_dyn":
        s = args[-1].expand((FR.n,) + args[0].shape[2:]).reshape(FR.n, -1)
        set_bits = sum(int(((s >> b) & 1).sum()) for b in range(16))
        products = (CT.POW_DYN_NBITS * 66 + set_bits * 66 / lanes) * mont
    elif name in CURVE + MSM_KERNELS:
        # an Fq2 product is 5 Montgomery products (3 Karatsuba + 2
        # post-reductions); a doubling 8, an add 12 (cdbl_n_add, cadd: 6
        # coordinates in, 3 out); a mixed add 11 (cmadd, the row scan) only
        # where the affine point's flag is clear: a flagged lane (cmadd) or
        # row (the row scan) makes no product and needs neither affine
        # coordinate. cmadd: 3 coordinates in and 3 out a lane, 2 affine in
        # a live lane, a flag byte a lane; the row scan: 3 out a row, 2
        # affine in a live row, a flag byte a row, 3 totals a lane
        ns = args[-1].ns
        coord = n * ns * 8
        if name in ("cmadd", "cmsm_row_scan"):
            flags = args[1][2] if name == "cmadd" else args[0][2]
            live = int((flags == 0).sum())
            adds = 11 * live
            out = 6 if name == "cmadd" else 3 * flags.shape[0] + 3
            nbytes = (2 * live + out * lanes) * coord + flags.numel()
        else:
            adds = (12 if name == "cadd" else 8 * args[1] + 12) * lanes
            nbytes = 9 * coord * lanes
        products = adds * (5 if ns == 2 else 1) * mont
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = products / PEAK_IMAD_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")
    else:
        products = {"mont_mul": mont, "mul_wide": 2 * w * w,
                    "redc": 2 * w * pw,
                    "fq12_mul": 66 * mont, "cyc_sqr": 30 * mont,
                    "miller_iter_dbl": 176 * mont,
                    "miller_iter_add": 126 * mont,
                    "miller_dbl_step": 49 * mont,
                    "miller_add_step": 65 * mont}[name]
    limbs = {"mont_mul": 3 * n, "mul_wide": 4 * n + 1, "redc": 3 * n + 1,
             "pow_const": 2 * n, "fq12_mul": 36 * n, "cyc_pow": 24 * n,
             "cyc_sqr": 24 * n, "miller_iter_dbl": 38 * n,
             "miller_iter_add": 42 * n, "f12_pow_dyn": 24 * n + FR.n,
             "miller_dbl_step": 18 * n, "miller_add_step": 22 * n}[name]
    t_bytes = limbs * 8 * lanes / PEAK_BYTES_PER_S * 1e3
    t_ops = products * lanes / PEAK_IMAD_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_kernel(name, lanes, args):
    """(device ms per launch, wrapper ms, plain ms, bound ms, bound by, how
    the device time was taken) of one kernel on one case; its outputs
    compared once more."""
    kern, plain = kernels()[name], plain_of(name)
    saved = kern.launches
    if compare(name, args) != 0:
        raise AssertionError(f"{name} differs from its plain version at the "
                             f"timing shape ({lanes} lanes)")
    slow = name in ("pow_const", "cyc_pow", "f12_pow_dyn") or lanes > 1 << 16
    ms, how = device_ms(lambda: kern(*args), 3 if slow else 20, name)
    wrapper_ms = time_ms(lambda: kern(*args), 3 if slow else 20)
    plain_ms = time_ms(lambda: plain(*args), 1 if slow else 5)
    kern.launches = saved              # timing launches are not path launches
    return (ms, wrapper_ms, plain_ms) + bound_ms(name, lanes, args) + (how,)


def report_shapes(name):
    """[(field or curve name, lanes, rows, n_dbl or None)] at which the
    report times a kernel, its main shape first."""
    if name in MSM_KERNELS:
        return msm_shapes(name)
    main = [(MAIN_FIELD.get(name, "Fq"), PATH_LANES[name], None)]
    return main + [(t + (None,))[:3] for t in ALSO_TIMED.get(name, [])]


def top_shapes(shapes, name: str, k: int = 3) -> dict:
    """The k shapes (lanes) of kernel `name` that one path's recorded
    launches hold most often, by field: {field name: [(lanes, launches)]}."""
    by_field = collections.defaultdict(collections.Counter)
    for (kern, field, lanes, _), calls in shapes.items():
        if kern == name:
            by_field[field][lanes] += calls
    return {f: c.most_common(k) for f, c in sorted(by_field.items())}


def kernel_report(device, worst, timing, counts, by_path, extra):
    """Each kernel at its path shapes (main first), then at the shapes
    `extra` gives it ({kernel: [(field name, lanes)]}, inputs made here):
    device time per launch (profiler), the wrapper's time per call and the
    plain version's (CUDA events), its bound; the outputs of these inputs
    compared once more."""
    import torch
    from groth_sahai_tpu_torch.ops.fp import FQ, FR
    gen = torch.Generator().manual_seed(SEED + 3)
    rows = []
    for name, (replaces, source) in ORIGIN.items():
        times = []
        cases = [(f, m, e, False) for f, m, e in report_shapes(name)]
        cases += [(f, m, None, True) for f, m in extra.get(name, [])]
        for field, lanes, e, made_here in cases:
            args = (case_args(name, {"Fq": FQ, "Fr": FR}[field], lanes, None,
                              gen, device) if made_here
                    else moved(timing.pop((name, field, lanes)), device))
            t = time_kernel(name, lanes, args)
            del args
            times.append(dict(zip(
                ("field", "lanes", "rows", "ms", "wrapper_ms", "plain_ms",
                 "bound_ms", "bound_by", "ms_by"), (field, lanes, e) + t)))
            print(f"[report] {field} {name:15s} lanes={lanes:7d}"
                  + (f" {'n' if name == 'cdbl_n_add' else 'rows'}={e}"
                     if e else "") + f" device {t[0]:.4f} ms "
                  f"per launch by {t[5]} (wrapper {t[1]:.4f} ms per call, "
                  f"plain {t[2]:.4f} ms), bound {t[3]:.5f} ms by {t[4]}",
                  flush=True)
        main = times[0]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": worst[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "ms_by": main["ms_by"],
            "lanes": main["lanes"], "field": main["field"],
            "wrapper_ms": main["wrapper_ms"],
            "launches_by_path": {path: c[name] for path, c in by_path.items()},
            "also": times[1:],
        })
    return rows


def profile_path(path: str, fn):
    """Where the time of one run of a path goes: device time by kernel
    (torch.profiler), the ported kernels' share, the launch count and the
    device's busy share of the wall time (profiler on). Where the profiler
    records no kernel (on the H100 it records none of gt-exp-4096's few
    long launches, with or without a traced warm-up run), the run's time
    by CUDA events instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not rows:
        ms = time_ms(fn, 1)
        print(f"[profile] {path}: the profiler recorded no CUDA kernels; "
              f"one run takes {ms:.3f} ms by CUDA events (device launches "
              f"not measured)", flush=True)
        return
    busy = sum(t for _, _, t in rows)
    ported = {}
    for name in ORIGIN:
        mine = [(c, t) for k, c, t in rows if name + "_kernel" in k]
        count, total = sum(c for c, _ in mine), sum(t for _, t in mine)
        ported[name] = {"count": count, "ms": total / 1e3,
                        "us_per_launch": total / count if count else None}
    ours = sum(f["ms"] for f in ported.values()) * 1e3
    summary = {
        "path": path, "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / wall_us,
        "ported_kernels_ms": ours / 1e3,
        "ported_kernels_share_of_busy": ours / busy,
        "ported_kernels": ported,
        "device_launches": sum(c for _, c, _ in rows),
        "top": [{"kernel": k[:90], "count": c, "ms": t / 1e3}
                for k, c, t in sorted(rows, key=lambda r: -r[2])[:8]],
    }
    print("[profile] " + json.dumps(summary), flush=True)


def signed_mask(k: int, rhs: int, rng):
    """numpy bool (k,): the verifier's lhs terms then `rhs` conjugated rhs
    terms; rhs = 0 gives a random mask."""
    import numpy as np
    if rhs:
        return np.array([False] * (k - rhs) + [True] * rhs)
    return np.array([rng.random() < 0.5 for _ in range(k)], dtype=bool)


def run_paths(device, mult1, mult2, rng, phases):
    """Phase 3: the five pairing paths, then the commit, scalar-mul and
    prove / verify paths, then the parity API, the parallel layer and the
    trace. Returns (launch counts by path, the launch
    shapes by path, a callable re-running each path for its profile)."""
    from groth_sahai_tpu_torch.models import kernels as MK
    from groth_sahai_tpu_torch.ops.pairing import gt_exp, pairing
    from groth_sahai_tpu_torch.ops.tower import FQ12
    by_path, runs = {}, {}
    shapes = collections.defaultdict(collections.Counter)
    for path, n in (("pairing-8192", BATCH), ("pairing-4096", FUSED)):
        c, phases[path], phases[path + "_checks"], pq, out = run_pairing(
            path, n, device, mult1, mult2, rng, shapes[path])
        by_path[path] = c
        runs[path] = (lambda pq=pq, n=n: FQ12.cyclotomic_sqr(pairing(*pq))
                      if n <= FUSED else pairing(*pq))
        if n == FUSED:
            pair4096 = out
    for path, k, rhs in (("signed-2048", K_SIGNED, 0),
                         ("signed-1024", K_PPE, K_PPE_RHS)):
        c, phases[path], phases[path + "_checks"], coms = run_signed(
            path, k, signed_mask(k, rhs, rng), device, mult1, mult2, rng,
            shapes[path])
        by_path[path] = c
        runs[path] = lambda coms=coms: MK.final_exp(
            MK.miller_product_signed(*coms))
    c, phases["gt-exp-4096"], phases["gt-exp-4096_checks"], g = run_gt_exp(
        device, pair4096, rng, shapes["gt-exp-4096"])
    by_path["gt-exp-4096"] = c
    runs["gt-exp-4096"] = lambda: (gt_exp(g[0], g[2].reshape(
        g[2].shape[0], EQUATIONS, 1, 1)), gt_exp(g[1], g[2]))
    run_gs_paths(device, mult1, mult2, rng, phases, by_path, shapes, runs)
    return by_path, shapes, runs


def check_counts(by_path, shapes_by_path):
    """Every kernel the reference takes on a path launched on it, the
    fused kernels not on the paths above their cap, the Miller iterations
    exactly 63 + 5 times, f12_pow_dyn once per gt_exp call, the curve
    kernels as scalar_mul and msm make them (`exact_counts`); every launch
    recorded with its shape."""
    for path, counts in by_path.items():
        print(f"[report] launches on {path}: {json.dumps(counts)}",
              flush=True)
        seen = collections.Counter()
        for (name, *_), calls in shapes_by_path[path].items():
            seen[name] += calls
        unseen = {k: (counts[k], seen[k]) for k in counts
                  if counts[k] != seen[k]}
        if unseen:
            raise AssertionError(f"launches on {path} against launches "
                                 f"recorded with their shape: {unseen}")
        need, never = PATH_KERNELS[path]
        idle = [k for k in need if counts[k] == 0]
        if idle:
            raise AssertionError(f"kernels never launched on {path}: {idle}")
        stray = [k for k in never if counts[k] != 0]
        if stray:
            raise AssertionError(f"kernels launched on {path} that the "
                                 f"reference does not take there: {stray}")
    for (path, name), want in exact_counts().items():
        if by_path[path][name] != want:
            raise AssertionError(f"{name} launched {by_path[path][name]} "
                                 f"times on {path}, not {want}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one H100",
              file=sys.stderr)
        return 2
    try:
        from groth_sahai_tpu_torch.ops import (cuda_build, cuda_curve, cuda_fp,
                                               cuda_tower)
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable ({exc}); run it from "
              f"the repository's root", file=sys.stderr)
        return 2

    phases = {}
    try:
        device = torch.device("cuda", 0)
        t0 = time.perf_counter()
        libs = cuda_build.build_all([cuda_fp.LIBRARY, cuda_tower.LIBRARY,
                                     cuda_curve.LIBRARY])
        phases["build"] = time.perf_counter() - t0
        card = card_line()
        for lib in libs:      # ptxas: each kernel's registers and stack
            log = lib.with_suffix(".log")
            lines = log.read_text().splitlines() if log.exists() else []
            print(f"[build] {lib.name}", flush=True)
            for line in lines:
                if any(k in line for k in ("Function properties",
                                           "stack frame", "Used")):
                    print("    " + line.strip(), flush=True)
        print(f"[build] {len(libs)} libraries in {phases['build']:.1f} s on "
              f"{card}", flush=True)
        from groth_sahai_tpu_torch.utils.curve_variants import (
            CDBL_PTXAS, CDBL_SASS, ptxas_report, sass_report)
        from groth_sahai_tpu_torch.utils.fp_variants import FP_SASS, MONT_SASS
        from groth_sahai_tpu_torch.utils.fp_variants import PTXAS as FP_PTXAS
        from groth_sahai_tpu_torch.utils.tower_variants import PTXAS, TOWER_SASS
        tower, curve = cuda_tower.LIBRARY.path(), cuda_curve.LIBRARY.path()
        fp = cuda_fp.LIBRARY.path()
        for line in (sass_report(curve) + sass_report(curve, CDBL_SASS)
                     + sass_report(tower, TOWER_SASS)
                     + sass_report(fp, FP_SASS)
                     + sass_report(fp, MONT_SASS)):
            print(f"[sass] {line}", flush=True)
        for lib, pattern in ((curve, CDBL_PTXAS), (tower, PTXAS),
                             (fp, FP_PTXAS)):
            for line in ptxas_report(lib.with_suffix(".log").read_text(),
                                     pattern):
                print(f"[ptxas] {line}", flush=True)

        t0 = time.perf_counter()
        worst, timing, checked = check_kernels(device)
        phases["kernels"] = time.perf_counter() - t0

        rng = random.Random(SEED)
        t0 = time.perf_counter()
        mult1, mult2 = host_multiples(BATCH)
        phases["host_inputs"] = time.perf_counter() - t0

        by_path, shapes, runs = run_paths(device, mult1, mult2, rng, phases)
        check_counts(by_path, shapes)
        total = {k: sum(c[k] for c in by_path.values()) for k in ORIGIN}

        t0 = time.perf_counter()
        extra = check_path_shapes(device, shapes, checked, worst)
        phases["path_shapes"] = time.perf_counter() - t0
        print(f"[shapes] {extra} launch shapes of the paths held beside "
              f"phase 2's {len(checked) - extra}", flush=True)
        fr_mont = {path: sorted(m for (k, f, m, _) in c
                                if k == "mont_mul" and f == "Fr")
                   for path, c in shapes.items()}
        print(f"[shapes] Fr mont_mul, each shape held bit-exact: lanes "
              f"by path {json.dumps({p: m for p, m in fr_mont.items() if m})}",
              flush=True)
        top = top_shapes(shapes["verify-ppe-334"], "mont_mul")
        print(f"[shapes] verify-ppe-334's most-launched mont_mul shapes "
              f"(lanes, launches) by field: {json.dumps(top)}", flush=True)
        every = top_shapes(sum(shapes.values(), collections.Counter()),
                           "mont_mul")
        for field, most in every.items():     # a field verify launches none of
            top.setdefault(field, most)

        t0 = time.perf_counter()
        rows = kernel_report(device, worst, timing, total, by_path, {
            "mont_mul": [(f, m) for f, ms in top.items() for m, _ in ms]})
        phases["report"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for path, fn in runs.items():
            profile_path(path, fn)
        phases["profile"] = time.perf_counter() - t0
        print("[phases] " + json.dumps({k: round(v, 3)
                                        for k, v in phases.items()}),
              flush=True)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()      # nccl-1rank's

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
