// The fused tower kernels of the port: Hopper (sm_90a) counterparts of eight
// Pallas kernels of groth_sahai_tpu/ops/pallas_tower.py.
//
//   gs_fq12_mul        <- pallas_tower.fq12_mul / fq12_sqr (_fq12_mul_kernel)
//   gs_cyc_pow         <- pallas_tower.cyc_pow (_cyc_pow_kernel)
//   gs_cyc_sqr         <- pallas_tower.cyc_sqr (_cyc_sqr_kernel)
//   gs_miller_iter_dbl <- pallas_tower.miller_iter_dbl (_miller_iter_dbl_kernel)
//   gs_miller_iter_add <- pallas_tower.miller_iter_add (_miller_iter_add_kernel)
//   gs_f12_pow_dyn     <- pallas_tower.f12_pow_dyn (_f12_pow_dyn_kernel)
//   gs_miller_dbl_step <- pallas_tower.miller_dbl_step (_miller_dbl_kernel)
//   gs_miller_add_step <- pallas_tower.miller_add_step (_miller_add_kernel)
//
// The reference takes them for batches of at most 4096 lanes: on the
// verifier's signed Miller product at Kp <= 1024 the two iteration kernels
// run the whole Miller loop (63 + 5 launches), fq12_mul the tree product
// over the pair axis and the final exponentiation with cyc_pow;
// f12_pow_dyn is gt_exp, the rho-weighting of randomized batch
// verification; cyc_sqr is FQ12.cyclotomic_sqr. The two step kernels are
// the point update and line of one Miller iteration alone (the iteration
// kernels' own bodies): entry points that no path of either package calls.
//
// Work split: an Fq12 batch is int64 [25, 12, M] (limb i of coefficient c
// of lane l at (12 i + c) M + l), an Fq2 batch [25, 2, M], an Fq batch
// [25, M], Fr scalars [17, M].
//
// What bounds them on the H100: an Fq12 product is 66 Montgomery products
// (54 Karatsuba + 12 post-reductions) per lane on 7.2 KB of int64 limbs
// moved, so the kernels are bound by the multiplier: a doubling iteration
// is 176 Montgomery products per lane, an addition iteration 126, the
// doubling and addition steps 49 and 65, f12_pow_dyn up to 272 x 132. Only
// the cyclotomic square, 30 products on 4.8 KB moved, is bound by bytes
// (19.7 MB at 4096 lanes: 5.9 us at 3.35 TB/s, against 4.8 us of
// multiply-adds). At the few thousand lanes of these calls neither rate is
// the real limit: a lane's chain of dependent Montgomery products is, and
// one thread a lane made each product in series, ~2 us apiece.
//
// Every kernel here is designed for that limit (tower_w32.cuh over
// group_w32.cuh):
//   * an Fq value is 13 packed 32-bit words at the same R = 2^400, and
//     every product is field_w32.cuh's out-of-line `mont` with its
//     operands and result in registers, so the limbs at the boundary do
//     not change;
//   * a lane is worked by a group of G threads of one warp: the
//     independent Montgomery products of each level of a formula go
//     round-robin to the group's threads, levels separated by __syncwarp
//     of the group, so a lane's chain of products shrinks from 2,316
//     (cyc_pow, e = |x|), 176 (a doubling iteration), 126 (an addition
//     iteration), 65 and 49 (the addition and doubling steps) and 30 (a
//     cyclotomic square) to the levels' rounds of products: a cyclotomic
//     square 2 and an Fq12 product 3 at cyc_pow's G = 32 (146 for
//     e = |x|), a doubling iteration 25 and an addition iteration 17 at
//     G = 8, a doubling step 14 at G = 4, an addition step 11 at G = 8, a
//     cyclotomic square 8 at cyc_sqr's G = 4, an Fq12 product 5 at
//     fq12_mul's G = 16; f12_pow_dyn's 272 squares and its products on set
//     bits are Fq12 products of 5 rounds each at its G = 16 (about 2,000
//     rounds for a random 255-bit scalar where one thread made 26,900
//     products). Every thread of a group takes the same scalar bit, so no
//     group diverges. cyc_pow and f12_pow_dyn run one square-and-multiply
//     loop (pow_body), each with its exponent's bits and its square
//     (cyclotomic, or the generic product with B = A).
//     G is the fastest of 4, 8, 16 and 32 for each kernel on the paths'
//     shapes (utils/tower_variants.py): the verifier's cyc_pow runs over 4
//     lanes, where nothing else is on the card and only a shorter chain
//     helps; its Miller loop over 4096 lanes, where G = 8 fills the card
//     in one wave (G = 16 gains 1.25x for the addition iteration over the
//     32 to 128 lanes of the prove paths, short of the 1.3x that would
//     earn a lane rule); fq12_mul runs over both (the Miller product tree from
//     2048 lanes down to 4, the final exponentiation's products over 4),
//     and G = 16 comes within 1.33x of the best G at each width;
//     f12_pow_dyn runs over 4096 and 1024 lanes (gt-exp-4096), where G = 16
//     is the fastest at 1024 and within 1.09x of G = 4 at 4096 (there the
//     card is full, and a larger G leaves more of a warp's threads idle in
//     the levels of 9 and 12 tasks: G = 32 is 1.16x slower); the doubling
//     step's kDblStepGroup = 4 is the fastest of 4, 8 and 16 over
//     miller-steps-4096's 4096 lanes (utils/tower_variants.py --step: 2 %
//     ahead of G = 8, 17 % of G = 16; with 4 threads a lane its 4096 lanes
//     are 512 blocks of 32 threads, about four a SM); the addition step's
//     kAddStepGroup = 8 is the fastest of 4, 8 and 16 by the same --step
//     (5 % ahead of G = 4, 34 % of G = 16), and cyc_sqr's kCycSqrGroup = 4
//     of 4, 8, 16 and 32 (3 % ahead of G = 8, 27 % of G = 16, 85 % of
//     G = 32): its time followed the warp-rounds of products a launch
//     issues (512 warps x 8 rounds at G = 4, 2,048 x 3 at G = 16, 4,096 x
//     2 at G = 32), and G = 16 kept 8 B on a stack frame;
//   * the lane's values (its Fq12 values, R, the leaves and Karatsuba
//     values of each level) live in the group's shared memory, 13 words
//     an Fq slot: 108 slots for fq12_mul, cyc_pow and f12_pow_dyn, 133
//     for the doubling iteration, 118 for the addition iteration, 41 and
//     40 for the doubling and addition steps, 42 for cyc_sqr; blocks
//     of kGroupLanes lanes (55 KB of shared memory a block for the
//     doubling iteration: four blocks an SM hold verify's 4096 lanes in
//     one wave). Inactive lanes of a ragged block leave as whole groups.
//
// Plain C interface for ctypes. Each entry point returns cudaGetLastError()
// after its launch (0 = success), or -1 for a limb count other than 25.
#include <cuda_runtime.h>

#include <cstdint>

#include "field_w32.cuh"
#include "tower_w32.cuh"

namespace {

using gs::tw::TowerW;
using gs::w32::Fw;
using gs::w32::kLimbs;
using gs::w32::lane_words;
using gs::w32::load_coef;
using gs::w32::store_coef;

// The grouped kernels: threads a lane, and lanes a block.
constexpr int kFq12MulGroup = 16;
constexpr int kCycPowGroup = 32;
constexpr int kCycSqrGroup = 4;
constexpr int kDblGroup = 8;
constexpr int kAddGroup = 8;
constexpr int kPowDynGroup = 16;
constexpr int kDblStepGroup = 4;
constexpr int kAddStepGroup = 8;
constexpr int kGroupLanes = 8;

// cyc_pow's and f12_pow_dyn's slots: a, two accumulators, the leaves, the
// Fq6 values;
// fq12_mul's: a, b, the product, the leaves, the Fq6 values;
// cyc_sqr's: a, the square, the nine Fq2 squares.
constexpr int kCycPowSlots = 12 + 12 + 12 + 54 + 18;
constexpr int kFq12MulSlots = 12 + 12 + 12 + 54 + 18;
constexpr int kCycSqrSlots = 12 + 12 + 18;
// pow_body's slots in that layout
constexpr int kPowX = 0, kPowAcc = 12, kPowTmp = 24, kPowLeaf = 36,
              kPowT6 = 90;

// a b post-reduced (tower_w32.cuh f12_mul: 54 Karatsuba leaves, nine Fq6
// values, 12 post-reduced coefficients), bound(a) bound(b) <= 1024 p^2. A
// group of G threads works a lane. a == b (fq12_sqr) loads a once and
// squares it through the same slots (f12_mul with B = A: each leaf's
// operand sum made once).
template <int G>
__global__ void __launch_bounds__(kGroupLanes * G)
fq12_mul_kernel(const __grid_constant__ TowerW t, const int64_t* a,
                const int64_t* b, int64_t* out, int64_t m) {
  extern __shared__ uint32_t smem[];
  const int rank = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kGroupLanes + rank;
  if (lane >= m) return;
  const auto grp =
      gs::tw::group_of<G>(smem + rank * lane_words(kFq12MulSlots));
  constexpr int A = 0, B = 12, OUT = 24, LEAF = 36, T6 = 90;
  const bool sqr = a == b;
  gs::tw::level(grp, sqr ? 12 : 24, [&](int k) {
    grp.st(A + k, load_coef(k < 12 ? a : b, 12, k % 12, m, lane));
  });
  gs::tw::f12_mul(t, grp, A, sqr ? A : B, OUT, LEAF, T6);
  gs::tw::level(grp, 12, [&](int c) {
    store_coef(out, 12, c, m, lane, grp.ld(OUT + c));
  });
}

// The square-and-multiply of cyc_pow and f12_pow_dyn
// (pallas_tower._cyc_pow_kernel, _f12_pow_dyn_kernel): from the Fq12 one
// (R mod p in coefficient 0), over the exponent's bits MSB first, leading
// zeros included, each round a post-reduced square of cur into tmp (E's
// square) and, on a set bit, a post-reduced product of tmp and a into cur;
// on a clear bit the two slot indices swap. The exponent is E::kLimbs
// limbs of E::kLimbBits bits, each read once (E's limb); the bit is the
// same for every thread of the group, so the branch does not diverge. A
// group of G threads works a lane (tower_w32.cuh), in kCycPowSlots slots.
template <int G, class E>
__device__ __forceinline__ void pow_body(const TowerW& t, const int64_t* a,
                                         const E& e, int64_t* out,
                                         int64_t m) {
  extern __shared__ uint32_t smem[];
  const int rank = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kGroupLanes + rank;
  if (lane >= m) return;
  const auto grp = gs::tw::group_of<G>(smem + rank * lane_words(kCycPowSlots));
  gs::tw::level(grp, 12, [&](int c) {
    grp.st(kPowX + c, load_coef(a, 12, c, m, lane));
    Fw z = gs::tw::words_of(t.f.one);
    if (c != 0) z = Fw{};
    grp.st(kPowAcc + c, z);
  });
  int cur = kPowAcc, tmp = kPowTmp;
#pragma unroll 1
  for (int i = E::kLimbs - 1; i >= 0; --i) {
    const uint64_t limb = e.limb(i, m, lane);
#pragma unroll 1
    for (int b = E::kLimbBits - 1; b >= 0; --b) {
      e.square(t, grp, cur, tmp);
      if ((limb >> b) & 1) {
        gs::tw::f12_mul(t, grp, tmp, kPowX, cur, kPowLeaf, kPowT6);
      } else {
        const int s = cur;
        cur = tmp;
        tmp = s;
      }
    }
  }
  gs::tw::level(grp, 12, [&](int c) {
    store_coef(out, 12, c, m, lane, grp.ld(cur + c));
  });
}

// cyc_pow's exponent: a static e < 2^64, one limb of 64 bits; its square
// the post-reduced cyclotomic one (a^e for a in the cyclotomic subgroup).
struct CycExp {
  static constexpr int kLimbs = 1;
  static constexpr int kLimbBits = 64;
  uint64_t e;
  __device__ __forceinline__ uint64_t limb(int, int64_t, int64_t) const {
    return e;
  }
  template <class Grp>
  __device__ __forceinline__ void square(const TowerW& t, const Grp& grp,
                                         int a, int out) const {
    gs::tw::cyc_sqr(t, grp, a, out, kPowLeaf);
  }
};

// a^e for a static e < 2^64 (pallas_tower._cyc_pow_kernel): 64 rounds of
// pow_body.
template <int G>
__global__ void __launch_bounds__(kGroupLanes * G)
cyc_pow_kernel(const __grid_constant__ TowerW t, const int64_t* a,
               uint64_t e, int64_t* out, int64_t m) {
  pow_body<G>(t, a, CycExp{e}, out, m);
}

// One Granger-Scott cyclotomic square (_cyc_sqr_kernel), post-reduced to
// < 2p; inputs < 2p. A group of G threads works a lane, in the two levels
// of tower_w32.cuh cyc_sqr (cyc_pow's square): 18 products, then 12. Each
// coefficient is read once and written once, a lane's 25 limbs of it by
// one thread.
template <int G>
__global__ void __launch_bounds__(kGroupLanes * G)
cyc_sqr_kernel(const __grid_constant__ TowerW t, const int64_t* a,
               int64_t* out, int64_t m) {
  extern __shared__ uint32_t smem[];
  const int rank = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kGroupLanes + rank;
  if (lane >= m) return;
  const auto grp = gs::tw::group_of<G>(smem + rank * lane_words(kCycSqrSlots));
  constexpr int A = 0, OUT = 12, SQ = 24;
  gs::tw::level(grp, 12, [&](int c) {
    grp.st(A + c, load_coef(a, 12, c, m, lane));
  });
  gs::tw::cyc_sqr(t, grp, A, OUT, SQ);
  gs::tw::level(grp, 12, [&](int c) {
    store_coef(out, 12, c, m, lane, grp.ld(OUT + c));
  });
}

// One Miller doubling iteration (_miller_iter_dbl_kernel): f <- f^2 *
// line_{R,R}(P), R <- 2R. f < 2p; R = (X, Y, Z) with X, Z < 2p, Y < 10p;
// P = (px, py) < p. Outputs: f < 2p and R in the same bounds. A group of G
// threads works a lane, in the six levels of tower_w32.cuh miller_dbl.
template <int G>
__global__ void __launch_bounds__(kGroupLanes * G)
miller_iter_dbl_kernel(const __grid_constant__ TowerW t, const int64_t* fin,
                       const int64_t* xin, const int64_t* yin,
                       const int64_t* zin, const int64_t* pxin,
                       const int64_t* pyin, int64_t* fout, int64_t* xout,
                       int64_t* yout, int64_t* zout, int64_t m) {
  using S = gs::tw::DblSlots;
  extern __shared__ uint32_t smem[];
  const int rank = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kGroupLanes + rank;
  if (lane >= m) return;
  const auto grp = gs::tw::group_of<G>(smem + rank * lane_words(S::kSlots));
  gs::tw::level(grp, 20, [&](int k) {      // f, X, Y, Z, px, py
    if (k < 12) {
      grp.st(S::kF + k, load_coef(fin, 12, k, m, lane));
    } else if (k < 18) {
      const int64_t* c = k < 14 ? xin : k < 16 ? yin : zin;
      grp.st(S::kPt + k - 12, load_coef(c, 2, k % 2, m, lane));
    } else {
      grp.st(S::kPt + k - 12, load_coef(k == 18 ? pxin : pyin, 1, 0, m, lane));
    }
  });
  gs::tw::miller_dbl(t, grp, [&](gs::tw::DblOut kind, int c, const Fw& v) {
    if (kind == gs::tw::kOutF)
      store_coef(fout, 12, c, m, lane, v);
    else
      store_coef(kind == gs::tw::kOutX ? xout
             : kind == gs::tw::kOutY ? yout : zout, 2, c, m, lane, v);
  });
}

// One Miller addition iteration (_miller_iter_add_kernel): f <- f *
// line_{R,Q}(P), R <- R + Q, with Q = (xq, yq) affine. f < 2p; X, Z < 2p,
// Y < 10p; Q, P < p. Outputs: f < 2p, X3, Z3 < 2p, Y3 < 4p. A group of G
// threads works a lane, in the levels of tower_w32.cuh miller_add.
template <int G>
__global__ void __launch_bounds__(kGroupLanes * G)
miller_iter_add_kernel(const __grid_constant__ TowerW t, const int64_t* fin,
                       const int64_t* xin, const int64_t* yin,
                       const int64_t* zin, const int64_t* xqin,
                       const int64_t* yqin, const int64_t* pxin,
                       const int64_t* pyin, int64_t* fout, int64_t* xout,
                       int64_t* yout, int64_t* zout, int64_t m) {
  using S = gs::tw::AddSlots;
  extern __shared__ uint32_t smem[];
  const int rank = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kGroupLanes + rank;
  if (lane >= m) return;
  const auto grp = gs::tw::group_of<G>(smem + rank * lane_words(S::kSlots));
  gs::tw::level(grp, 24, [&](int k) {      // f, X, Y, Z, xq, yq, px, py
    if (k < 12) {
      grp.st(S::kF + k, load_coef(fin, 12, k, m, lane));
    } else if (k < 22) {
      const int64_t* c = k < 14 ? xin : k < 16 ? yin : k < 18 ? zin
                       : k < 20 ? xqin : yqin;
      grp.st(S::kPt + k - 12, load_coef(c, 2, k % 2, m, lane));
    } else {
      grp.st(S::kPt + k - 12, load_coef(k == 22 ? pxin : pyin, 1, 0, m, lane));
    }
  });
  gs::tw::miller_add(t, grp, [&](gs::tw::DblOut kind, int c, const Fw& v) {
    if (kind == gs::tw::kOutF)
      store_coef(fout, 12, c, m, lane, v);
    else
      store_coef(kind == gs::tw::kOutX ? xout
             : kind == gs::tw::kOutY ? yout : zout, 2, c, m, lane, v);
  });
}

// A Miller step's out(kind, c, v): component c of X3, Y3, Z3, l0, l1, l2
// to the lane's six Fq2 outputs.
struct StepOut {
  int64_t *x, *y, *z, *l0, *l1, *l2;
  int64_t m, lane;
  __device__ __forceinline__ void operator()(gs::tw::DblOut kind, int c,
                                             const Fw& v) const {
    using namespace gs::tw;
    store_coef(kind == kOutX ? x : kind == kOutY ? y : kind == kOutZ ? z
               : kind == kOutL0 ? l0 : kind == kOutL1 ? l1 : l2,
               2, c, m, lane, v);
  }
};

// The Miller doubling step alone (_miller_dbl_kernel): R <- 2R and the
// line (l0, l1, l2) = (i, 3j, -h), not yet scaled by P. R = (X, Y, Z) with
// X, Z < 2p, Y < 10p; outputs X3, Z3 < 2p, Y3 < 10p, l0 < 50p, l1 < 6p,
// l2 < 8p. A group of G threads works a lane, in the five levels of
// tower_w32.cuh miller_dbl_step (the iteration's point levels).
template <int G>
__global__ void __launch_bounds__(kGroupLanes * G)
miller_dbl_step_kernel(const __grid_constant__ TowerW t, const int64_t* xin,
                       const int64_t* yin, const int64_t* zin,
                       int64_t* xout, int64_t* yout, int64_t* zout,
                       int64_t* l0out, int64_t* l1out, int64_t* l2out,
                       int64_t m) {
  using S = gs::tw::DblStepSlots;
  extern __shared__ uint32_t smem[];
  const int rank = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kGroupLanes + rank;
  if (lane >= m) return;
  const auto grp = gs::tw::group_of<G>(smem + rank * lane_words(S::kSlots));
  gs::tw::level(grp, 6, [&](int k) {       // X, Y, Z
    const int64_t* c = k < 2 ? xin : k < 4 ? yin : zin;
    grp.st(S::kPt + k, load_coef(c, 2, k % 2, m, lane));
  });
  gs::tw::miller_dbl_step(
      t, grp, StepOut{xout, yout, zout, l0out, l1out, l2out, m, lane});
}

// The Miller addition step alone (_miller_add_kernel): R <- R + Q with Q
// = (xq, yq) affine, and the line (l0, l1, l2) = (j, -theta, lambda), not
// yet scaled by P. X, Z < 2p, Y < 10p, Q < p; outputs X3, Z3 < 2p,
// Y3 < 4p, l0 < 4p, l1 < 16p, l2 < 4p. A group of G threads works a lane,
// in the levels of tower_w32.cuh miller_add_step (the addition
// iteration's point levels).
template <int G>
__global__ void __launch_bounds__(kGroupLanes * G)
miller_add_step_kernel(const __grid_constant__ TowerW t, const int64_t* xin,
                       const int64_t* yin, const int64_t* zin,
                       const int64_t* xqin, const int64_t* yqin,
                       int64_t* xout, int64_t* yout, int64_t* zout,
                       int64_t* l0out, int64_t* l1out, int64_t* l2out,
                       int64_t m) {
  using S = gs::tw::AddStepSlots;
  extern __shared__ uint32_t smem[];
  const int rank = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kGroupLanes + rank;
  if (lane >= m) return;
  const auto grp = gs::tw::group_of<G>(smem + rank * lane_words(S::kSlots));
  gs::tw::level(grp, 10, [&](int k) {      // X, Y, Z, xq, yq
    const int64_t* c = k < 2 ? xin : k < 4 ? yin : k < 6 ? zin
                     : k < 8 ? xqin : yqin;
    grp.st(S::kPt + k, load_coef(c, 2, k % 2, m, lane));
  });
  gs::tw::miller_add_step(
      t, grp, StepOut{xout, yout, zout, l0out, l1out, l2out, m, lane});
}

constexpr int kScalarLimbs = 17;               // Fr standard-form limbs

// f12_pow_dyn's exponent: a per-lane scalar s of 17 standard-form 16-bit
// limbs (Fr scalars [17, M]), 272 bits; its square the post-reduced
// generic one (_f12_sqr_red = _f12_mul_red(acc, acc): f12_mul with B = A).
// The reference always multiplies and then selects (_f12_select); on a
// clear bit the select keeps the square, so taking the square there and
// skipping the product gives the same limbs.
struct DynExp {
  static constexpr int kLimbs = kScalarLimbs;
  static constexpr int kLimbBits = 16;
  const int64_t* s;
  __device__ __forceinline__ uint64_t limb(int i, int64_t m,
                                           int64_t lane) const {
    return static_cast<uint32_t>(s[i * m + lane]);
  }
  template <class Grp>
  __device__ __forceinline__ void square(const TowerW& t, const Grp& grp,
                                         int a, int out) const {
    gs::tw::f12_mul(t, grp, a, a, out, kPowLeaf, kPowT6);
  }
};

// a^s for a per-lane scalar s (pallas_tower._f12_pow_dyn_kernel): 272
// rounds of pow_body.
template <int G>
__global__ void __launch_bounds__(kGroupLanes * G)
f12_pow_dyn_kernel(const __grid_constant__ TowerW t, const int64_t* a,
                   const int64_t* s, int64_t* out, int64_t m) {
  pow_body<G>(t, a, DynExp{s}, out, m);
}

unsigned group_grid_of(int64_t m) {
  return static_cast<unsigned>((m + kGroupLanes - 1) / kGroupLanes);
}

// Once per kernel: allow its dynamic shared memory above 48 KB, and ask
// for the largest shared-memory carve-out of the SM, so that four blocks
// fit.
template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e != cudaSuccess
      ? e
      : cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
}

// One launch of the grouped kernel kKernel (G threads a lane, kGroupLanes
// lanes a block, kSlots Fq slots of shared memory a lane) over m lanes,
// with the launch's constants t and the kernel's pointers args, then m.
template <int G, int kSlots, auto kKernel, class... A>
int launch_group(int64_t m, void* stream, const TowerW& t, A... args) {
  constexpr int bytes = kGroupLanes * lane_words(kSlots) * 4;
  static const cudaError_t attr = allow_smem(kKernel, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kKernel<<<group_grid_of(m), kGroupLanes * G, bytes,
            static_cast<cudaStream_t>(stream)>>>(t, args..., m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gs_fq12_mul(int nl, const int64_t* a, const int64_t* b, int64_t* out,
                int64_t m, const uint32_t* p, const uint32_t* one,
                uint32_t n0, void* stream) {
  if (nl != kLimbs) return -1;
  constexpr int G = kFq12MulGroup;
  return launch_group<G, kFq12MulSlots, fq12_mul_kernel<G>>(
      m, stream, gs::tw::make_tower_w(p, one, n0, nullptr), a, b, out);
}

int gs_cyc_pow(int nl, const int64_t* a, uint64_t e, int64_t* out, int64_t m,
               const uint32_t* p, const uint32_t* one, uint32_t n0,
               void* stream) {
  if (nl != kLimbs) return -1;
  constexpr int G = kCycPowGroup;
  return launch_group<G, kCycPowSlots, cyc_pow_kernel<G>>(
      m, stream, gs::tw::make_tower_w(p, one, n0, nullptr), a, e, out);
}

int gs_cyc_sqr(int nl, const int64_t* a, int64_t* out, int64_t m,
               const uint32_t* p, const uint32_t* one, uint32_t n0,
               void* stream) {
  if (nl != kLimbs) return -1;
  constexpr int G = kCycSqrGroup;
  return launch_group<G, kCycSqrSlots, cyc_sqr_kernel<G>>(
      m, stream, gs::tw::make_tower_w(p, one, n0, nullptr), a, out);
}

int gs_miller_iter_dbl(int nl, const int64_t* fin, const int64_t* xin,
                       const int64_t* yin, const int64_t* zin,
                       const int64_t* px, const int64_t* py, int64_t* fout,
                       int64_t* xout, int64_t* yout, int64_t* zout,
                       int64_t m, const uint32_t* p, const uint32_t* one,
                       const uint32_t* tinv, uint32_t n0, void* stream) {
  if (nl != kLimbs) return -1;
  constexpr int G = kDblGroup;
  return launch_group<G, gs::tw::DblSlots::kSlots, miller_iter_dbl_kernel<G>>(
      m, stream, gs::tw::make_tower_w(p, one, n0, tinv), fin, xin, yin, zin,
      px, py, fout, xout, yout, zout);
}

int gs_miller_iter_add(int nl, const int64_t* fin, const int64_t* xin,
                       const int64_t* yin, const int64_t* zin,
                       const int64_t* xq, const int64_t* yq,
                       const int64_t* px, const int64_t* py, int64_t* fout,
                       int64_t* xout, int64_t* yout, int64_t* zout,
                       int64_t m, const uint32_t* p, const uint32_t* one,
                       uint32_t n0, void* stream) {
  if (nl != kLimbs) return -1;
  constexpr int G = kAddGroup;
  return launch_group<G, gs::tw::AddSlots::kSlots, miller_iter_add_kernel<G>>(
      m, stream, gs::tw::make_tower_w(p, one, n0, nullptr), fin, xin, yin,
      zin, xq, yq, px, py, fout, xout, yout, zout);
}

int gs_f12_pow_dyn(int nl, int ns, const int64_t* a, const int64_t* s,
                   int64_t* out, int64_t m, const uint32_t* p,
                   const uint32_t* one, uint32_t n0, void* stream) {
  if (nl != kLimbs || ns != kScalarLimbs) return -1;
  constexpr int G = kPowDynGroup;
  return launch_group<G, kCycPowSlots, f12_pow_dyn_kernel<G>>(
      m, stream, gs::tw::make_tower_w(p, one, n0, nullptr), a, s, out);
}

int gs_miller_dbl_step(int nl, const int64_t* xin, const int64_t* yin,
                       const int64_t* zin, int64_t* xout, int64_t* yout,
                       int64_t* zout, int64_t* l0, int64_t* l1, int64_t* l2,
                       int64_t m, const uint32_t* p, const uint32_t* one,
                       const uint32_t* tinv, uint32_t n0, void* stream) {
  if (nl != kLimbs) return -1;
  constexpr int G = kDblStepGroup;
  return launch_group<G, gs::tw::DblStepSlots::kSlots,
                      miller_dbl_step_kernel<G>>(
      m, stream, gs::tw::make_tower_w(p, one, n0, tinv), xin, yin, zin, xout,
      yout, zout, l0, l1, l2);
}

int gs_miller_add_step(int nl, const int64_t* xin, const int64_t* yin,
                       const int64_t* zin, const int64_t* xq,
                       const int64_t* yq, int64_t* xout, int64_t* yout,
                       int64_t* zout, int64_t* l0, int64_t* l1, int64_t* l2,
                       int64_t m, const uint32_t* p, const uint32_t* one,
                       uint32_t n0, void* stream) {
  if (nl != kLimbs) return -1;
  constexpr int G = kAddStepGroup;
  return launch_group<G, gs::tw::AddStepSlots::kSlots,
                      miller_add_step_kernel<G>>(
      m, stream, gs::tw::make_tower_w(p, one, n0, nullptr), xin, yin, zin, xq,
      yq, xout, yout, zout, l0, l1, l2);
}

}  // extern "C"
