// The fused curve kernels of the port: Hopper (sm_90a) counterparts of four
// Pallas kernels of groth_sahai_tpu/ops/pallas_curve.py.
//
//   gs_cmadd         <- pallas_curve.cmadd (_cmadd_kernel, _cmadd_body)
//   gs_cadd          <- pallas_curve.cadd (_cadd_kernel, _cadd_body)
//   gs_cdbl_n_add    <- pallas_curve.cdbl_n_add (_cdbl_n_add_kernel:
//                       _cdbl_body n times, then _cadd_body)
//   gs_cmsm_row_scan <- pallas_curve.cmsm_row_scan (_cmsm_scan_kernel: the
//                       running prefix of _cmadd_body down each lane)
//
// All run the complete projective law (RCB16, a = 0), for G1 (ns = 1, Fq
// coordinates) or G2 (ns = 2, Fq2 coordinates). cmadd and cdbl_n_add carry
// Curve.scalar_mul: its 2^4-entry window table is built with 14 cmadd
// launches, and each of its 64 window steps is one cdbl_n_add launch with
// n_dbl = 4. The Pippenger MSM (ops/msm.py) runs one cmsm_row_scan over its
// sorted point stream, cadd for the lane prefix, the prefix lookups, the
// bucket differences and the window folds, and one cdbl_n_add per window
// (n_dbl = the window) to combine the windows.
//
// Work split: a group of threads per lane for cmadd and cdbl_n_add, one
// thread per lane for cadd and cmsm_row_scan (below). A G1 coordinate
// batch is int64 [25, M] (limb i of lane l at i M + l), a G2 coordinate
// batch [25, 2, M], the affine infinity flags one byte per lane, so the
// threads of a warp read neighbouring words.
//
// cmadd and cdbl_n_add run at widths where one thread per lane leaves
// most of the card idle: cmadd builds each scalar multiplication's window
// table (14 launches in a row, each on the last one's output: 1336 G1 or
// G2 lanes for the commits, 4096 G1 lanes for scalar-mul-g1-4096, a few
// dozen to a few hundred on the prove paths), cdbl_n_add takes its 64
// window steps and verify-ppe-334's window combination (668 G2 lanes),
// msm-g1-65536's over one lane. There each lane's chain of dependent
// products sets the time: 11 a mixed add (55 on G2), 8 n + 12 for
// cdbl_n_add (x5 on G2). Their design (curve_group_w32.cuh over
// group_w32.cuh and field_w32.cuh) is for that bound: Fq as 13 packed
// words at R = 2^400 as below, and a group of G threads working each lane
// (G = kCdblGroupG1 = 4 on G1, kCdblGroupG2 = 16 on G2, for both), the
// lane's values in slots of the group's shared memory, the independent
// products of each level of the formulas taken side by side: a G2 mixed
// add is 5 rounds of products at G = 16 where one thread makes 55, a G2
// doubling 4 where one thread makes 40 (utils/curve_variants.py --groups
// times G = 2 to 32: no other G gains 1.3x on cmadd at its path shapes,
// where a launch takes 17-30 us). The mixed add shares the add's last two
// levels (add_finish) with cdbl_n_add. Blocks of kCdblLanes lanes; a ragged
// block's inactive lanes leave as whole groups.
//
// cadd and cmsm_row_scan carry the MSM's widest launches (up to 2.76 M G2
// lanes, and 85,504 G2 lanes x 128 rows at verify-ppe-334), where the card
// is full and the multiplier bounds them: 60 Montgomery products per G2
// add and 55 per G2 row against at most 1.8 KB of int64 limbs moved. Their
// design (curve_w32.cuh over field_w32.cuh) is for that bound:
//   * an Fq value is 13 packed 32-bit words, and a Montgomery product at
//     R = 2^400 is 12 CIOS steps of 2^32 plus one of 2^16 in PTX carry
//     chains, 650 word-product halves (multiply-adds) against 1,250; the
//     result is the same integer, so the limbs at the boundary do not
//     change;
//   * the bodies are inlined, so an add's working values stay in
//     registers, and call one out-of-line Montgomery product whose
//     operands and result pass in registers: one copy of its code serves
//     all 60 products of a G2 add (inlined at each, the kernels grew to
//     36,000-100,000 instructions and their fetch set the time); the values
//     that wait longest (the inputs, the row scan's accumulator, t3 and
//     t4) live in the thread's column of shared memory (Column, word i at
//     i B + thread), not in local memory (ptxas spills 32 B of the G2
//     row scan, no more);
//   * the row scan keeps its accumulator in shared memory across rows and
//     copies row r + 1's affine point (the low word of each int64 limb)
//     into its stage with cp.async as soon as row r's point is read,
//     so the copy runs under row r's last six products; the next row's
//     flag is loaded a row ahead;
//   * blocks of kWThreads = 64 threads; the shared memory of a block is
//     91 S words a thread for cadd, 102 S for the row scan (S = 1 on G1,
//     2 on G2), so on G2 four blocks (8 warps, the most that 255
//     registers a thread allow) fit an SM.
// Rows stay in order inside each lane: Hopper has no ordered grid axis to
// carry the accumulator across (the TPU kernel's sequential grid and VMEM
// scratch).
//
// Plain C interface for ctypes. Each entry point returns cudaGetLastError()
// after its launch (0 = success), or -1 for a limb count other than 25 or
// a structure count other than 1 or 2.
#include <cuda_runtime.h>

#include <cstdint>

#include "curve_group_w32.cuh"
#include "curve_w32.cuh"
#include "field_w32.cuh"
#include "group_w32.cuh"

namespace {

using gs::cw::CurveW;
using gs::w32::Column;
using gs::w32::FieldW;
using gs::w32::Fw;
using gs::w32::kWords;
using gs::w32::lane_words;

constexpr int N = gs::w32::kLimbs;   // 16-bit limbs at the boundary
constexpr int kWThreads = 64;   // cadd, cmsm_row_scan
// cdbl_n_add and cmadd: threads a lane on G1 and on G2, and lanes a block
constexpr int kCdblGroupG1 = 4;
constexpr int kCdblGroupG2 = 16;
constexpr int kCdblLanes = 8;

// Complete projective + affine add (cmadd): (X1 : Y1 : Z1) + (x2, y2),
// the accumulator unchanged where the affine point is at infinity; S Fq
// components a coordinate (accumulator < 4p, affine < 2p, out < 4p). A
// group of G threads works a lane, over its slots in shared memory
// (curve_group_w32.cuh cmadd). The flag is the lane's, so the whole group
// takes the same branch: a flagged lane copies its accumulator's limbs (the
// reference's select) and makes no product.
template <int S, int G>
__global__ void __launch_bounds__(kCdblLanes * G)
cmadd_kernel(const __grid_constant__ CurveW t, const int64_t* X1,
             const int64_t* Y1, const int64_t* Z1, const int64_t* x2,
             const int64_t* y2, const uint8_t* ainf, int64_t* oX,
             int64_t* oY, int64_t* oZ, int64_t m) {
  using L = gs::cw::CurveSlots<S>;
  extern __shared__ uint32_t smem[];
  const int rank = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kCdblLanes + rank;
  if (lane >= m) return;
  const auto grp = gs::w32::group_of<G>(smem + rank * lane_words(L::kSlots));
  if (ainf[lane] != 0) {
    constexpr int kRows = gs::w32::kLimbs * S;     // limb rows a coordinate
    gs::w32::level(grp, 3 * kRows, [&](int k) {
      const int c = k / kRows;
      const int64_t at = static_cast<int64_t>(k % kRows) * m + lane;
      (c == 0 ? oX : c == 1 ? oY : oZ)[at] = (c == 0 ? X1 : c == 1 ? Y1
                                                               : Z1)[at];
    });
    return;
  }
  gs::w32::level(grp, 5 * S, [&](int k) {      // P, then (x2, y2) at Q
    const int c = k / S;
    const int64_t* src = c == 0 ? X1 : c == 1 ? Y1 : c == 2 ? Z1
                       : c == 3 ? x2 : y2;
    grp.st(c < 3 ? L::kP + k : L::kQ + k - 3 * S,
           gs::w32::load_coef(src, S, k % S, m, lane));
  });
  gs::cw::cmadd<S>(t, grp, [&](int c, int u, const Fw& v) {
    gs::w32::store_coef(c == 0 ? oX : c == 1 ? oY : oZ, S, u, m, lane, v);
  });
}

// n_dbl complete doublings of P, then P + Q (cdbl_n_add), S Fq components
// a coordinate (coordinates < 4p in and out). A group of G threads works a
// lane, over its slots in shared memory (curve_group_w32.cuh); n_dbl is a
// run-time argument, the same for every lane, so no group diverges.
template <int S, int G>
__global__ void __launch_bounds__(kCdblLanes * G)
cdbl_n_add_kernel(const __grid_constant__ CurveW t, int n_dbl,
                  const int64_t* X1, const int64_t* Y1, const int64_t* Z1,
                  const int64_t* X2, const int64_t* Y2, const int64_t* Z2,
                  int64_t* oX, int64_t* oY, int64_t* oZ, int64_t m) {
  using L = gs::cw::CurveSlots<S>;
  extern __shared__ uint32_t smem[];
  const int rank = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kCdblLanes + rank;
  if (lane >= m) return;
  const auto grp = gs::w32::group_of<G>(smem + rank * lane_words(L::kSlots));
  gs::w32::level(grp, 7 * S, [&](int k) {      // P, Q, the zero coordinate
    const int c = k / S;
    if (c == 6) {
      grp.st(L::kZero + k % S, Fw{});
      return;
    }
    const int64_t* src = c == 0 ? X1 : c == 1 ? Y1 : c == 2 ? Z1
                       : c == 3 ? X2 : c == 4 ? Y2 : Z2;
    grp.st(c < 3 ? L::kP + k : L::kQ + k - 3 * S,
           gs::w32::load_coef(src, S, k % S, m, lane));
  });
  gs::cw::Pt p = gs::cw::loaded<S>(L::kP);
#pragma unroll 1
  for (int i = 0; i < n_dbl; ++i) p = gs::cw::cdbl<S>(t, grp, p);
  gs::cw::cadd<S>(t, grp, p, gs::cw::loaded<S>(L::kQ),
                  [&](int c, int u, const Fw& v) {
    gs::w32::store_coef(c == 0 ? oX : c == 1 ? oY : oZ, S, u, m, lane, v);
  });
}

// Complete projective add P + Q (coordinates < 4p in and out), S Fq
// components a coordinate. The shared memory of a block: 7 slots of 13 S
// words a thread (the two points, then scratch).
constexpr int kCaddWords = 7 * kWords;      // times S

template <int S>
__global__ void __launch_bounds__(kWThreads)
cadd_kernel(const __grid_constant__ FieldW f, const int64_t* X1,
            const int64_t* Y1, const int64_t* Z1, const int64_t* X2,
            const int64_t* Y2, const int64_t* Z2, int64_t* oX, int64_t* oY,
            int64_t* oZ, int64_t m) {
  extern __shared__ uint32_t smem[];
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kWThreads + threadIdx.x;
  if (lane >= m) return;
  const Column<kWThreads> col{smem + threadIdx.x};
  constexpr int V = kWords * S;
  const int64_t* in[6] = {X1, Y1, Z1, X2, Y2, Z2};
#pragma unroll
  for (int c = 0; c < 6; ++c)
    col.st<S>(c * V, gs::w32::gload<S>(in[c], m, lane));
  gs::w32::cadd_body<S>(f, col);
  gs::w32::gstore<S>(oX, m, lane, col.ld<S>(0));
  gs::w32::gstore<S>(oY, m, lane, col.ld<S>(V));
  gs::w32::gstore<S>(oZ, m, lane, col.ld<S>(2 * V));
}

// A 4-byte copy from global memory into this thread's shared memory that
// runs while the thread goes on (cp.async), and the fences of a group of
// them: commit closes the group, wait returns when every group landed.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The row scan's shared memory, in words a thread (times S): the stage
// (the next row's x then y as 25 S raw words each; once a row's point is
// packed, x2 at 0 and y2 at 13 S), then the accumulator X, Y, Z and one
// scratch slot at kScanAcc S (13 S words each).
constexpr int kScanAcc = 2 * gs::w32::kLimbs;
constexpr int kScanWords = kScanAcc + 4 * kWords;   // times S

// The running prefix of complete mixed adds down each lane's rows, from
// (0 : 1 : 0): row r of lane l is the sum of the lane's affine points in
// rows 0..r (a point with its flag set adds nothing: the lane skips the
// add). Inputs: x, y in the point layout with the row axis before the
// lanes ([25, rows, M] for G1, [25, 2, rows, M] for G2), flags [rows, M].
// Outputs: the prefix stream (X, Y, Z), each [rows, cr, M] with cr = 25 S,
// an Fq2 coordinate as its c0 limb rows then its c1 rows (the reference's
// raw layout); and the lane totals in the point layout [25, M] or
// [25, 2, M].
template <int S>
__global__ void __launch_bounds__(kWThreads)
cmsm_row_scan_kernel(const __grid_constant__ FieldW f, int rows,
                     const int64_t* x, const int64_t* y, const uint8_t* inf,
                     int64_t* oX, int64_t* oY, int64_t* oZ, int64_t* tX,
                     int64_t* tY, int64_t* tZ, int64_t m) {
  extern __shared__ uint32_t smem[];
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kWThreads + threadIdx.x;
  if (lane >= m) return;
  using gs::w32::Val;
  constexpr int kL = gs::w32::kLimbs;
  constexpr int V = kWords * S;
  constexpr int A = kScanAcc * S;                  // accumulator X, Y, Z
  constexpr int cr = kL * S;                       // rows of one coordinate
  const Column<kWThreads> col{smem + threadIdx.x};
  uint32_t* stage = smem + threadIdx.x;
  const int64_t plane = static_cast<int64_t>(rows) * m;   // one limb row
  // Row r's (x, y) limbs, low words, into the stage (raw word c cr + u 25
  // + i for coordinate c, component u, limb i).
  const auto fetch = [&](int r) {
    const int64_t at = static_cast<int64_t>(r) * m + lane;
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        const int64_t g = (i * S + u) * plane + at;
        cp_async4(stage + (u * kL + i) * kWThreads, x + g);
        cp_async4(stage + (cr + u * kL + i) * kWThreads, y + g);
      }
    }
    cp_async_commit();
  };
  // The stage's raw coordinate c, packed into slot `to`.
  const auto pack = [&](int c, int to) {
    Val<S> v;
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int i = c * cr + u * kL + 2 * k;
        v.c[u].w[k] = stage[i * kWThreads] |
            (2 * k + 1 < kL ? stage[(i + 1) * kWThreads] << 16 : 0u);
      }
    }
    col.st<S>(to, v);
  };
  Val<S> acc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        acc[c].c[u].w[k] = c == 1 && u == 0 ? f.one[k] : 0u;
    }
    col.st<S>(A + c * V, acc[c]);
  }
  fetch(0);
  uint8_t next_inf = inf[lane];
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const bool skip = next_inf != 0;
    const bool more = r + 1 < rows;
    if (more) next_inf = inf[static_cast<int64_t>(r + 1) * m + lane];
    cp_async_wait_all();
    if (skip) {
      if (more) fetch(r + 1);
    } else {
      pack(0, 0);
      pack(1, V);
      gs::w32::cmadd_body<S>(f, col, 0, V, A, [&] {
        if (more) fetch(r + 1);
      });
    }
    int64_t* out[3] = {oX, oY, oZ};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const Val<S> v = col.ld<S>(A + c * V);
#pragma unroll
      for (int u = 0; u < S; ++u)
        gs::w32::store_limbs_cs(
            out[c] + (static_cast<int64_t>(r) * cr + u * kL) * m, m, lane,
            v.c[u]);
    }
  }
  gs::w32::gstore<S>(tX, m, lane, col.ld<S>(A));
  gs::w32::gstore<S>(tY, m, lane, col.ld<S>(A + V));
  gs::w32::gstore<S>(tZ, m, lane, col.ld<S>(A + 2 * V));
}

// Once per kernel: allow its dynamic shared memory above 48 KB, and ask
// for the largest shared-memory carve-out of the SM's 256 KB, so that four
// blocks fit.
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

unsigned wgrid_of(int64_t m) {
  return static_cast<unsigned>((m + kWThreads - 1) / kWThreads);
}

template <int S>
int launch_cadd(const FieldW& f, const int64_t* X1, const int64_t* Y1,
                const int64_t* Z1, const int64_t* X2, const int64_t* Y2,
                const int64_t* Z2, int64_t* oX, int64_t* oY, int64_t* oZ,
                int64_t m, cudaStream_t stream) {
  constexpr int bytes = kCaddWords * S * 4 * kWThreads;
  static const cudaError_t attr = allow_smem(cadd_kernel<S>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cadd_kernel<S><<<wgrid_of(m), kWThreads, bytes, stream>>>(
      f, X1, Y1, Z1, X2, Y2, Z2, oX, oY, oZ, m);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_cmsm_row_scan(const FieldW& f, int rows, const int64_t* x,
                         const int64_t* y, const uint8_t* inf, int64_t* oX,
                         int64_t* oY, int64_t* oZ, int64_t* tX, int64_t* tY,
                         int64_t* tZ, int64_t m, cudaStream_t stream) {
  constexpr int bytes = kScanWords * S * 4 * kWThreads;
  static const cudaError_t attr = allow_smem(cmsm_row_scan_kernel<S>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cmsm_row_scan_kernel<S><<<wgrid_of(m), kWThreads, bytes, stream>>>(
      f, rows, x, y, inf, oX, oY, oZ, tX, tY, tZ, m);
  return static_cast<int>(cudaGetLastError());
}

template <int S, int G>
int launch_cdbl_n_add(const CurveW& t, int n_dbl, const int64_t* X1,
                      const int64_t* Y1, const int64_t* Z1,
                      const int64_t* X2, const int64_t* Y2,
                      const int64_t* Z2, int64_t* oX, int64_t* oY,
                      int64_t* oZ, int64_t m, cudaStream_t stream) {
  constexpr int bytes =
      kCdblLanes * lane_words(gs::cw::CurveSlots<S>::kSlots) * 4;
  static const cudaError_t attr = allow_smem(cdbl_n_add_kernel<S, G>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cdbl_n_add_kernel<S, G>
      <<<static_cast<unsigned>((m + kCdblLanes - 1) / kCdblLanes),
         kCdblLanes * G, bytes, stream>>>(t, n_dbl, X1, Y1, Z1, X2, Y2, Z2,
                                          oX, oY, oZ, m);
  return static_cast<int>(cudaGetLastError());
}

template <int S, int G>
int launch_cmadd(const CurveW& t, const int64_t* X1, const int64_t* Y1,
                 const int64_t* Z1, const int64_t* x2, const int64_t* y2,
                 const uint8_t* ainf, int64_t* oX, int64_t* oY, int64_t* oZ,
                 int64_t m, cudaStream_t stream) {
  constexpr int bytes =
      kCdblLanes * lane_words(gs::cw::CurveSlots<S>::kSlots) * 4;
  static const cudaError_t attr = allow_smem(cmadd_kernel<S, G>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cmadd_kernel<S, G>
      <<<static_cast<unsigned>((m + kCdblLanes - 1) / kCdblLanes),
         kCdblLanes * G, bytes, stream>>>(t, X1, Y1, Z1, x2, y2, ainf, oX,
                                          oY, oZ, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gs_cmadd(int nl, int ns, const int64_t* X1, const int64_t* Y1,
             const int64_t* Z1, const int64_t* x2, const int64_t* y2,
             const uint8_t* ainf, int64_t* oX, int64_t* oY, int64_t* oZ,
             int64_t m, const uint32_t* p, const uint32_t* one, uint32_t n0,
             void* stream) {
  if (nl != N || (ns != 1 && ns != 2)) return -1;
  const CurveW t = gs::cw::make_curve_w(p, one, n0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ns == 1
      ? launch_cmadd<1, kCdblGroupG1>(t, X1, Y1, Z1, x2, y2, ainf, oX, oY,
                                      oZ, m, s)
      : launch_cmadd<2, kCdblGroupG2>(t, X1, Y1, Z1, x2, y2, ainf, oX, oY,
                                      oZ, m, s);
}

int gs_cdbl_n_add(int nl, int ns, int n_dbl, const int64_t* X1,
                  const int64_t* Y1, const int64_t* Z1, const int64_t* X2,
                  const int64_t* Y2, const int64_t* Z2, int64_t* oX,
                  int64_t* oY, int64_t* oZ, int64_t m, const uint32_t* p,
                  const uint32_t* one, uint32_t n0, void* stream) {
  if (nl != N || (ns != 1 && ns != 2)) return -1;
  const CurveW t = gs::cw::make_curve_w(p, one, n0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ns == 1
      ? launch_cdbl_n_add<1, kCdblGroupG1>(t, n_dbl, X1, Y1, Z1, X2, Y2, Z2,
                                           oX, oY, oZ, m, s)
      : launch_cdbl_n_add<2, kCdblGroupG2>(t, n_dbl, X1, Y1, Z1, X2, Y2, Z2,
                                           oX, oY, oZ, m, s);
}

int gs_cadd(int nl, int ns, const int64_t* X1, const int64_t* Y1,
            const int64_t* Z1, const int64_t* X2, const int64_t* Y2,
            const int64_t* Z2, int64_t* oX, int64_t* oY, int64_t* oZ,
            int64_t m, const uint32_t* p, const uint32_t* one, uint32_t n0,
            void* stream) {
  if (nl != N || (ns != 1 && ns != 2)) return -1;
  const FieldW f = gs::w32::make_field_w(p, one, n0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ns == 1
      ? launch_cadd<1>(f, X1, Y1, Z1, X2, Y2, Z2, oX, oY, oZ, m, s)
      : launch_cadd<2>(f, X1, Y1, Z1, X2, Y2, Z2, oX, oY, oZ, m, s);
}

int gs_cmsm_row_scan(int nl, int ns, int rows, const int64_t* x,
                     const int64_t* y, const uint8_t* inf, int64_t* oX,
                     int64_t* oY, int64_t* oZ, int64_t* tX, int64_t* tY,
                     int64_t* tZ, int64_t m, const uint32_t* p,
                     const uint32_t* one, uint32_t n0, void* stream) {
  if (nl != N || (ns != 1 && ns != 2)) return -1;
  const FieldW f = gs::w32::make_field_w(p, one, n0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ns == 1 ? launch_cmsm_row_scan<1>(f, rows, x, y, inf, oX, oY, oZ,
                                           tX, tY, tZ, m, s)
                 : launch_cmsm_row_scan<2>(f, rows, x, y, inf, oX, oY, oZ,
                                           tX, tY, tZ, m, s);
}

}  // extern "C"
