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
// All run the complete projective law of curve.cuh, for G1 (ns = 1, Fq
// coordinates) or G2 (ns = 2, Fq2 coordinates). cmadd and cdbl_n_add carry
// Curve.scalar_mul: its 2^4-entry window table is built with 14 cmadd
// launches, and each of its 64 window steps is one cdbl_n_add launch with
// n_dbl = 4. The Pippenger MSM (ops/msm.py) runs one cmsm_row_scan over its
// sorted point stream, cadd for the lane prefix, the prefix lookups, the
// bucket differences and the window folds, and one cdbl_n_add per window
// (n_dbl = the window) to combine the windows.
//
// Work split: one thread per lane, as in tower_kernels.cu; a G1 coordinate
// batch is int64 [25, M] (limb i of lane l at i M + l), a G2 coordinate
// batch [25, 2, M], the affine infinity flags one byte per lane, so the
// threads of a warp read neighbouring words. Blocks of 32 threads spread
// the lanes of a call over the SMs. The row scan keeps the order of its
// rows inside each thread: Hopper has no ordered grid axis to carry the
// accumulator across (the TPU kernel's sequential grid and VMEM scratch),
// so a thread walks its lane's rows in a loop with the accumulator in
// local memory, reading row r of its lane and writing its prefix.
//
// What bounds them on the H100: per lane and launch cmadd makes 11
// Montgomery products on G1 (55 on G2), cadd 12 (60), cdbl_n_add with
// n_dbl = 4 makes 4 x 8 + 12 = 44 (220), the row scan 11 (55) per row, each
// 1,250 16x16-bit multiply-adds, against 0.9 KB (1.8 KB) of int64 limbs
// moved per add: all are bound by the multiplier. At the few thousand
// lanes of the scalar multiplications one thread per lane leaves most of
// the card idle, and each thread's dependent chain of products, out of
// local memory, sets the time; the MSM's cadd calls reach millions of
// lanes.
//
// Plain C interface for ctypes. Each entry point returns cudaGetLastError()
// after its launch (0 = success), or -1 for a limb count other than 25 or
// a structure count other than 1 or 2.
#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"
#include "field.cuh"

namespace {

using gs::curve::FieldQ;
using gs::curve::Fq2A;
using gs::curve::FqA;
using gs::curve::N;

constexpr int kThreads = 32;

// Complete projective + affine add: (X1 : Y1 : Z1) + (x2, y2), the
// accumulator unchanged where the affine point is at infinity.
template <class F>
__global__ void __launch_bounds__(kThreads)
cmadd_kernel(const __grid_constant__ FieldQ f, const int64_t* X1,
             const int64_t* Y1, const int64_t* Z1, const int64_t* x2,
             const int64_t* y2, const uint8_t* ainf, int64_t* oX,
             int64_t* oY, int64_t* oZ, int64_t m) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= m) return;
  typename F::T X, Y, Z, x, y, X3, Y3, Z3;
  F::load(X1, m, lane, X);
  F::load(Y1, m, lane, Y);
  F::load(Z1, m, lane, Z);
  F::load(x2, m, lane, x);
  F::load(y2, m, lane, y);
  gs::curve::cmadd_body<F>(f, X, Y, Z, x, y, ainf[lane] != 0, X3, Y3, Z3);
  F::store(oX, m, lane, X3);
  F::store(oY, m, lane, Y3);
  F::store(oZ, m, lane, Z3);
}

// Complete projective add P + Q (coordinates < 4p in and out).
template <class F>
__global__ void __launch_bounds__(kThreads)
cadd_kernel(const __grid_constant__ FieldQ f, const int64_t* X1,
            const int64_t* Y1, const int64_t* Z1, const int64_t* X2,
            const int64_t* Y2, const int64_t* Z2, int64_t* oX, int64_t* oY,
            int64_t* oZ, int64_t m) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= m) return;
  typename F::T X, Y, Z, Xq, Yq, Zq, X3, Y3, Z3;
  F::load(X1, m, lane, X);
  F::load(Y1, m, lane, Y);
  F::load(Z1, m, lane, Z);
  F::load(X2, m, lane, Xq);
  F::load(Y2, m, lane, Yq);
  F::load(Z2, m, lane, Zq);
  gs::curve::cadd_body<F>(f, X, Y, Z, Xq, Yq, Zq, X3, Y3, Z3);
  F::store(oX, m, lane, X3);
  F::store(oY, m, lane, Y3);
  F::store(oZ, m, lane, Z3);
}

// The point at infinity (0 : 1 : 0), 1 in Montgomery form.
__device__ __forceinline__ void set_inf(const FieldQ& f, gs::tower::Fp& X,
                                        gs::tower::Fp& Y, gs::tower::Fp& Z) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    X[i] = 0;
    Y[i] = f.one[i];
    Z[i] = 0;
  }
}

__device__ __forceinline__ void set_inf(const FieldQ& f, gs::tower::Fp2& X,
                                        gs::tower::Fp2& Y,
                                        gs::tower::Fp2& Z) {
  set_inf(f, X[0], Y[0], Z[0]);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    X[1][i] = 0;
    Y[1][i] = 0;
    Z[1][i] = 0;
  }
}

// Lane `lane` of one row of the raw prefix stream, (cr, M): an Fq value's
// 25 limb rows; an Fq2 value's c0 rows, then its c1 rows (the reference's
// raw layout, pallas_curve.cmsm_row_scan).
__device__ __forceinline__ void store_raw(int64_t* dst, int64_t m,
                                          int64_t lane,
                                          const gs::tower::Fp& x) {
  FqA::store(dst, m, lane, x);
}

__device__ __forceinline__ void store_raw(int64_t* dst, int64_t m,
                                          int64_t lane,
                                          const gs::tower::Fp2& x) {
  FqA::store(dst, m, lane, x[0]);
  FqA::store(dst + N * m, m, lane, x[1]);
}

// The running prefix of complete mixed adds down each lane's rows, from
// (0 : 1 : 0): row r of lane l is the sum of the lane's affine points in
// rows 0..r (a point with its flag set adds nothing). Inputs: x, y in the
// point layout with the row axis before the lanes ([25, rows, M] for G1,
// [25, 2, rows, M] for G2), flags [rows, M]. Outputs: the prefix stream
// (X, Y, Z), each [rows, cr, M] with cr = 25 ns, and the lane totals
// (the last row) in the point layout [25, M] or [25, 2, M].
template <class F>
__global__ void __launch_bounds__(kThreads)
cmsm_row_scan_kernel(const __grid_constant__ FieldQ f, int rows,
                     const int64_t* x, const int64_t* y, const uint8_t* inf,
                     int64_t* oX, int64_t* oY, int64_t* oZ, int64_t* tX,
                     int64_t* tY, int64_t* tZ, int64_t m) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= m) return;
  constexpr int kRows = sizeof(typename F::T) / sizeof(uint32_t);  // cr
  const int64_t plane = static_cast<int64_t>(rows) * m;  // one limb row
  typename F::T X, Y, Z, px, py, X3, Y3, Z3;
  set_inf(f, X, Y, Z);
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const int64_t at = static_cast<int64_t>(r) * m;
    F::load(x + at, plane, lane, px);
    F::load(y + at, plane, lane, py);
    gs::curve::cmadd_body<F>(f, X, Y, Z, px, py, inf[at + lane] != 0, X3,
                             Y3, Z3);
    store_raw(oX + kRows * at, m, lane, X3);
    store_raw(oY + kRows * at, m, lane, Y3);
    store_raw(oZ + kRows * at, m, lane, Z3);
    F::copy(X3, X);
    F::copy(Y3, Y);
    F::copy(Z3, Z);
  }
  F::store(tX, m, lane, X);
  F::store(tY, m, lane, Y);
  F::store(tZ, m, lane, Z);
}

// n_dbl complete doublings of P, then P + Q, in one launch: a loop over
// one out-of-line doubling body (n_dbl is a run-time argument), then the
// complete add.
template <class F>
__global__ void __launch_bounds__(kThreads)
cdbl_n_add_kernel(const __grid_constant__ FieldQ f, int n_dbl,
                  const int64_t* X1, const int64_t* Y1, const int64_t* Z1,
                  const int64_t* X2, const int64_t* Y2, const int64_t* Z2,
                  int64_t* oX, int64_t* oY, int64_t* oZ, int64_t m) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= m) return;
  typename F::T X, Y, Z, A, B, C;
  F::load(X1, m, lane, X);
  F::load(Y1, m, lane, Y);
  F::load(Z1, m, lane, Z);
#pragma unroll 1
  for (int i = 0; i < n_dbl; ++i) {
    gs::curve::cdbl_body<F>(f, X, Y, Z, A, B, C);
    F::copy(A, X);
    F::copy(B, Y);
    F::copy(C, Z);
  }
  typename F::T Xq, Yq, Zq;
  F::load(X2, m, lane, Xq);
  F::load(Y2, m, lane, Yq);
  F::load(Z2, m, lane, Zq);
  gs::curve::cadd_body<F>(f, X, Y, Z, Xq, Yq, Zq, A, B, C);
  F::store(oX, m, lane, A);
  F::store(oY, m, lane, B);
  F::store(oZ, m, lane, C);
}

unsigned grid_of(int64_t m) {
  return static_cast<unsigned>((m + kThreads - 1) / kThreads);
}

template <class F>
int launch_cmadd(const FieldQ& f, const int64_t* X1, const int64_t* Y1,
                 const int64_t* Z1, const int64_t* x2, const int64_t* y2,
                 const uint8_t* ainf, int64_t* oX, int64_t* oY, int64_t* oZ,
                 int64_t m, cudaStream_t stream) {
  cmadd_kernel<F><<<grid_of(m), kThreads, 0, stream>>>(
      f, X1, Y1, Z1, x2, y2, ainf, oX, oY, oZ, m);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_cadd(const FieldQ& f, const int64_t* X1, const int64_t* Y1,
                const int64_t* Z1, const int64_t* X2, const int64_t* Y2,
                const int64_t* Z2, int64_t* oX, int64_t* oY, int64_t* oZ,
                int64_t m, cudaStream_t stream) {
  cadd_kernel<F><<<grid_of(m), kThreads, 0, stream>>>(
      f, X1, Y1, Z1, X2, Y2, Z2, oX, oY, oZ, m);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_cmsm_row_scan(const FieldQ& f, int rows, const int64_t* x,
                         const int64_t* y, const uint8_t* inf, int64_t* oX,
                         int64_t* oY, int64_t* oZ, int64_t* tX, int64_t* tY,
                         int64_t* tZ, int64_t m, cudaStream_t stream) {
  cmsm_row_scan_kernel<F><<<grid_of(m), kThreads, 0, stream>>>(
      f, rows, x, y, inf, oX, oY, oZ, tX, tY, tZ, m);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int launch_cdbl_n_add(const FieldQ& f, int n_dbl, const int64_t* X1,
                      const int64_t* Y1, const int64_t* Z1,
                      const int64_t* X2, const int64_t* Y2,
                      const int64_t* Z2, int64_t* oX, int64_t* oY,
                      int64_t* oZ, int64_t m, cudaStream_t stream) {
  cdbl_n_add_kernel<F><<<grid_of(m), kThreads, 0, stream>>>(
      f, n_dbl, X1, Y1, Z1, X2, Y2, Z2, oX, oY, oZ, m);
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
  const FieldQ f = gs::make_field<N>(p, one, n0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ns == 1
      ? launch_cmadd<FqA>(f, X1, Y1, Z1, x2, y2, ainf, oX, oY, oZ, m, s)
      : launch_cmadd<Fq2A>(f, X1, Y1, Z1, x2, y2, ainf, oX, oY, oZ, m, s);
}

int gs_cdbl_n_add(int nl, int ns, int n_dbl, const int64_t* X1,
                  const int64_t* Y1, const int64_t* Z1, const int64_t* X2,
                  const int64_t* Y2, const int64_t* Z2, int64_t* oX,
                  int64_t* oY, int64_t* oZ, int64_t m, const uint32_t* p,
                  const uint32_t* one, uint32_t n0, void* stream) {
  if (nl != N || (ns != 1 && ns != 2)) return -1;
  const FieldQ f = gs::make_field<N>(p, one, n0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ns == 1 ? launch_cdbl_n_add<FqA>(f, n_dbl, X1, Y1, Z1, X2, Y2, Z2,
                                          oX, oY, oZ, m, s)
                 : launch_cdbl_n_add<Fq2A>(f, n_dbl, X1, Y1, Z1, X2, Y2,
                                           Z2, oX, oY, oZ, m, s);
}

int gs_cadd(int nl, int ns, const int64_t* X1, const int64_t* Y1,
            const int64_t* Z1, const int64_t* X2, const int64_t* Y2,
            const int64_t* Z2, int64_t* oX, int64_t* oY, int64_t* oZ,
            int64_t m, const uint32_t* p, const uint32_t* one, uint32_t n0,
            void* stream) {
  if (nl != N || (ns != 1 && ns != 2)) return -1;
  const FieldQ f = gs::make_field<N>(p, one, n0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ns == 1
      ? launch_cadd<FqA>(f, X1, Y1, Z1, X2, Y2, Z2, oX, oY, oZ, m, s)
      : launch_cadd<Fq2A>(f, X1, Y1, Z1, X2, Y2, Z2, oX, oY, oZ, m, s);
}

int gs_cmsm_row_scan(int nl, int ns, int rows, const int64_t* x,
                     const int64_t* y, const uint8_t* inf, int64_t* oX,
                     int64_t* oY, int64_t* oZ, int64_t* tX, int64_t* tY,
                     int64_t* tZ, int64_t m, const uint32_t* p,
                     const uint32_t* one, uint32_t n0, void* stream) {
  if (nl != N || (ns != 1 && ns != 2)) return -1;
  const FieldQ f = gs::make_field<N>(p, one, n0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ns == 1 ? launch_cmsm_row_scan<FqA>(f, rows, x, y, inf, oX, oY, oZ,
                                             tX, tY, tZ, m, s)
                 : launch_cmsm_row_scan<Fq2A>(f, rows, x, y, inf, oX, oY,
                                              oZ, tX, tY, tZ, m, s);
}

}  // extern "C"
