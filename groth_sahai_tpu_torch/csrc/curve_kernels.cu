// The fused curve kernels of the port: Hopper (sm_90a) counterparts of two
// Pallas kernels of groth_sahai_tpu/ops/pallas_curve.py.
//
//   gs_cmadd      <- pallas_curve.cmadd (_cmadd_kernel, _cmadd_body)
//   gs_cdbl_n_add <- pallas_curve.cdbl_n_add (_cdbl_n_add_kernel:
//                    _cdbl_body n times, then _cadd_body)
//
// Both run the complete projective law of curve.cuh, for G1 (ns = 1, Fq
// coordinates) or G2 (ns = 2, Fq2 coordinates). They carry
// Curve.scalar_mul: its 2^4-entry window table is built with 14 cmadd
// launches, and each of its 64 window steps is one cdbl_n_add launch with
// n_dbl = 4. Every commitment, the prover's Com products and the
// verifier's Gamma d reach them through scalar_mul.
//
// Work split: one thread per lane, as in tower_kernels.cu; a G1 coordinate
// batch is int64 [25, M] (limb i of lane l at i M + l), a G2 coordinate
// batch [25, 2, M], the affine infinity flags one byte per lane, so the
// threads of a warp read neighbouring words. Blocks of 32 threads spread
// the lanes of a call over the SMs.
//
// What bounds them on the H100: per lane and launch cmadd makes 11
// Montgomery products on G1 (55 on G2) and cdbl_n_add with n_dbl = 4 makes
// 4 x 8 + 12 = 44 (220), each 1,250 16x16-bit multiply-adds, against 0.9 KB
// (1.8 KB) of int64 limbs moved: both are bound by the multiplier. At the
// few thousand lanes of their calls one thread per lane leaves most of the
// card idle, and each thread's dependent chain of products, out of local
// memory, sets the time.
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

}  // extern "C"
