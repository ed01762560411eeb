// In-thread complete mixed add (RCB16 Algorithm 8, a = 0) of the curve
// kernel cmadd, for G1 over Fq and G2 over Fq2.
//
// Port of the in-kernel curve math of groth_sahai_tpu/ops/pallas_curve.py:
// the field adapters _FqA and _Fq2A (here FqA and Fq2A) and the body
// _cmadd_body, written once as a template over its adapter. One thread
// owns one point: its coordinates are Fq (25 limbs) or Fq2 (2 x 25 limbs)
// values in the thread's local memory, as in tower.cuh. (The other bodies
// run on packed 32-bit words: curve_w32.cuh, curve_group_w32.cuh.)
//
// Representation: (X, Y, Z) homogeneous, x = X/Z, y = Y/Z, infinity
// (0 : y : 0); coordinates < 4p in and out of every body (the reference's
// invariant). Every product is a Montgomery product (< 2p); for Fq2 it is
// tower.cuh's f2_mulred, the reference's Karatsuba with its 2p offsets and
// both components post-reduced by R mod p (_Fq2A.mul). The b3 = 3b
// multiplications are small-constant products, not field products: x12 for
// G1 (b = 4), and for G2 (b' = 4(u + 1)) the xi twist first, then x12
// (_FqA.mul_b3, _Fq2A.mul_b3). Subtractions take the reference's k p
// offsets. Each step is a function of the integer values alone, so the
// plain versions in ops/cuda_curve.py, which stack independent products,
// give the same limbs.
#pragma once

#include <cstdint>

#include "field.cuh"
#include "tower.cuh"

namespace gs {
namespace curve {

using tower::FieldQ;
using tower::Fp;
using tower::Fp2;
using tower::N;

// Fq adapter (_FqA): values are Fq limbs; mul output < 2p.
struct FqA {
  using T = Fp;
  __device__ static __forceinline__ void mul(const FieldQ& f, const T& a,
                                             const T& b, T& c) {
    tower::mm(f, a, b, c);
  }
  __device__ static __forceinline__ void add(const T& a, const T& b, T& c) {
    gs::add<N>(a, b, c);
  }
  __device__ static __forceinline__ void dbl(const T& a, T& c) {
    gs::dbl<N>(a, c);
  }
  // a - b + k p; bound(b) <= k p (k <= 144 here: columns stay < 2^25).
  __device__ static __forceinline__ void sub(const FieldQ& f, const T& a,
                                             const T& b, uint32_t k, T& c) {
    sub_k<N>(a, b, k, f.p, c);
  }
  __device__ static __forceinline__ void select(bool m, const T& a,
                                                const T& b, T& c) {
    gs::select<N>(m, a, b, c);
  }
  // a 3b = 12 a (carry pass, no multiplier); k, the bound of a in units of
  // p, is unused for Fq. Output < 12 bound(a).
  __device__ static __forceinline__ void mul_b3(const FieldQ&, const T& a,
                                                uint32_t, T& c) {
    mul_small<N>(a, 12, c);
  }
  // Lane `lane` of an int64 [25, M] batch: limb i at i M + lane.
  __device__ static __forceinline__ void load(const int64_t* src, int64_t m,
                                              int64_t lane, T& x) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[i] = static_cast<uint32_t>(src[i * m + lane]);
  }
  __device__ static __forceinline__ void store(int64_t* dst, int64_t m,
                                               int64_t lane, const T& x) {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i * m + lane] = x[i];
  }
};

// Fq2 adapter (_Fq2A): values are (c0, c1); mul post-reduced to < 2p per
// component (shared bound audit with Fq).
struct Fq2A {
  using T = Fp2;
  __device__ static __forceinline__ void mul(const FieldQ& f, const T& a,
                                             const T& b, T& c) {
    tower::f2_mulred(f, a, b, c);
  }
  __device__ static __forceinline__ void add(const T& a, const T& b, T& c) {
    tower::f2_add(a, b, c);
  }
  __device__ static __forceinline__ void dbl(const T& a, T& c) {
    gs::dbl<N>(a[0], c[0]);
    gs::dbl<N>(a[1], c[1]);
  }
  __device__ static __forceinline__ void sub(const FieldQ& f, const T& a,
                                             const T& b, uint32_t k, T& c) {
    tower::f2_sub(f, a, b, k, c);
  }
  __device__ static __forceinline__ void select(bool m, const T& a,
                                                const T& b, T& c) {
    gs::select<N>(m, a[0], b[0], c[0]);
    gs::select<N>(m, a[1], b[1], c[1]);
  }
  // a 3b' = 12 (u + 1) a: the xi twist, then x12. bound(a) <= k p per
  // component; output components < 24 (bound(a) + k p) -- callers audit.
  __device__ static __forceinline__ void mul_b3(const FieldQ& f, const T& a,
                                                uint32_t k, T& c) {
    T t;
    sub_k<N>(a[0], a[1], k, f.p, t[0]);
    gs::add<N>(a[0], a[1], t[1]);
    mul_small<N>(t[0], 12, c[0]);
    mul_small<N>(t[1], 12, c[1]);
  }
  // Lane `lane` of an int64 [25, 2, M] batch: limb i of component u at
  // (2 i + u) M + lane.
  __device__ static __forceinline__ void load(const int64_t* src, int64_t m,
                                              int64_t lane, T& x) {
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        x[u][i] = static_cast<uint32_t>(src[(i * 2 + u) * m + lane]);
    }
  }
  __device__ static __forceinline__ void store(int64_t* dst, int64_t m,
                                               int64_t lane, const T& x) {
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int i = 0; i < N; ++i) dst[(i * 2 + u) * m + lane] = x[u][i];
    }
  }
};

// The three products that close every body (RCB16):
//   X3 = t3 t1 - t4 Y3 (< 4p), Y3 = t1 Z3 + Y3 t0 (< 4p),
//   Z3 = Z3 t4 + t0 t3 (< 4p).
// In: t3 < 6p, t1 and Z3 < 98p, t4 < 6p, Y3 < 144p, t0 < 6p. Y3 and Z3
// are read, then overwritten.
template <class F>
__device__ __forceinline__ void finish(const FieldQ& f,
                                       const typename F::T& t0,
                                       const typename F::T& t1,
                                       const typename F::T& t3,
                                       const typename F::T& t4,
                                       typename F::T& X3, typename F::T& Y3,
                                       typename F::T& Z3) {
  typename F::T u, v;
  F::mul(f, t3, t1, u);
  F::mul(f, t4, Y3, v);
  F::sub(f, u, v, 2, X3);                      // < 4p
  F::mul(f, t1, Z3, u);
  F::mul(f, Y3, t0, v);
  F::add(u, v, Y3);                            // < 4p
  F::mul(f, Z3, t4, u);
  F::mul(f, t0, t3, v);
  F::add(u, v, Z3);                            // < 4p
}

// Complete mixed add (_cmadd_body): acc (X1 : Y1 : Z1) coords < 4p, affine
// (x2, y2) < 2p with its infinity flag; out < 4p. An affine point at
// infinity leaves the accumulator unchanged (the law's one select).
// Bound audit (units of p; Fq2 values double once more inside the
// Karatsuba operand sums): t2 < 96, t1/Z3 < 98, Y3' < 144; worst product
// pairs (196)(196) and (12)(288) -- inside the 2^16 p^2 cap.
// 11 Montgomery products (55 for Fq2). Outputs must not alias inputs.
template <class F>
__device__ __noinline__ void cmadd_body(
    const FieldQ& f, const typename F::T& X1, const typename F::T& Y1,
    const typename F::T& Z1, const typename F::T& x2,
    const typename F::T& y2, bool ainf, typename F::T& X3,
    typename F::T& Y3, typename F::T& Z3) {
  typename F::T t0, t1, t2, t3, t4, u, v;
  F::mul(f, X1, x2, t0);                       // < 2p
  F::mul(f, Y1, y2, t1);                       // < 2p
  F::add(x2, y2, u);
  F::add(X1, Y1, v);
  F::mul(f, u, v, t3);                         // < 2p
  F::add(t0, t1, u);
  F::sub(f, t3, u, 4, t3);                     // < 6p
  F::mul(f, y2, Z1, u);
  F::add(u, Y1, t4);                           // < 6p
  F::mul(f, x2, Z1, u);
  F::add(u, X1, Y3);                           // < 6p
  F::dbl(t0, u);
  F::add(u, t0, t0);                           // 3 t0 < 6p
  F::mul_b3(f, Z1, 4, t2);                     // < 96p
  F::add(t1, t2, Z3);                          // < 98p
  F::sub(f, t1, t2, 96, t1);                   // < 98p
  F::mul_b3(f, Y3, 8, Y3);                     // < 144p
  finish<F>(f, t0, t1, t3, t4, X3, Y3, Z3);
  F::select(ainf, X1, X3, X3);
  F::select(ainf, Y1, Y3, Y3);
  F::select(ainf, Z1, Z3, Z3);
}

}  // namespace curve
}  // namespace gs
