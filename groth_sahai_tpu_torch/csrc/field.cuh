// In-thread prime-field arithmetic on 16-bit limbs, for the Hopper kernels.
//
// Port of groth_sahai_tpu/ops/pallas_reg.py (the in-kernel library of the
// Pallas kernels). One thread owns one field element: its N limbs live in
// registers as uint32 values < 2^16, little-endian, Montgomery form with
// R = 2^(16 N) (N = 25 for Fq, 17 for Fr), exactly as in ops/fp.py.
//
// Where the TPU kernels accumulated 16-bit halves of each product in uint32
// columns (the TPU vector unit has no 64-bit multiply), Hopper has a
// 32x32+64 -> 64 multiply-add (IMAD.WIDE.U32): a 16x16-bit product is added
// whole to a 64-bit column. Column audit: a column takes at most 2N
// products < 2^32 plus a carry < 2^23, so < 2^38 for N = 25.
//
// Bound discipline (same formulas as ops/fp.py):
//   * mont_mul needs value(a) * value(b) <= 2^16 p^2; output < 2p;
//   * redc needs t < p R (2N+1 exact limbs); output < 2p;
//   * sub(a, b, kp) = sub_k(a, b, k) = a - b + k p needs bound(b) <= k p.
// add, sub, sub_k, neg_k, select and dbl read limb j before
// they write it, so `out` may be one of the inputs.
// The Montgomery output is the unique (t + M p) / R with M = -t p^-1 mod R
// and no final subtraction, so it equals the plain version limb for limb.
#pragma once

#include <cstdint>

namespace gs {

constexpr int kW = 16;
constexpr uint32_t kMask = 0xFFFFu;

// One prime field: modulus limbs, -p^-1 mod 2^16 and R mod p (Montgomery 1).
// Passed to kernels by value, so it lives in the kernel-parameter bank and
// every thread reads the same words.
template <int N>
struct Field {
  uint32_t p[N];
  uint32_t one[N];
  uint32_t n0;
};

// The Field of a kernel launch, from host limb arrays (`one` may be null).
template <int N>
inline Field<N> make_field(const uint32_t* p, const uint32_t* one,
                           uint32_t n0) {
  Field<N> f;
  for (int j = 0; j < N; ++j) {
    f.p[j] = p[j];
    f.one[j] = one ? one[j] : 0;
  }
  f.n0 = n0;
  return f;
}

// Exact carry propagation of K 64-bit columns into K 16-bit limbs. The carry
// out of the top column is dropped (callers keep values below 2^(16 K)).
template <int K>
__device__ __forceinline__ void carry(const uint64_t (&cols)[K],
                                      uint32_t (&out)[K]) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint64_t v = cols[j] + c;
    out[j] = static_cast<uint32_t>(v) & kMask;
    c = v >> kW;
  }
}

// a + b with exact limbs. Bound: bound(a) + bound(b).
template <int N>
__device__ __forceinline__ void add(const uint32_t (&a)[N],
                                    const uint32_t (&b)[N],
                                    uint32_t (&out)[N]) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t v = a[j] + b[j] + c;
    out[j] = v & kMask;
    c = v >> kW;
  }
}

// a - b + k p in one chain; kp = limbs of k p, bound(b) <= k p.
// Computes a + (kp + (2^16 - 1) per limb) - b + 1, whose carry out of the
// top is exactly the 2^(16 N) of the complement and is dropped.
template <int N>
__device__ __forceinline__ void sub(const uint32_t (&a)[N],
                                    const uint32_t (&b)[N],
                                    const uint32_t (&kp)[N],
                                    uint32_t (&out)[N]) {
  uint32_t c = 1;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t v = a[j] + kp[j] + kMask - b[j] + c;
    out[j] = v & kMask;
    c = v >> kW;
  }
}

// a - b + k p with k p formed in the chain (k p_j < 2^23 for k <= 128), the
// form the tower formulas use: the same integer as sub() with kp = k p.
// bound(b) <= k p.
template <int N>
__device__ __forceinline__ void sub_k(const uint32_t (&a)[N],
                                      const uint32_t (&b)[N], uint32_t k,
                                      const uint32_t (&p)[N],
                                      uint32_t (&out)[N]) {
  uint32_t c = 1;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t v = a[j] + k * p[j] + kMask - b[j] + c;
    out[j] = v & kMask;
    c = v >> kW;
  }
}

// k p - a in one chain, k p formed as in sub_k (pallas_reg.neg); bound(a)
// <= k p. Result bound: k p.
template <int N>
__device__ __forceinline__ void neg_k(const uint32_t (&a)[N], uint32_t k,
                                      const uint32_t (&p)[N],
                                      uint32_t (&out)[N]) {
  uint32_t c = 1;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t v = k * p[j] + kMask - a[j] + c;
    out[j] = v & kMask;
    c = v >> kW;
  }
}

// mask ? a : b, limb by limb (pallas_reg.select); `out` may be a or b.
template <int N>
__device__ __forceinline__ void select(bool mask, const uint32_t (&a)[N],
                                       const uint32_t (&b)[N],
                                       uint32_t (&out)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = mask ? a[j] : b[j];
}

// 2 a with exact limbs. Bound: 2 bound(a).
template <int N>
__device__ __forceinline__ void dbl(const uint32_t (&a)[N],
                                    uint32_t (&out)[N]) {
  add<N>(a, a, out);
}

// Fused CIOS Montgomery product a b R^-1 mod p, output < 2p.
// A sliding window of N+1 64-bit columns: each outer step adds a_i b, then
// m p with m = acc0 * n0 mod 2^16 (acc0 mod 2^16 is exact when read), and
// shifts the window down one limb.
template <int N>
__device__ __forceinline__ void mont_mul(const Field<N>& f,
                                         const uint32_t (&a)[N],
                                         const uint32_t (&b)[N],
                                         uint32_t (&out)[N]) {
  uint64_t acc[N + 1];
#pragma unroll
  for (int j = 0; j <= N; ++j) acc[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      acc[j] += static_cast<uint64_t>(a[i]) * b[j];
    const uint32_t m = (static_cast<uint32_t>(acc[0]) * f.n0) & kMask;
#pragma unroll
    for (int j = 0; j < N; ++j)
      acc[j] += static_cast<uint64_t>(m) * f.p[j];
    const uint64_t c = acc[0] >> kW;
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = acc[j + 1];
    acc[N] = 0;
    acc[0] += c;
  }
  uint64_t cols[N];
#pragma unroll
  for (int j = 0; j < N; ++j) cols[j] = acc[j];
  carry<N>(cols, out);
}

// Exact 2N+1-limb product (no reduction), by columns (product scanning):
// one running 64-bit sum instead of 2N+1 live columns.
template <int N>
__device__ __forceinline__ void mul_wide(const uint32_t (&a)[N],
                                         const uint32_t (&b)[N],
                                         uint32_t (&out)[2 * N + 1]) {
  uint64_t s = 0;
#pragma unroll
  for (int k = 0; k < 2 * N + 1; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = k - i;
      if (j >= 0 && j < N) s += static_cast<uint64_t>(a[i]) * b[j];
    }
    out[k] = static_cast<uint32_t>(s) & kMask;
    s >>= kW;
  }
}

// Montgomery reduction of a wide value t < p R (2N+1 exact limbs): t R^-1
// mod p, output < 2p. The window starts on t's low N+1 limbs and takes in
// limb N+1+i after step i.
template <int N>
__device__ __forceinline__ void redc(const Field<N>& f,
                                     const uint32_t (&t)[2 * N + 1],
                                     uint32_t (&out)[N]) {
  uint64_t acc[N + 1];
#pragma unroll
  for (int j = 0; j <= N; ++j) acc[j] = t[j];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t m = (static_cast<uint32_t>(acc[0]) * f.n0) & kMask;
#pragma unroll
    for (int j = 0; j < N; ++j)
      acc[j] += static_cast<uint64_t>(m) * f.p[j];
    const uint64_t c = acc[0] >> kW;
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = acc[j + 1];
    acc[N] = t[N + 1 + i];
    acc[0] += c;
  }
  uint32_t limbs[N + 1];
  carry<N + 1>(acc, limbs);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = limbs[j];
}

}  // namespace gs
