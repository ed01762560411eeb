// The fused tower kernels of the port: Hopper (sm_90a) counterparts of two
// Pallas kernels of groth_sahai_tpu/ops/pallas_tower.py.
//
//   gs_fq12_mul <- pallas_tower.fq12_mul / fq12_sqr (_fq12_mul_kernel)
//   gs_cyc_pow  <- pallas_tower.cyc_pow (_cyc_pow_kernel)
//
// The reference takes them for batches of at most 4096 lanes; on the
// verifier's signed Miller product they carry the tree product over the
// pair axis (4096 lanes down to 4) and the whole final exponentiation on
// the (2, 2) result.
//
// Work split: one thread per lane, as in fp_kernels.cu; an Fq12 batch is
// int64 [25, 12, M] (limb i of coefficient c of lane l at (12 i + c) M + l),
// so the threads of a warp read neighbouring words. Blocks of 32 threads
// spread the few thousand lanes of these calls over all 132 SMs.
//
// What bounds them on the H100: an Fq12 product is 66 Montgomery products
// (54 Karatsuba + 12 post-reductions, 82,500 16x16-bit multiply-adds) per
// lane on 7.2 KB of int64 limbs moved, so it is bound by the multiplier;
// cyc_pow (64 cyclotomic squares of 30 products each, plus a product per
// set exponent bit) is bound by the multiplier too. The design keeps each
// Fq12 value in thread-local memory (tower.cuh), so at these small batches
// the real limit is the latency of one thread's long dependent chain.
//
// Plain C interface for ctypes. Each entry point returns cudaGetLastError()
// after its launch (0 = success), or -1 for a limb count other than 25.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "tower.cuh"

namespace {

using namespace gs::tower;

constexpr int kThreads = 32;

__device__ __forceinline__ void load12(const int64_t* src, int64_t m,
                                       int64_t lane, Fp12& x) {
  uint32_t* w = &x[0][0][0][0];
#pragma unroll 1
  for (int c = 0; c < 12; ++c) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      w[c * N + i] = static_cast<uint32_t>(src[(i * 12 + c) * m + lane]);
  }
}

__device__ __forceinline__ void store12(int64_t* dst, int64_t m, int64_t lane,
                                        const Fp12& x) {
  const uint32_t* w = &x[0][0][0][0];
#pragma unroll 1
  for (int c = 0; c < 12; ++c) {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[(i * 12 + c) * m + lane] = w[c * N + i];
  }
}

__global__ void __launch_bounds__(kThreads)
fq12_mul_kernel(const __grid_constant__ FieldQ f, const int64_t* a,
                const int64_t* b, int64_t* out, int64_t m) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= m) return;
  Fp12 x, y, z;
  load12(a, m, lane, x);
  load12(b, m, lane, y);
  f12_mul_red(f, x, y, z);
  store12(out, m, lane, z);
}

// a^e for a static e < 2^64: 64 iterations from the Fq12 one (R mod p in
// coefficient 0), each a post-reduced cyclotomic square and, on a set bit
// of e (MSB first, leading zeros included), a post-reduced product with a
// -- the sequence of pallas_tower._cyc_pow_kernel. The bit is the same for
// every thread, so the branch does not diverge.
__global__ void __launch_bounds__(kThreads)
cyc_pow_kernel(const __grid_constant__ FieldQ f, const int64_t* a,
               uint64_t e, int64_t* out, int64_t m) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= m) return;
  Fp12 x, acc, t;
  load12(a, m, lane, x);
  uint32_t* w = &acc[0][0][0][0];
#pragma unroll 1
  for (int i = 0; i < 12 * N; ++i) w[i] = 0;
  copy(f.one, acc[0][0][0]);
#pragma unroll 1
  for (int i = 63; i >= 0; --i) {
    cyc_sqr_red(f, acc, t);
    if ((e >> i) & 1) {
      f12_mul_red(f, t, x, acc);
    } else {
      const uint32_t* s = &t[0][0][0][0];
#pragma unroll 1
      for (int j = 0; j < 12 * N; ++j) w[j] = s[j];
    }
  }
  store12(out, m, lane, acc);
}

unsigned grid_of(int64_t m) {
  return static_cast<unsigned>((m + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int gs_fq12_mul(int nl, const int64_t* a, const int64_t* b, int64_t* out,
                int64_t m, const uint32_t* p, const uint32_t* one,
                uint32_t n0, void* stream) {
  if (nl != N) return -1;
  fq12_mul_kernel<<<grid_of(m), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      gs::make_field<N>(p, one, n0), a, b, out, m);
  return static_cast<int>(cudaGetLastError());
}

int gs_cyc_pow(int nl, const int64_t* a, uint64_t e, int64_t* out, int64_t m,
               const uint32_t* p, const uint32_t* one, uint32_t n0,
               void* stream) {
  if (nl != N) return -1;
  cyc_pow_kernel<<<grid_of(m), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      gs::make_field<N>(p, one, n0), a, e, out, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
