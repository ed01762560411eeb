// The field kernels of the port: Hopper (sm_90a) counterparts of the four
// Pallas kernels of groth_sahai_tpu/ops/pallas_fp.py.
//
//   gs_mont_mul  <- pallas_fp.mont_mul  (_mont_mul_kernel)
//   gs_mul_wide  <- pallas_fp.mul_wide  (_mul_wide_kernel)
//   gs_redc      <- pallas_fp.redc      (_redc_kernel)
//   gs_pow_const <- pallas_fp.pow_const (_pow_chain_kernel)
//
// Work split: mul_wide and redc (and pow_const over Fr) run one thread per
// lane (batch element), its 16-bit limbs in registers (field.cuh). The
// batch is flattened to M lanes; a limb-major int64 array [rows, M] (the
// port's tensor layout) puts limb i of lane l at i*M + l, so the threads of
// a warp read neighbouring words. The grid covers M with a masked tail;
// nothing is carried between blocks.
//
// What bounds them on the H100: each lane does N^2 (mul_wide) or N^2
// (redc) 32-bit multiply-adds and moves 8 bytes per limb. Over the
// 8192-lane batches of the unfused pairing path a launch moves a few MB,
// so these two are bound by launch count and device-memory bytes, not by
// the multiplier.
//
// mont_mul moves 24 bytes a limb (a, b, out; 600 B a lane for Fq) and is
// bound by bytes at 16384 lanes (pairing-8192's FQ2.mul_fq: 9.8 MB), but
// one thread a lane over 16-bit digits (2 N^2 = 1,250 multiply-adds for Fq,
// 128 blocks of 128 threads) left 4 of the 132 SMs idle and one warp on
// each scheduler, so nothing hid its loads or its chain of products, and
// at the verify and prove paths' narrow calls one product's latency is the
// launch's time. Its design (mont_mul_kernel): the operands as packed
// 32-bit words at the same R (Fq 13 words, R = 2^400; Fr 9, R = 2^272),
// each product split over a group of kMulGroup threads of one warp
// (field_split_w32.cuh: NW steps of a few multiply-adds a thread and two
// shuffles), in blocks of kMulThreads threads, so that 16384 lanes make
// 16384 kMulGroup / kMulThreads blocks over every SM. kMulGroup is the
// fastest of 1 (field_w32.cuh's one-thread mont_words), 2, 4 and 8 at
// every shape timed (utils/fp_variants.py --mont): 4 for Fq (16384 lanes
// and verify's 21, 1336 and 8), 8 for Fr (1.2x G = 4 at its shapes, where
// each thread's two columns of the 16-column window hold the 9 words).
//
// pow_const over Fq is a Fermat chain (e = p - 2: 381 squares and 229
// products, 610 dependent Montgomery products a lane), launched over 2 to
// 8192 lanes: over verify's 4 and 21 lanes nothing else runs on the card,
// and even 8192 lanes fill a fraction of it, so what bounds it is the
// latency of one product times 610, not the multiplier (its bound by
// operations is 12x below the one-thread kernel's time). Its design cuts
// that latency (field_split_w32.cuh): an Fq value is 13 packed 32-bit
// words at the same R = 2^400, and each product is split over a group of
// kPowGroup threads of one warp, each owning 16 / kPowGroup columns of the
// running sum in carry-save form; a CIOS step costs each thread a few
// multiply-adds and the group one shuffle (the broadcast of m), and the
// carries resolve once per product (three exchanges and two ballots).
// kPowGroup is the fastest of 1 (field_w32.cuh's one-thread `mont`), 4, 8
// and 16 at the paths' shapes (utils/fp_variants.py). Fr's pow_const, which
// no path launches, keeps the one-thread 16-bit body.
//
// Plain C interface for ctypes. Each entry point returns cudaGetLastError()
// after its launch (0 = success), or -1 for a limb count with no
// instantiation.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "field_split_w32.cuh"
#include "field_w32.cuh"
#include "group_w32.cuh"

namespace {

constexpr int kThreads = 128;

template <int K>
__device__ __forceinline__ void load(const int64_t* src, int64_t m,
                                     int64_t lane, uint32_t (&x)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) x[j] = static_cast<uint32_t>(src[j * m + lane]);
}

template <int K>
__device__ __forceinline__ void store(int64_t* dst, int64_t m, int64_t lane,
                                      const uint32_t (&x)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) dst[j * m + lane] = x[j];
}

// Threads a lane of mont_mul, by field (1: field_w32.cuh's one-thread
// mont_words; 2 to 8: the product split over the group), and threads a
// block.
constexpr int kMulGroupFq = 4;
constexpr int kMulGroupFr = 8;
constexpr int kMulThreads = 64;

// Word k of lane `lane` of an [2 NW - 1, M] batch of 16-bit limbs, packed
// (a limb's value is its int64's low word).
template <int NW>
__device__ __forceinline__ uint32_t load_word(const int64_t* src, int64_t m,
                                              int64_t lane, int k) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  const int64_t at = 2 * k * m + lane;
  const uint32_t lo = __ldg(s + 2 * at);
  const uint32_t hi = 2 * k + 1 < 2 * NW - 1 ? __ldg(s + 2 * (at + m)) : 0u;
  return lo | hi << 16;
}

// Word k's 16-bit limbs to lane `lane` of dst [2 NW - 1, M].
template <int NW>
__device__ __forceinline__ void store_word(int64_t* dst, int64_t m,
                                           int64_t lane, int k, uint32_t w) {
  dst[2 * k * m + lane] = w & 0xFFFFu;
  if (2 * k + 1 < 2 * NW - 1) dst[(2 * k + 1) * m + lane] = w >> 16;
}

// a b R^-1 mod p over NW packed words (pallas_fp._mont_mul_kernel), G
// consecutive threads a lane. G = 1: field_w32.cuh's mont_words in the
// lane's thread. G > 1: every thread reads a whole (the split's broadcast
// operand) and its own words of b, and stores its own words of the
// product (field_split_w32.cuh); the product takes every thread of the
// warp, so a ragged block's spare groups work the last lane and store
// nothing.
template <int G, int NW>
__global__ void __launch_bounds__(kMulThreads)
mont_mul_kernel(const __grid_constant__ gs::w32::MontW<NW> f,
                const int64_t* a, const int64_t* b, int64_t* out, int64_t m) {
  const int64_t at =
      (static_cast<int64_t>(blockIdx.x) * kMulThreads + threadIdx.x) / G;
  const int64_t lane = at < m ? at : m - 1;
  uint32_t x[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) x[k] = load_word<NW>(a, m, lane, k);
  if constexpr (G == 1) {
    uint32_t y[NW], z[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) y[k] = load_word<NW>(b, m, lane, k);
    gs::w32::mont_words<NW>(f, x, y, z);
    if (at >= m) return;
#pragma unroll
    for (int k = 0; k < NW; ++k) store_word<NW>(out, m, lane, k, z[k]);
  } else {
    using S = gs::w32::Split<G, NW>;
    const S s(f);
    uint32_t y[S::K], z[S::K];
#pragma unroll
    for (int k = 0; k < S::K; ++k) {
      const int j = s.g * S::K + k;
      y[k] = j < NW ? load_word<NW>(b, m, lane, j) : 0u;
    }
    s.mont(f, x, y, z);
    if (at >= m) return;
#pragma unroll
    for (int k = 0; k < S::K; ++k) {
      const int j = s.g * S::K + k;
      if (j < NW) store_word<NW>(out, m, lane, j, z[k]);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
mul_wide_kernel(const int64_t* a, const int64_t* b, int64_t* out, int64_t m) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= m) return;
  uint32_t x[N], y[N], z[2 * N + 1];
  load<N>(a, m, lane, x);
  load<N>(b, m, lane, y);
  gs::mul_wide<N>(x, y, z);
  store<2 * N + 1>(out, m, lane, z);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
redc_kernel(gs::Field<N> f, const int64_t* t, int64_t* out, int64_t m) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= m) return;
  uint32_t w[2 * N + 1], z[N];
  load<2 * N + 1>(t, m, lane, w);
  gs::redc<N>(f, w, z);
  store<N>(out, m, lane, z);
}

// a^e for a fixed exponent: MSB-first square, then multiply on set bits,
// from R mod p (the sequence of pallas_fp._pow_chain_kernel). The bit is the
// same for every thread, so the branch does not diverge; skipping the
// multiply on a clear bit gives the limbs the select would keep. One thread
// a lane over 16-bit limbs: Fr's body.
template <int N>
__global__ void __launch_bounds__(kThreads)
pow_const_kernel(gs::Field<N> f, const int64_t* a, const int64_t* bits,
                 int nbits, int64_t* out, int64_t m) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= m) return;
  uint32_t x[N], acc[N], t[N];
  load<N>(a, m, lane, x);
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = f.one[j];
  for (int i = 0; i < nbits; ++i) {
    gs::mont_mul<N>(f, acc, acc, t);
    if (bits[i]) {
      gs::mont_mul<N>(f, t, x, acc);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = t[j];
    }
  }
  store<N>(out, m, lane, acc);
}

// Threads a lane of Fq's pow_const (1: field_w32.cuh's one-thread `mont`;
// 2 to 16: the product split over the group, field_split_w32.cuh), and
// threads a block.
constexpr int kPowGroup = 8;
constexpr int kPowThreads = 64;

using gs::w32::Fw;
using gs::w32::load_coef;
using gs::w32::store_coef;

// Fq's pow_const on packed words (an Fq batch [25, M] is load_coef's and
// store_coef's S = 1). G = 1: a thread a lane, each product field_w32.cuh's
// `mont`. G > 1: a group of G consecutive threads a lane, every product
// split over it (field_split_w32.cuh): the group holds the accumulator as
// its own words and, for the next square, whole in every thread; a as
// whole words. The product takes every thread of the warp, so a ragged
// block's spare groups work the last lane and store nothing.
template <int G>
__global__ void __launch_bounds__(kPowThreads)
fq_pow_const_kernel(const __grid_constant__ gs::w32::FieldW f,
                    const int64_t* a, const int64_t* bits, int nbits,
                    int64_t* out, int64_t m) {
  const int64_t at =
      (static_cast<int64_t>(blockIdx.x) * kPowThreads + threadIdx.x) / G;
  const int64_t lane = at < m ? at : m - 1;
  const Fw x = load_coef(a, 1, 0, m, lane);
  Fw acc = gs::w32::words_of(f.one);
  if constexpr (G == 1) {
    for (int i = 0; i < nbits; ++i) {
      const Fw t = gs::w32::mont(f, acc, acc);
      acc = bits[i] ? gs::w32::mont(f, t, x) : t;
    }
  } else {
    using S = gs::w32::Split<G>;
    const S s(f);
    uint32_t own[S::K], t[S::K];
    s.own(f.one, own);
    for (int i = 0; i < nbits; ++i) {
      s.mont(f, acc.w, own, t);
      if (bits[i]) {
        s.mont(f, x.w, t, own);
      } else {
#pragma unroll
        for (int k = 0; k < S::K; ++k) own[k] = t[k];
      }
      s.full(own, acc.w);
    }
    if (s.g != 0) return;
  }
  if (at < m) store_coef(out, 1, 0, m, lane, acc);
}

unsigned grid_of(int64_t m) {
  return static_cast<unsigned>((m + kThreads - 1) / kThreads);
}

template <int NW, int G>
int launch_mont_mul(const int64_t* a, const int64_t* b, int64_t* out,
                    int64_t m, const uint32_t* p, uint32_t n0,
                    cudaStream_t s) {
  const auto grid =
      static_cast<unsigned>((m * G + kMulThreads - 1) / kMulThreads);
  mont_mul_kernel<G, NW><<<grid, kMulThreads, 0, s>>>(
      gs::w32::make_mont_w<NW>(p, n0), a, b, out, m);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_mul_wide(const int64_t* a, const int64_t* b, int64_t* out,
                    int64_t m, cudaStream_t s) {
  mul_wide_kernel<N><<<grid_of(m), kThreads, 0, s>>>(a, b, out, m);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_redc(const int64_t* t, int64_t* out, int64_t m, const uint32_t* p,
                uint32_t n0, cudaStream_t s) {
  redc_kernel<N><<<grid_of(m), kThreads, 0, s>>>(
      gs::make_field<N>(p, nullptr, n0), t, out, m);
  return static_cast<int>(cudaGetLastError());
}

int launch_pow_fr(const int64_t* a, const int64_t* bits, int nbits,
                  int64_t* out, int64_t m, const uint32_t* p,
                  const uint32_t* one, uint32_t n0, cudaStream_t s) {
  pow_const_kernel<17><<<grid_of(m), kThreads, 0, s>>>(
      gs::make_field<17>(p, one, n0), a, bits, nbits, out, m);
  return static_cast<int>(cudaGetLastError());
}

int launch_pow_fq(const int64_t* a, const int64_t* bits, int nbits,
                  int64_t* out, int64_t m, const uint32_t* p,
                  const uint32_t* one, uint32_t n0, cudaStream_t s) {
  constexpr int G = kPowGroup;
  const auto grid =
      static_cast<unsigned>((m * G + kPowThreads - 1) / kPowThreads);
  fq_pow_const_kernel<G><<<grid, kPowThreads, 0, s>>>(
      gs::w32::make_field_w(p, one, n0), a, bits, nbits, out, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The limb counts of the port's fields: 25 (Fq) and 17 (Fr).
extern "C" {

int gs_mont_mul(int nl, const int64_t* a, const int64_t* b, int64_t* out,
                int64_t m, const uint32_t* p, uint32_t n0, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 25: return launch_mont_mul<13, kMulGroupFq>(a, b, out, m, p, n0, s);
    case 17: return launch_mont_mul<9, kMulGroupFr>(a, b, out, m, p, n0, s);
    default: return -1;
  }
}

int gs_mul_wide(int nl, const int64_t* a, const int64_t* b, int64_t* out,
                int64_t m, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 25: return launch_mul_wide<25>(a, b, out, m, s);
    case 17: return launch_mul_wide<17>(a, b, out, m, s);
    default: return -1;
  }
}

int gs_redc(int nl, const int64_t* t, int64_t* out, int64_t m,
            const uint32_t* p, uint32_t n0, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 25: return launch_redc<25>(t, out, m, p, n0, s);
    case 17: return launch_redc<17>(t, out, m, p, n0, s);
    default: return -1;
  }
}

int gs_pow_const(int nl, const int64_t* a, const int64_t* bits, int nbits,
                 int64_t* out, int64_t m, const uint32_t* p,
                 const uint32_t* one, uint32_t n0, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 25: return launch_pow_fq(a, bits, nbits, out, m, p, one, n0, s);
    case 17: return launch_pow_fr(a, bits, nbits, out, m, p, one, n0, s);
    default: return -1;
  }
}

}  // extern "C"
