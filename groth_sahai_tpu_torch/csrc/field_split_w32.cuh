// The Montgomery product of field_w32.cuh split over a group of G threads
// of one warp: the product of Fq's pow_const (its Fermat chain) and of
// mont_mul over Fq and Fr (fp_kernels.cu).
//
// Same integer as field_w32.cuh's mont_words on NW words (Fq: NW = 13, R =
// 2^400, 12 reduction steps of 2^32 with n0w and one of 2^16 with n0; Fr:
// NW = 9, R = 2^272, 8 steps and one; no final subtraction: the unique
// (t + M p) / R with M = -t p^-1 mod R), so the 16-bit limbs at the
// boundary equal field.cuh's and the plain version's.
//
// Layout. The running sum T of the CIOS steps lives in a window of C
// columns of 32 bits (C = NW rounded up to a multiple of G: 16 for Fq at
// G = 4, 8, 16); thread g of the group owns columns g K .. g K + K - 1
// (K = C / G). Each column is kept in carry-save form as three words
// (l, h, t): the value l + 2^32 h + 2^64 t at the column's weight. Every
// thread holds all NW words of the operand a (the broadcast operand) and
// its own K words of b and of p (zero past word NW - 1 and NW - 2).
//
// One CIOS step i (NW steps, unrolled):
//   * every column adds a_i b_j whole (mad.lo.cc, madc.hi.cc, addc): the
//     64-bit product lands in the column's (l, h, t), so no product half
//     crosses a thread;
//   * m = T_0 n0w, with T_0 the low word of column 0, exact: one shuffle
//     broadcasts thread 0's l to the group (n0 and 2^16 in the last step);
//   * every column adds m p_j;
//   * the window shifts one column down: a column becomes its own h + 2^32
//     t plus the next column's l, which for a thread's top column comes by
//     one shuffle from thread g + 1. For K >= 2 that word is added one step
//     later (before the column's l is read again), so the shuffle is off
//     the critical path; for K = 1 it is on it.
// Columns stay below 2^66 (at most 2^35 after a shift, plus two products
// below 2^64 and one word), so t <= 3, whatever the operands' words.
//
// Bounds (the contract of mont_mul and pow_const: 16-bit limbs, so a, b <
// 2^(32 NW - 16), and value(a) value(b) <= 2^16 p^2):
//   * after each step T < b + p (T_(i+1) = (T_i + a_i b + m p) / 2^32 with
//     a_i, m < 2^32, from T_0 = 0), below 2^(32 NW): T's value never
//     reaches a column past NW - 1, whose l, h and t hold a product whole,
//     so C >= NW columns suffice and columns NW .. C - 1 stay zero;
//   * the output is (a b + M p) / R <= 2^16 p^2 / R + p = p (1 + 2^16 p /
//     R): Fq p (1 + 2^(16 + 381 - 400)) < 1.125 p, Fr p (1 + 2^(16 + 255
//     - 272)) < 1.5 p, both < 2p (at the extremes a = 2^16 p^2 / b, b = p
//     or 2p: the bound holds for either factor in either role);
//   * before the last shift T = 2^16 x output < 2^17 p < 2^(32 NW - 16)
//     (Fq 2^398, Fr 2^272), so the carries out of column NW - 1 and the
//     words h_(NW-1), t_(NW-1), t_(NW-2) that would reach column NW are 0.
//
// After step NW - 1 the carries resolve once, in three exchanges:
//   * s_j + 2^32 c_j = l_j + h_(j-1) + t_(j-2) (c_j <= 2), the words of
//     the column below by a shuffle up at a thread's first columns;
//   * a thread adds its columns' c inside its block (one carry chain), and
//     passes its block's carry out plus its top c (<= 3) to thread g + 1,
//     which adds it to its block: a block now carries out 0 or 1;
//   * carry-lookahead over the group by two ballots: thread g generates if
//     its block carried out, propagates if its K words are all ones; the
//     carry into thread g is bit g of ((G | P) + G) ^ P.
// The result is T / 2^16: a word's high half joins the next word's low
// half (one shuffle down for a thread's top word).
//
// The product needs every thread of the warp (the shuffles and ballots
// name the full mask): a kernel keeps spare groups working and lets them
// store nothing.
#pragma once

#include <cstdint>

#include "field_w32.cuh"

namespace gs {
namespace w32 {

constexpr unsigned kWarp = 0xFFFFFFFFu;   // the shuffles' and ballots' mask

// 2^32 t + 2^32 h + l += x y, whole.
__device__ __forceinline__ void mac3(uint32_t& l, uint32_t& h, uint32_t& t,
                                     uint32_t x, uint32_t y) {
  l = mad_lo_cc(x, y, l);
  h = madc_hi_cc(x, y, h);
  t = addc(t, 0);
}

// The G threads of a group working one split product of NW words.
template <int G, int NW = kWords>
struct Split {
  static_assert(G >= 2 && G <= 16 && 32 % G == 0,
                "a group of 2 to 16 threads inside one warp");
  static constexpr int K = (NW + G - 1) / G;   // columns a thread (C / G)

  int g;                                   // rank in the group
  unsigned base;                           // the group's first lane
  uint32_t p[K];                           // p's words at g's columns

  template <class F>
  __device__ explicit Split(const F& f)
      : g(static_cast<int>(threadIdx.x % G)),
        base(threadIdx.x % 32 & ~static_cast<unsigned>(G - 1)) {
    own(f.p, p);
  }

  // This thread's K words of a value of N words (zero past N).
  template <int N>
  __device__ __forceinline__ void own(const uint32_t (&w)[N],
                                      uint32_t (&o)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = 0;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j / K == g) o[j % K] = w[j];
  }

  // All NW words of a value from the group's own words.
  __device__ __forceinline__ void full(const uint32_t (&o)[K],
                                       uint32_t (&w)[NW]) const {
#pragma unroll
    for (int i = 0; i < NW; ++i)
      w[i] = __shfl_sync(kWarp, o[i % K], i / K, G);
  }

  // a b R^-1 mod p (< 2p), a whole in every thread, b and the result as
  // this thread's words. Bounds as field_w32.cuh's mont (above).
  template <class F>
  __device__ __forceinline__ void mont(const F& f, const uint32_t (&a)[NW],
                                       const uint32_t (&b)[K],
                                       uint32_t (&r)[K]) const {
    uint32_t l[K], h[K], t[K], pend = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) l[k] = h[k] = t[k] = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) mac3(l[k], h[k], t[k], a[i], b[k]);
      const uint32_t low = __shfl_sync(kWarp, l[0], 0, G);
      const uint32_t m = i < NW - 1 ? low * f.n0w : (low * f.n0) & 0xFFFFu;
#pragma unroll
      for (int k = 0; k < K; ++k) mac3(l[k], h[k], t[k], m, p[k]);
      if (K > 1) {                        // last step's word from g + 1
        l[K - 1] = add_cc(l[K - 1], pend);
        h[K - 1] = addc_cc(h[K - 1], 0);
        t[K - 1] = addc(t[K - 1], 0);
      }
      if (i == NW - 1) break;
      // T / 2^32: column k takes its h + 2^32 t and column k + 1's l
      uint32_t next = __shfl_down_sync(kWarp, l[0], 1, G);
      next = g == G - 1 ? 0u : next;
#pragma unroll
      for (int k = 0; k < K - 1; ++k) {
        l[k] = add_cc(h[k], l[k + 1]);
        h[k] = addc(t[k], 0);
        t[k] = 0;
      }
      if (K == 1) {
        l[0] = add_cc(h[0], next);
        h[0] = addc(t[0], 0);
      } else {
        l[K - 1] = h[K - 1];
        h[K - 1] = t[K - 1];
        pend = next;
      }
      t[K - 1] = 0;
    }
    // s_j + 2^32 c_j = l_j + h_(j-1) + t_(j-2)
    uint32_t hin = __shfl_up_sync(kWarp, h[K - 1], 1, G);
    uint32_t tin1 = __shfl_up_sync(kWarp, t[K - 1], 1, G);
    uint32_t tin2 = __shfl_up_sync(kWarp, t[K > 1 ? K - 2 : 0], K > 1 ? 1 : 2,
                                   G);
    hin = g == 0 ? 0u : hin;
    tin1 = g == 0 ? 0u : tin1;
    tin2 = g < (K > 1 ? 1 : 2) ? 0u : tin2;
    uint32_t s[K], c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t hm = k > 0 ? h[k - 1] : hin;
      const uint32_t tm = k > 1 ? t[k - 2] : k == 1 ? tin1 : tin2;
      s[k] = add_cc(l[k], hm);
      c[k] = addc(0, 0);
      s[k] = add_cc(s[k], tm);
      c[k] = addc(c[k], 0);
    }
    // the block's words with its own c, then the carry from below
    uint32_t e = 0;
    if (K > 1) {
      s[1] = add_cc(s[1], c[0]);
#pragma unroll
      for (int k = 2; k < K; ++k) s[k] = addc_cc(s[k], c[k - 1]);
      e = addc(0, 0);
    }
    uint32_t in = __shfl_up_sync(kWarp, c[K - 1] + e, 1, G);
    in = g == 0 ? 0u : in;
    s[0] = add_cc(s[0], in);
#pragma unroll
    for (int k = 1; k < K; ++k) s[k] = addc_cc(s[k], 0);
    const uint32_t gen = addc(0, 0);
    bool ones = true;
#pragma unroll
    for (int k = 0; k < K; ++k) ones = ones && s[k] == 0xFFFFFFFFu;
    constexpr unsigned kMask = (1u << G) - 1;
    const unsigned gb = __ballot_sync(kWarp, gen != 0) >> base & kMask;
    const unsigned pb = __ballot_sync(kWarp, ones) >> base & kMask;
    const uint32_t cin = (((gb | pb) + gb) ^ pb) >> g & 1u;
    s[0] = add_cc(s[0], cin);
#pragma unroll
    for (int k = 1; k < K - 1; ++k) s[k] = addc_cc(s[k], 0);
    if (K > 1) s[K - 1] = addc(s[K - 1], 0);
    // T / 2^16
    uint32_t up = __shfl_down_sync(kWarp, s[0], 1, G);
    up = g == G - 1 ? 0u : up;
#pragma unroll
    for (int k = 0; k < K; ++k)
      r[k] = __funnelshift_r(s[k], k + 1 < K ? s[k + 1] : up, 16);
  }
};

}  // namespace w32
}  // namespace gs
