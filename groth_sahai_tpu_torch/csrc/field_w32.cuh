// In-thread Fq arithmetic on packed 32-bit words, for the Hopper kernels
// on packed words: cadd and cmsm_row_scan (curve_w32.cuh), cdbl_n_add
// and cmadd (curve_group_w32.cuh), fq12_mul, cyc_pow, f12_pow_dyn and the
// Miller iterations (tower_w32.cuh).
//
// An Fq value is the integer of the port's 25 16-bit limbs (Montgomery form,
// R = 2^400) held in 13 uint32 words, little-endian: word k = limb 2k |
// limb 2k+1 << 16, word 12 = limb 24. Every value the curve bodies make is
// below 288p < 2^390, so 13 words hold it with room; p < 2^381 fits in 12.
//
// The Montgomery product keeps R = 2^400, so its output is the integer of
// field.cuh's mont_mul: with no final subtraction, (t + M p) / R with
// M = -t p^-1 mod R is unique, and 12 reduction steps of 2^32 (with
// n0w = -p^-1 mod 2^32) plus one step of 2^16 (with n0 = -p^-1 mod 2^16)
// reach it as field.cuh's 25 steps of 2^16 do. The product's body
// (mont_words) takes any odd word count NW with p in NW - 1 words: Fr's
// 17 limbs (R = 2^272, p < 2^255) are 9 words, 8 steps of 2^32 and one
// of 2^16, for fp_kernels.cu's mont_mul. add, sub and mul12 are
// functions of the integer values alone, so a body written with them gives
// the limbs of the same body in 16-bit limbs (the plain versions in
// ops/cuda_curve.py and ops/cuda_tower.py).
//
// Products are 32x32-bit multiply-adds in carry chains (PTX mad.lo.cc /
// madc.hi.cc / addc), 2 (13^2 + 13 x 12) = 650 word products' halves per
// Montgomery product where field.cuh's mont_mul makes 1,250 16x16-bit
// multiply-adds. On sm_90a most of them become a multiply-add and an add
// with carry (IADD3.X): about 1,045 instructions a product (chip_smoke.py
// prints the count). Every function indexes its words with constants, so
// the words stay in registers; all but mont are inlined.
//
// Bounds (as field.cuh): mont needs value(a) value(b) <= 2^16 p^2, output
// < 2p; sub(a, b) needs a >= b; sub_kp(a, b, k) needs bound(b) <= k p.
#pragma once

#include <cstdint>

namespace gs {
namespace w32 {

constexpr int kWords = 13;   // words of an Fq value (416 >= 400 bits)
constexpr int kPWords = 12;  // words of p (p < 2^384)
constexpr int kLimbs = 25;   // 16-bit limbs of an Fq value at the boundary

// The k of the bodies' k p offsets, and their index in FieldW::kp.
enum Kp { K2, K4, K8, K48, K96, kKinds };
constexpr uint32_t kKp[kKinds] = {2, 4, 8, 48, 96};

// The field of a launch, made on the host from the boundary's 16-bit limbs
// (make_field_w) and passed by value, so every thread reads the same words
// from the kernel-parameter bank.
struct FieldW {
  uint32_t p[kPWords];
  uint32_t one[kWords];            // R mod p
  uint32_t kp[kKinds][kWords];     // k p for k in kKp
  uint32_t n0w;                    // -p^-1 mod 2^32
  uint32_t n0;                     // -p^-1 mod 2^16
};

struct Fw {
  uint32_t w[kWords];
};

// The NW - 1 words of p and -p^-1 mod 2^32, mod 2^16: all that the
// Montgomery product of NW words reads (mont_words); FieldW holds the same
// three for Fq beside its constants.
template <int NW>
struct MontW {
  uint32_t p[NW - 1];
  uint32_t n0w;
  uint32_t n0;
};

// 16-bit limbs (< 2^16 each; 2 NW - 1 of them) to NW packed words.
template <int NW = kWords>
inline void pack_host(const uint32_t* limbs, uint32_t* words) {
  for (int k = 0; k < NW; ++k) {
    const uint32_t lo = limbs[2 * k];
    const uint32_t hi = 2 * k + 1 < 2 * NW - 1 ? limbs[2 * k + 1] : 0;
    words[k] = lo | hi << 16;
  }
}

// -p^-1 mod 2^32 by Newton's iteration: x = p0 is right to 3 bits (p odd),
// each step doubles the bits that are right (3, 6, 12, 24, 48).
inline uint32_t n0w_of(uint32_t p0) {
  uint32_t x = p0;
  for (int i = 0; i < 4; ++i) x *= 2u - p0 * x;
  return 0u - x;
}

template <int NW>
inline MontW<NW> make_mont_w(const uint32_t* p16, uint32_t n0) {
  MontW<NW> f;
  uint32_t p[NW];
  pack_host<NW>(p16, p);
  for (int j = 0; j < NW - 1; ++j) f.p[j] = p[j];
  f.n0w = n0w_of(p[0]);
  f.n0 = n0;
  return f;
}

// k p as packed words for each k of ks[0 .. n - 1], from p's packed words.
inline void kp_words(const uint32_t (&p)[kWords], const uint32_t* ks, int n,
                     uint32_t (*out)[kWords]) {
  for (int i = 0; i < n; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < kWords; ++j) {
      c += static_cast<uint64_t>(p[j]) * ks[i];
      out[i][j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
  }
}

inline FieldW make_field_w(const uint32_t* p16, const uint32_t* one16,
                           uint32_t n0) {
  FieldW f;
  uint32_t p[kWords];
  pack_host(p16, p);
  for (int j = 0; j < kPWords; ++j) f.p[j] = p[j];
  pack_host(one16, f.one);
  kp_words(p, kKp, kKinds, f.kp);
  f.n0w = n0w_of(p[0]);
  f.n0 = n0;
  return f;
}

// ---------------------------------------------------------------- PTX chains
// One instruction each. `volatile` keeps them in program order, so a carry
// flag set by one is read by the next of its chain.

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// ------------------------------------------------------------ end PTX chains

// a + b; the carry out of word 12 is dropped (sums stay below 2^416).
__device__ __forceinline__ Fw add(const Fw& a, const uint32_t (&b)[kWords]) {
  Fw c;
  c.w[0] = add_cc(a.w[0], b[0]);
#pragma unroll
  for (int j = 1; j < kWords - 1; ++j) c.w[j] = addc_cc(a.w[j], b[j]);
  c.w[kWords - 1] = addc(a.w[kWords - 1], b[kWords - 1]);
  return c;
}

__device__ __forceinline__ Fw add(const Fw& a, const Fw& b) {
  return add(a, b.w);
}

__device__ __forceinline__ Fw dbl(const Fw& a) { return add(a, a); }
__device__ __forceinline__ Fw triple(const Fw& a) { return add(dbl(a), a); }

// The value of 13 words (a constant of the launch).
__device__ __forceinline__ Fw words_of(const uint32_t (&w)[kWords]) {
  Fw c;
#pragma unroll
  for (int j = 0; j < kWords; ++j) c.w[j] = w[j];
  return c;
}

// a - b for a >= b.
__device__ __forceinline__ Fw sub(const Fw& a, const Fw& b) {
  Fw c;
  c.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < kWords - 1; ++j) c.w[j] = subc_cc(a.w[j], b.w[j]);
  c.w[kWords - 1] = subc(a.w[kWords - 1], b.w[kWords - 1]);
  return c;
}

// a - b + k p, formed as (a + k p) - b; bound(b) <= k p.
__device__ __forceinline__ Fw sub_kp(const FieldW& f, const Fw& a,
                                     const Fw& b, Kp k) {
  return sub(add(a, f.kp[k]), b);
}

// 12 a: the low words of 12 a_j plus the high words of 12 a_(j-1). Output
// < 12 bound(a) (below 2^416 for the bodies' a < 24p).
__device__ __forceinline__ Fw mul12(const Fw& a) {
  uint32_t hi[kWords];
  Fw c;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c.w[j] = a.w[j] * 12u;
    hi[j] = __umulhi(a.w[j], 12u);
  }
  c.w[1] = add_cc(c.w[1], hi[0]);
#pragma unroll
  for (int j = 2; j < kWords - 1; ++j) c.w[j] = addc_cc(c.w[j], hi[j - 1]);
  c.w[kWords - 1] = addc(c.w[kWords - 1], hi[kWords - 2]);
  return c;
}

// Montgomery product a b 2^-400 mod p, output < 2p (CIOS). The running
// sum T is kept as T = E + 2^32 O: in each step the products of a_i with
// b's even words add into E's word pairs (2j, 2j + 1) and those with b's
// odd words into O's, so each product's low and high halves sit in one
// carry chain on a register pair; then m = T mod 2^32 times n0w makes
// T's low word zero (m p by the same split), and T / 2^32 = E / 2^32 + O
// becomes the next step's E. The last word of a holds 16 bits, and its
// step reduces by 2^16 with n0. After each step T < b + p.
//
// The body on NW words (NW odd, p in the NW - 1 words of f.p; F is FieldW
// or MontW<NW>): R = 2^(32 NW - 16), NW - 1 steps of 2^32 and one of 2^16.
template <int NW, class F>
__device__ __forceinline__ void mont_words(const F& f,
                                           const uint32_t (&a)[NW],
                                           const uint32_t (&b)[NW],
                                           uint32_t (&c)[NW]) {
  static_assert(NW % 2 == 1, "b's even words end the E chain");
  constexpr int PW = NW - 1;             // words of p
  uint32_t E[NW + 1], O[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t ai = a[i];
    // O = ai b_odd (O's pair k holds the product of b's word 2k + 1)
#pragma unroll
    for (int j = 1; j < NW; j += 2) {
      const uint64_t x = static_cast<uint64_t>(ai) * b[j];
      O[j - 1] = static_cast<uint32_t>(x);
      O[j] = static_cast<uint32_t>(x >> 32);
    }
    O[NW - 1] = 0;
    // E += ai b_even
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < NW; j += 2) {
        const uint64_t x = static_cast<uint64_t>(ai) * b[j];
        E[j] = static_cast<uint32_t>(x);
        E[j + 1] = static_cast<uint32_t>(x >> 32);
      }
    } else {
      E[0] = mad_lo_cc(ai, b[0], E[0]);
      E[1] = madc_hi_cc(ai, b[0], E[1]);
#pragma unroll
      for (int j = 2; j < NW - 1; j += 2) {
        E[j] = madc_lo_cc(ai, b[j], E[j]);
        E[j + 1] = madc_hi_cc(ai, b[j], E[j + 1]);
      }
      E[NW - 1] = madc_lo_cc(ai, b[NW - 1], E[NW - 1]);
      E[NW] = madc_hi(ai, b[NW - 1], E[NW]);
    }
    // T += m p, m = T mod 2^32 times n0w (n0 and 2^16 in the last step)
    const uint32_t m = i < NW - 1 ? E[0] * f.n0w : (E[0] * f.n0) & 0xFFFFu;
    E[0] = mad_lo_cc(m, f.p[0], E[0]);
    E[1] = madc_hi_cc(m, f.p[0], E[1]);
#pragma unroll
    for (int j = 2; j < PW; j += 2) {
      E[j] = madc_lo_cc(m, f.p[j], E[j]);
      E[j + 1] = madc_hi_cc(m, f.p[j], E[j + 1]);
    }
    E[PW] = addc_cc(E[PW], 0);
    E[NW] = addc(E[NW], 0);
    O[0] = mad_lo_cc(m, f.p[1], O[0]);
    O[1] = madc_hi_cc(m, f.p[1], O[1]);
#pragma unroll
    for (int j = 3; j < PW; j += 2) {
      O[j - 1] = madc_lo_cc(m, f.p[j], O[j - 1]);
      O[j] = madc_hi_cc(m, f.p[j], O[j]);
    }
    O[PW] = addc(O[PW], 0);
    if (i < NW - 1) {
      // T / 2^32 (E[0] is zero now): E = E[1..] + O
      E[0] = add_cc(E[1], O[0]);
#pragma unroll
      for (int k = 1; k < NW - 1; ++k) E[k] = addc_cc(E[k + 1], O[k]);
      E[NW - 1] = addc(E[NW], O[NW - 1]);
      E[NW] = 0;
    }
  }
  // T / 2^16: T's words are E[0] and E[k] + O[k - 1]
  uint32_t t[NW + 1];
  t[0] = E[0];
  t[1] = add_cc(E[1], O[0]);
#pragma unroll
  for (int k = 2; k < NW; ++k) t[k] = addc_cc(E[k], O[k - 1]);
  t[NW] = addc(E[NW], O[NW - 1]);
#pragma unroll
  for (int j = 0; j < NW; ++j) c[j] = __funnelshift_r(t[j], t[j + 1], 16);
}

// The Fq product of the curve and tower bodies.
//
// One out-of-line copy, its operands and result passed by value (in
// registers), serves every product of a body: inlined at each of a G2
// add's 60 products, the code grew to ~100,000 instructions, and fetching
// them, not the arithmetic, set the kernels' time.
__device__ __noinline__ Fw mont(const FieldW& f, Fw a, Fw b) {
  Fw c;
  mont_words<kWords>(f, a.w, b.w, c.w);
  return c;
}

}  // namespace w32
}  // namespace gs
