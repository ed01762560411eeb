// A group of G threads working one lane, over packed 32-bit words
// (field_w32.cuh): the machinery the tower kernels (tower_w32.cuh) and the
// grouped curve kernels (curve_group_w32.cuh: cdbl_n_add, cmadd) share.
//
// One lane is worked by the G threads of a Group, inside one warp. The
// lane's values live in the group's shared memory as Fq slots of 13 words.
// A formula is cut into levels: the Montgomery products of a level are
// independent, each a task that one thread takes whole (it forms the
// operand sums, calls mont, stores the result to a slot); the tasks of a
// level go round-robin to the group's threads, and __syncwarp of the
// group's mask separates the levels. A task reads only slots that earlier
// levels wrote, and no two tasks of a level write one slot.
//
// A block holds whole lanes, G consecutive threads each; inactive lanes of
// a ragged block leave as whole groups, so every __syncwarp names only
// threads that reach it.
#pragma once

#include <cstdint>

#include "field_w32.cuh"

namespace gs {
namespace w32 {

// The G threads of one lane: the lane's slots (Fq slot i at words
// s[13 i .. 13 i + 12]), this thread's rank g in the group, and the group's
// lanes of the warp for __syncwarp.
template <int G>
struct Group {
  uint32_t* s;
  int g;
  unsigned mask;

  __device__ __forceinline__ Fw ld(int slot) const {
    Fw v;
#pragma unroll
    for (int k = 0; k < kWords; ++k) v.w[k] = s[slot * kWords + k];
    return v;
  }
  __device__ __forceinline__ void st(int slot, const Fw& v) const {
#pragma unroll
    for (int k = 0; k < kWords; ++k) s[slot * kWords + k] = v.w[k];
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

// Thread threadIdx.x of a block whose lanes take G consecutive threads
// each; `lane_words` is the block's shared memory of its lane.
template <int G>
__device__ __forceinline__ Group<G> group_of(uint32_t* lane_words) {
  static_assert(G <= 32 && 32 % G == 0, "a group lies inside one warp");
  const unsigned x = threadIdx.x;
  const unsigned mask = G == 32 ? 0xFFFFFFFFu
                                : ((1u << G) - 1) << (x % 32 / G * G);
  return Group<G>{lane_words, static_cast<int>(x % G), mask};
}

// One level: tasks 0 .. n - 1 round-robin over the group, then the group's
// barrier.
template <int G, class Task>
__device__ __forceinline__ void level(const Group<G>& grp, int n, Task task) {
#pragma unroll 1
  for (int k = grp.g; k < n; k += G) task(k);
  grp.sync();
}

// A lane's words of shared memory: its Fq slots, padded to an odd count so
// that the lanes of a warp start on different banks.
__host__ __device__ constexpr int lane_words(int slots) {
  return slots * kWords | 1;
}

// Coefficient c of lane `lane` of a batch int64 [25, S, M] (limb i at
// (i S + c) M + lane), packed; a limb's value is its int64's low word.
__device__ __forceinline__ Fw load_coef(const int64_t* src, int S, int c,
                                        int64_t m, int64_t lane) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  Fw v;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int i = 2 * k;
    const int64_t at = (static_cast<int64_t>(i) * S + c) * m + lane;
    const uint32_t lo = __ldg(s + 2 * at);
    const uint32_t hi = i + 1 < kLimbs ? __ldg(s + 2 * (at + S * m)) : 0u;
    v.w[k] = lo | hi << 16;
  }
  return v;
}

// v's 16-bit limbs to coefficient c of lane `lane` of dst [25, S, M].
__device__ __forceinline__ void store_coef(int64_t* dst, int S, int c,
                                           int64_t m, int64_t lane,
                                           const Fw& v) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i)
    dst[(static_cast<int64_t>(i) * S + c) * m + lane] =
        v.w[i / 2] >> (16 * (i % 2)) & 0xFFFFu;
}

}  // namespace w32
}  // namespace gs
