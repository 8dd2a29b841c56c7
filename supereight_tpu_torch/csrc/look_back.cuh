// A single-pass decoupled look-back (Merrill & Garland 2016) over tiles of
// a grid: each tile publishes its count, then warp 0 sums the counts of
// the tiles before it, 32 status words at a time from the nearest, until
// one carries the inclusive count of every tile up to it.  Shared by the
// raycast's scan (raycast.cu, R3's second-window ranks) and the fusion's
// frustum selection (integrate.cu), each ranking flagged items in tile
// order.  The caller draws its tile from a ticket (ctl[0]), so every
// earlier tile has started and the spin ends; the status words and both
// counters live in a scratch that starts zero, and the last tile to end its
// look-back (end_look_back) leaves them zero for the next launch on the
// stream.  Every count is an integer sum, so the result does not depend
// on the order the tiles run in.

#pragma once

#include <stdint.h>

namespace lb {

// A tile's status word: flag (2 bits) | count (32 bits); 0 is not ready.
constexpr unsigned kAggregate = 1u;    // the tile's own count
constexpr unsigned kInclusive = 2u;    // those of the tiles up to it too

__device__ __forceinline__ unsigned long long status_word(unsigned flag,
                                                          uint32_t count) {
  return (static_cast<unsigned long long>(flag) << 32) | count;
}

// A status word carries its own count, so it is stored and polled
// relaxed, at the card's scope (in L2, past each SM's L1): nothing else
// is published through it, so no fence orders other writes before it.
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// Warp 0 of tile `tile`: publishes the tile's count, looks back over the
// tiles before it 32 at a time (the nearest first) until one whose
// inclusive count is out, and publishes its own.  Returns the count of
// the tiles before this one.  (The kernel's parameters come in as
// values: a reference to them would be read from memory after every
// barrier and in every trip of the spin.)
__device__ int look_back(unsigned long long* st, int tile, int count,
                         int lane) {
  if (lane == 0)
    store_status(st + tile, status_word(tile == 0 ? kInclusive : kAggregate,
                                        static_cast<uint32_t>(count)));
  if (tile == 0) return 0;
  int before = 0;
  for (int end = tile - 1;; end -= 32) {
    const int t = end - lane;
    unsigned flag = kInclusive;
    uint32_t value = 0;
    if (t >= 0) {
      unsigned long long w;
      do {
        w = load_status(st + t);
        flag = static_cast<unsigned>(w >> 32) & 3u;
      } while (flag == 0u);
      value = static_cast<uint32_t>(w);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, flag == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    before += warp_sum(lane <= stop ? static_cast<int>(value) : 0);
    if (incl) break;
  }
  if (lane == 0)
    store_status(st + tile, status_word(kInclusive,
                                        static_cast<uint32_t>(before + count)));
  return before;
}

// Warp 0 of a tile whose look-back has ended: the last tile to get here
// (every other one has published its words and read its last) zeroes the
// status words and the counters for the next launch on the stream.
__device__ void end_look_back(unsigned long long* st, uint32_t* ctl,
                              int lane) {
  bool last = false;
  if (lane == 0) {
    __threadfence();
    last = atomicAdd(ctl + 1, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  for (int t = lane; t < static_cast<int>(gridDim.x); t += 32)
    store_status(st + t, 0ull);
  if (lane == 0) {
    ctl[0] = 0u;
    ctl[1] = 0u;
  }
}

}  // namespace lb
