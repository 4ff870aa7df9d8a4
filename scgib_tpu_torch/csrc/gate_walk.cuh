// Walking the nonzeros of one row of a bf16 banded gate, shared by the
// sparse gathers of banded.cu (band_row) and gt_flash.cu (the attention
// backward).
//
// A group of `lpr` adjacent lanes (a power of two) owns one row.  Each lane
// reads up to SEGV 16-byte vectors of the row (8 entries each; vector
// q = s0 + i lpr + lig for its lane lig in the group), every load issued
// before any is used, and keeps one bit per nonzero entry.  The group then
// takes its nonzeros one at a time by warp ballot, lowest lane and bit
// first: no barrier and no shared memory, and the same order in every run.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gate_walk {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SEGV = 8;           // 16-byte gate vectors a lane holds at once

struct LaneGroup {
  int lpr;          // lanes in the group, a power of two
  int gbase;        // the group's first lane
  int lig;          // this lane's place in the group
  unsigned gmask;   // the group's lanes
};

__device__ __forceinline__ LaneGroup lane_group(int lpr) {
  const int lane = threadIdx.x & 31;
  const int gbase = lane & ~(lpr - 1);
  return {lpr, gbase, lane - gbase,
          lpr == 32 ? FULL : ((1u << lpr) - 1u) << gbase};
}

// This lane's nonzero mask over segment s0 of the row `arow` (nvec 16-byte
// vectors in all): bit 8 i + e is set where element e of its vector i is
// nonzero.  0 for a group without a row (`active` false).
__device__ __forceinline__ unsigned long long gate_mask(
    const __nv_bfloat16* __restrict__ arow, bool active, int nvec, int s0,
    const LaneGroup& g) {
  uint4 v[SEGV];
#pragma unroll
  for (int i = 0; i < SEGV; ++i) {
    const int q = s0 + i * g.lpr + g.lig;
    v[i] = (active && q < nvec)
               ? __ldg(reinterpret_cast<const uint4*>(arow) + q)
               : make_uint4(0u, 0u, 0u, 0u);
  }
  unsigned long long m = 0ull;
#pragma unroll
  for (int i = 0; i < SEGV; ++i) {
    const unsigned w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if (w[h] & 0x7fffu) m |= 1ull << (8 * i + 2 * h);
      if (w[h] & 0x7fff0000u) m |= 1ull << (8 * i + 2 * h + 1);
    }
  }
  return m;
}

// The group's next nonzero column of segment s0, lowest lane and bit first,
// taken out of the owning lane's mask; -1 when the group has none left.
// Every lane of the warp calls this together.
__device__ __forceinline__ int take_nonzero(unsigned long long& m, int s0,
                                            const LaneGroup& g) {
  const int lane = threadIdx.x & 31;
  const unsigned has = __ballot_sync(FULL, m != 0ull) & g.gmask;
  const int src = has ? __ffs(has) - 1 : lane;
  const unsigned lo = __shfl_sync(FULL, (unsigned)m, src);
  const unsigned hi = __shfl_sync(FULL, (unsigned)(m >> 32), src);
  const int bit =
      __ffsll((long long)(((unsigned long long)hi << 32) | lo)) - 1;
  if (has && lane == src) m &= m - 1ull;
  return has ? (s0 + (bit >> 3) * g.lpr + (src - g.gbase)) * 8 + (bit & 7)
             : -1;
}

}  // namespace gate_walk
