// Graph-transformer banded attention for Hopper (sm_90a): the CUDA
// counterparts of the four Pallas kernels in scgib_tpu/ops/pallas/gt_flash.py.
//
//   gt_fwd         per head: E = exp(clip(Q K^T / sqrt(hd), +-c)) * A,
//                  z = rowsum E, out = (E / (z + eps)) V; emits z.
//                  Replaces _fwd_kernel.
//   gt_bwd_rows    row pass: recompute E, G = g V^T, W = E / (z + eps),
//                  rho = rowsum(G * W), dS = E * [|S| <= c] * (G - rho) /
//                  (z + eps), dq = dS K / sqrt(hd); emits rho.
//                  Replaces _bwd_rows_kernel.
//   gt_bwd_cols    column pass: dk = dS^T q / sqrt(hd) and dv = W^T g for
//                  each column, from the row pass's z and rho.
//                  Replaces _bwd_cols_kernel.
//   gt_bwd_merged  the row pass that also adds each entry's dk and dv terms
//                  with atomicAdd.  Replaces _bwd_merged_kernel.
//
// Layout (graph/banded.py): blocks [T, TL, BW] bf16 (TL = 64, BW = 128 in
// the narrow graph-transformer geometry; 128, 256 in the wide one), col_off
// [T] int64; row i of tile t = i / TL attends to the columns
// [col_off[t], col_off[t] + BW).  The entries are edge counts: 1, or 2 for
// a repeated edge.  q, k, v, g, dq, dk, dv are [N, H, hd] f32, z and rho
// [N, H] f32, N = T * TL, D = H * hd features a row.
//
// What bounds them on an H100.  The gate is sparse: a molecule's row has
// 2-3 edges in a window of 128 columns.  The TPU kernels compute the dense
// [TL, BW] tile per head (the matrix unit wants dense work); here that
// would be ~50x more exponentials than edges, so every kernel works only
// on nonzero entries and does little arithmetic.  The floor is the bytes:
// at the main path's S = 9728 rows (H = 8, hd = 8, narrow) the forward
// must read the gate (2.5 MB) and q, k, v (2.5 MB each) and write out and
// z, 12.8 MB, 3.8 us at 3.35 TB/s; the row pass reads g and z besides and
// writes dq and rho, 15.6 MB, 4.6 us; the column pass reads z and rho and
// writes dk and dv, 18.1 MB, 5.4 us.  Reaching it is a matter of latency:
// the loads of a row depend on its gate.
//
// gt_fwd, gt_bwd_rows and gt_bwd_cols (the forward and the default,
// two-pass backward).  Their first design (the one gt_bwd_merged keeps)
// ran one block per (row tile, head), a warp walking eight rows in turn,
// each lane testing its columns of the gate two bytes at a time and
// reading k / v for a nonzero as hd scalar loads: every head re-read the
// gate (8 x 2.5 MB at S), a row was a chain of dependent loads, and 48-128
// registers capped the warps an SM.  It ran at 7-9% of the byte bound.
// Now a group of lanes owns a row (a column in the column pass) with all
// its heads: as many lanes as cover D in float4s, at least 4 (16 at
// D = 64, so a warp takes two rows), a head's hd features on hd / 4
// adjacent lanes (or 4 / hd heads a lane below hd = 4; hd is a power of
// two up to 128, so a head never leaves its warp, and the wrapper pads
// any other width with zeros up to the next one).  The group reads
// the row's gate once, as 16-byte vectors, together with q_i (and g_i and
// z_i in the backward); finds the nonzeros by warp ballot (gate_walk.cuh,
// shared with banded.cu's band_row); and gathers the rows they name,
// GATHER at a time, every load in flight before any is used: 256
// coalesced bytes a row at D = 64.  Per-head dot products are a segmented
// butterfly of __shfl_xor_sync over the head's lanes (two steps at
// hd = 8), after which every lane of a head holds its score, so z, rho
// and dS need no further reduction.  The forward is one trip: each lane
// adds e to z and e v_j to its features, then divides by z + eps (an
// all-zero row gives z = 0 and out = 0).  The row pass needs rho before
// dS: it keeps k_j, e, G and the clip flag of its first GATHER nonzeros in
// registers, so the second trip over them reads nothing; only rows with
// more nonzeros (rare in molecules) gather the rest again.  The column
// pass relies on A = A^T (the packers symmetrize every edge list): the
// rows that attend to column c of tile tc lie in the window col_off[tc],
// and the gate of (row col_off[tc] + r, column c) is
// blocks[tc][c - tc * TL][r], row c of the column's own slab; it reads
// q_i, g_i, z_i and rho_i for each nonzero and needs one trip.  Every
// output element is summed by one lane over its row's nonzeros in the
// walk's fixed order: no atomics, the same bits in every run.  These
// three kernels take D a multiple of 4 and 16-byte aligned blocks and
// feature rows (the wrappers check, and copy a misaligned feature
// operand).
//
// gt_bwd_merged keeps the first design: one block per (row tile, head),
// one warp per row, the lanes walking the window 32 columns at a time,
// k / v read only where the gate is nonzero, warp shuffles for rho and
// the hd-wide sums.  The merged pass exists because the TPU grid runs its
// programs in order, which made the read-modify-write of overlapping
// dk / dv windows race-free there.  CUDA blocks run in no order, so here
// every edge adds its dk and dv terms to buffers the caller zeroed, with
// atomicAdd: its sums are taken in an order that changes from run to run.
// Two-pass is the default.
//
// Everything is fp32 FMA, with no max shift in the exponential (as
// gt_flash.py:133).  A zero gate entry contributes exactly 0 in the TPU
// kernel too (a clipped finite score's exponential times 0), so skipping
// it changes nothing for finite inputs.  Tensor cores, TMA and bf16
// operands are later work.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (ops/kernels/gt_flash.py).  Every entry launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_walk.cuh"

namespace {

using gate_walk::FULL;

constexpr int THREADS = 256;      // gt_bwd_merged
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SLOTS = 8;      // window columns per lane: BW <= 256
constexpr int PASS_THREADS = 128; // gt_fwd, gt_bwd_rows, gt_bwd_cols
constexpr int GATHER = 4;         // nonzeros whose rows are loaded together
constexpr int MIN_LANES = 4;      // a row's lanes: at BW = 256 one segment
                                  // of gate vectors (gate_walk::SEGV a lane)
                                  // then covers the band

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int HD>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&x)[HD]) {
#pragma unroll
  for (int d = 0; d < HD; ++d) x[d] = p[d];
}

template <int HD>
__device__ __forceinline__ float dot(const float (&a)[HD],
                                     const float* __restrict__ b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <int HD>
__device__ __forceinline__ void warp_sum_row(float (&x)[HD]) {
#pragma unroll
  for (int d = 0; d < HD; ++d) x[d] = warp_sum(x[d]);
}

__device__ __forceinline__ float gated_exp(float s, float a, float clamp) {
  return expf(fminf(fmaxf(s, -clamp), clamp)) * a;
}

// The merged pass: the first design's row pass that also adds dk and dv
// (zeroed by the caller) with atomicAdd.  Block (t, h), one warp per row
// of tile t.
template <int HD>
__global__ void __launch_bounds__(THREADS)
gt_bwd_merged_kernel(const __nv_bfloat16* __restrict__ blocks,
                     const long long* __restrict__ col_off, int TL, int BW,
                     const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ z, int H, float scale,
                     float clamp, float eps, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv) {
  const int t = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long D = (long long)H * HD;
  const long long off = col_off[t];
  for (int r = warp; r < TL; r += WARPS) {
    const long long i = (long long)t * TL + r;
    const __nv_bfloat16* gate = blocks + i * BW;
    float qi[HD], gi[HD], acc[HD];
    load_row<HD>(q + i * D + h * HD, qi);
    load_row<HD>(g + i * D + h * HD, gi);
    const float inv = 1.f / (z[i * H + h] + eps);
    // this lane's window columns j = lane + 32 m: the gated exponential,
    // whether the score is inside the clip, and G = g_i . v_j
    float e[MAX_SLOTS], G[MAX_SLOTS];
    bool inside[MAX_SLOTS];
    float rh = 0.f;
#pragma unroll
    for (int m = 0; m < MAX_SLOTS; ++m) {
      e[m] = 0.f;
      G[m] = 0.f;
      inside[m] = false;
      const int j = lane + 32 * m;
      if (j < BW) {
        const float a = __bfloat162float(gate[j]);
        if (a != 0.f) {
          const long long row = (off + j) * D + h * HD;
          const float s = dot<HD>(qi, k + row) * scale;
          e[m] = gated_exp(s, a, clamp);
          inside[m] = (s >= -clamp) && (s <= clamp);
          G[m] = dot<HD>(gi, v + row);
          rh = fmaf(G[m], e[m] * inv, rh);
        }
      }
    }
    rh = warp_sum(rh);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
#pragma unroll
    for (int m = 0; m < MAX_SLOTS; ++m) {
      if (e[m] != 0.f) {
        const long long row = (off + lane + 32 * m) * D + h * HD;
        const float ds = inside[m] ? e[m] * (G[m] - rh) * inv : 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, k[row + d], acc[d]);
        const float w = e[m] * inv;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          atomicAdd(dk + row + d, ds * scale * qi[d]);
          atomicAdd(dv + row + d, w * gi[d]);
        }
      }
    }
    warp_sum_row<HD>(acc);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < HD; ++d) dq[i * D + h * HD + d] = acc[d] * scale;
    }
  }
}

// --- the forward and the two-pass backward: a lane group per row, all heads

// How a lane's four features c .. c + 3 fall into heads of width HD: NH
// heads a lane (4 / HD below HD = 4, else 1) of PER features each; one
// head spans LPH adjacent lanes.
template <int HD>
struct Heads {
  static constexpr int NH = HD >= 4 ? 1 : 4 / HD;
  static constexpr int PER = HD >= 4 ? 4 : HD;
  static constexpr int LPH = HD >= 4 ? HD / 4 : 1;
};

__device__ __forceinline__ void load4(const float* __restrict__ p, bool ok,
                                      float x[4]) {
  const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(p))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float x[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// out[u] = a . b over head u of this lane, in every lane of the head: each
// lane sums its own features, then a butterfly over the head's lanes.
// Every lane of the warp calls this together.
template <int HD>
__device__ __forceinline__ void head_dots(const float a[4], const float b[4],
                                          float out[Heads<HD>::NH]) {
  using M = Heads<HD>;
#pragma unroll
  for (int u = 0; u < M::NH; ++u) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < M::PER; ++j)
      s = fmaf(a[u * M::PER + j], b[u * M::PER + j], s);
    out[u] = s;
  }
#pragma unroll
  for (int o = 1; o < M::LPH; o <<= 1)
#pragma unroll
    for (int u = 0; u < M::NH; ++u) out[u] += __shfl_xor_sync(FULL, out[u], o);
}

// Lanes a row's group takes for D features: enough for D / 4 float4s,
// rounded up to a power of two, at least MIN_LANES and at most a warp (D
// above 128 is covered in passes of 128).
int lanes_per_row(int D) {
  int lpr = MIN_LANES;
  while (lpr < 32 && 4 * lpr < D) lpr *= 2;
  return lpr;
}

// Forward: lane group of `lpr` lanes per row i < n_rows, features as in
// the row pass.  One trip over the row's nonzeros: per head the gated
// exponential e, z += e and acc += e v_j, every k / v load of GATHER
// nonzeros in flight before any is used; then out = acc / (z + eps).
template <int HD>
__global__ void __launch_bounds__(PASS_THREADS)
gt_fwd_kernel(const __nv_bfloat16* __restrict__ blocks,
              const long long* __restrict__ col_off, int TL, int BW,
              long long n_rows, const float* __restrict__ q,
              const float* __restrict__ k, const float* __restrict__ v,
              int H, float scale, float clamp, float eps, int lpr,
              float* __restrict__ out, float* __restrict__ z) {
  using M = Heads<HD>;
  constexpr int NH = M::NH;
  const gate_walk::LaneGroup grp = gate_walk::lane_group(lpr);
  const long long row =
      ((long long)blockIdx.x * PASS_THREADS + threadIdx.x) / lpr;
  const bool active = row < n_rows;
  const long long i = active ? row : 0;
  const int D = H * HD;
  const long long off = col_off[i / TL];
  const __nv_bfloat16* gate = blocks + i * BW;
  for (int c0 = 0; c0 < D; c0 += 4 * lpr) {
    const int c = c0 + 4 * grp.lig;
    const bool ok = active && c < D;
    float qi[4], acc[4] = {0.f, 0.f, 0.f, 0.f}, zs[NH];
    load4(q + i * D + c, ok, qi);
#pragma unroll
    for (int h = 0; h < NH; ++h) zs[h] = 0.f;
    unsigned long long m = gate_walk::gate_mask(gate, active, BW / 8, 0, grp);
    while (__any_sync(FULL, m != 0ull)) {
      float a[GATHER], kj[GATHER][4], vj[GATHER][4];
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int col = gate_walk::take_nonzero(m, 0, grp);
        const bool has = col >= 0;
        const long long j = off + (has ? col : 0);
        a[u] = has ? __bfloat162float(gate[col]) : 0.f;
        load4(k + j * D + c, has && ok, kj[u]);
        load4(v + j * D + c, has && ok, vj[u]);
      }
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        float s[NH];
        head_dots<HD>(qi, kj[u], s);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float e = gated_exp(s[h] * scale, a[u], clamp);
          zs[h] += e;
#pragma unroll
          for (int j = 0; j < M::PER; ++j)
            acc[h * M::PER + j] = fmaf(e, vj[u][h * M::PER + j],
                                       acc[h * M::PER + j]);
        }
      }
    }
    if (ok) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float inv = 1.f / (zs[h] + eps);
#pragma unroll
        for (int j = 0; j < M::PER; ++j) acc[h * M::PER + j] *= inv;
      }
      store4(out + i * D + c, acc);
      if (HD < 4 || c % HD == 0) {      // the head's leading lane
#pragma unroll
        for (int h = 0; h < NH; ++h) z[i * H + c / HD + h] = zs[h];
      }
    }
  }
}

// The row pass's terms for up to GATHER nonzero columns (col < 0: none) of
// row i's window at `off`: this lane's features of each k_j (kept for dq),
// and per head the gated exponential e, the clip flag and G = g_i . v_j.
// Every k / v load is issued before any is used.
template <int HD>
__device__ __forceinline__ void row_terms(
    const int col[GATHER], const __nv_bfloat16* __restrict__ gate,
    long long off, int D, int c, bool ok, const float* __restrict__ k,
    const float* __restrict__ v, const float qi[4], const float gi[4],
    float scale, float clamp, float kj[GATHER][4],
    float e[GATHER][Heads<HD>::NH], float G[GATHER][Heads<HD>::NH],
    bool inside[GATHER][Heads<HD>::NH]) {
  constexpr int NH = Heads<HD>::NH;
  float a[GATHER], vj[GATHER][4];
#pragma unroll
  for (int u = 0; u < GATHER; ++u) {
    const bool has = col[u] >= 0;
    const long long j = off + (has ? col[u] : 0);
    a[u] = has ? __bfloat162float(gate[col[u]]) : 0.f;
    load4(k + j * D + c, has && ok, kj[u]);
    load4(v + j * D + c, has && ok, vj[u]);
  }
#pragma unroll
  for (int u = 0; u < GATHER; ++u) {
    float s[NH];
    head_dots<HD>(qi, kj[u], s);
    head_dots<HD>(gi, vj[u], G[u]);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float sc = s[h] * scale;
      e[u][h] = gated_exp(sc, a[u], clamp);
      inside[u][h] = (sc >= -clamp) && (sc <= clamp);
    }
  }
}

// dq[f] += dS(head of f) * k_j[f] for the GATHER terms (e = 0 adds 0).
template <int HD>
__device__ __forceinline__ void add_dq(
    const float kj[GATHER][4], const float e[GATHER][Heads<HD>::NH],
    const float G[GATHER][Heads<HD>::NH],
    const bool inside[GATHER][Heads<HD>::NH],
    const float rh[Heads<HD>::NH], const float inv[Heads<HD>::NH],
    float acc[4]) {
  using M = Heads<HD>;
#pragma unroll
  for (int u = 0; u < GATHER; ++u)
#pragma unroll
    for (int h = 0; h < M::NH; ++h) {
      const float ds = inside[u][h] ? e[u][h] * (G[u][h] - rh[h]) * inv[h]
                                    : 0.f;
#pragma unroll
      for (int j = 0; j < M::PER; ++j)
        acc[h * M::PER + j] = fmaf(ds, kj[u][h * M::PER + j],
                                   acc[h * M::PER + j]);
    }
}

// Row pass: lane group of `lpr` lanes per row i < n_rows; in each pass c0
// over the features, lane lig holds features c = c0 + 4 lig of heads
// c / HD onwards.
template <int HD>
__global__ void __launch_bounds__(PASS_THREADS)
gt_bwd_rows_kernel(const __nv_bfloat16* __restrict__ blocks,
                   const long long* __restrict__ col_off, int TL, int BW,
                   long long n_rows, const float* __restrict__ q,
                   const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ g, const float* __restrict__ z,
                   int H, float scale, float clamp, float eps, int lpr,
                   float* __restrict__ dq, float* __restrict__ rho) {
  constexpr int NH = Heads<HD>::NH;
  const gate_walk::LaneGroup grp = gate_walk::lane_group(lpr);
  const long long row =
      ((long long)blockIdx.x * PASS_THREADS + threadIdx.x) / lpr;
  const bool active = row < n_rows;
  const long long i = active ? row : 0;
  const int D = H * HD;
  const long long off = col_off[i / TL];
  const __nv_bfloat16* gate = blocks + i * BW;
  for (int c0 = 0; c0 < D; c0 += 4 * lpr) {
    const int c = c0 + 4 * grp.lig;
    const bool ok = active && c < D;
    const int h0 = c / HD;              // this lane's first head
    float qi[4], gi[4], inv[NH], rh[NH];
    load4(q + i * D + c, ok, qi);
    load4(g + i * D + c, ok, gi);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      inv[h] = ok ? 1.f / (z[i * H + h0 + h] + eps) : 0.f;
      rh[h] = 0.f;
    }
    unsigned long long m = gate_walk::gate_mask(gate, active, BW / 8, 0, grp);

    // first trip: rho; the first GATHER nonzeros' terms stay in registers
    int col0[GATHER];
    float k0[GATHER][4], e0[GATHER][NH], G0[GATHER][NH];
    bool in0[GATHER][NH];
#pragma unroll
    for (int u = 0; u < GATHER; ++u)
      col0[u] = gate_walk::take_nonzero(m, 0, grp);
    row_terms<HD>(col0, gate, off, D, c, ok, k, v, qi, gi, scale, clamp, k0,
                  e0, G0, in0);
#pragma unroll
    for (int u = 0; u < GATHER; ++u)
#pragma unroll
      for (int h = 0; h < NH; ++h) rh[h] = fmaf(G0[u][h], e0[u][h] * inv[h],
                                                rh[h]);
    const unsigned long long rest = m;   // the nonzeros past the first GATHER
    while (__any_sync(FULL, m != 0ull)) {
      int col[GATHER];
      float kj[GATHER][4], e[GATHER][NH], G[GATHER][NH];
      bool in[GATHER][NH];
#pragma unroll
      for (int u = 0; u < GATHER; ++u)
        col[u] = gate_walk::take_nonzero(m, 0, grp);
      row_terms<HD>(col, gate, off, D, c, ok, k, v, qi, gi, scale, clamp, kj,
                    e, G, in);
#pragma unroll
      for (int u = 0; u < GATHER; ++u)
#pragma unroll
        for (int h = 0; h < NH; ++h) rh[h] = fmaf(G[u][h], e[u][h] * inv[h],
                                                  rh[h]);
    }

    // second trip: dS and dq, from the registers, then the rest again
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    add_dq<HD>(k0, e0, G0, in0, rh, inv, acc);
    m = rest;
    while (__any_sync(FULL, m != 0ull)) {
      int col[GATHER];
      float kj[GATHER][4], e[GATHER][NH], G[GATHER][NH];
      bool in[GATHER][NH];
#pragma unroll
      for (int u = 0; u < GATHER; ++u)
        col[u] = gate_walk::take_nonzero(m, 0, grp);
      row_terms<HD>(col, gate, off, D, c, ok, k, v, qi, gi, scale, clamp, kj,
                    e, G, in);
      add_dq<HD>(kj, e, G, in, rh, inv, acc);
    }
    if (ok) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] *= scale;
      store4(dq + i * D + c, acc);
      if (HD < 4 || c % HD == 0) {      // the head's leading lane
#pragma unroll
        for (int h = 0; h < NH; ++h) rho[i * H + h0 + h] = rh[h];
      }
    }
  }
}

// Column pass: lane group per column c < n_rows (row c of its tile's slab
// is the gate of the rows attending to it, A being symmetric); features as
// in the row pass.
template <int HD>
__global__ void __launch_bounds__(PASS_THREADS)
gt_bwd_cols_kernel(const __nv_bfloat16* __restrict__ blocks,
                   const long long* __restrict__ col_off, int TL, int BW,
                   long long n_rows, const float* __restrict__ q,
                   const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ g, const float* __restrict__ z,
                   const float* __restrict__ rho, int H, float scale,
                   float clamp, float eps, int lpr, float* __restrict__ dk,
                   float* __restrict__ dv) {
  using M = Heads<HD>;
  constexpr int NH = M::NH;
  const gate_walk::LaneGroup grp = gate_walk::lane_group(lpr);
  const long long col =
      ((long long)blockIdx.x * PASS_THREADS + threadIdx.x) / lpr;
  const bool active = col < n_rows;
  const long long cr = active ? col : 0;
  const int D = H * HD;
  const long long off = col_off[cr / TL];
  // A[off + r, c] = A[c, off + r]: row c of this tile's slab
  const __nv_bfloat16* gate = blocks + cr * BW;
  for (int c0 = 0; c0 < D; c0 += 4 * lpr) {
    const int c = c0 + 4 * grp.lig;
    const bool ok = active && c < D;
    const int h0 = c / HD;
    float kc[4], vc[4];
    load4(k + cr * D + c, ok, kc);
    load4(v + cr * D + c, ok, vc);
    unsigned long long m = gate_walk::gate_mask(gate, active, BW / 8, 0, grp);
    float ak[4] = {0.f, 0.f, 0.f, 0.f}, av[4] = {0.f, 0.f, 0.f, 0.f};
    while (__any_sync(FULL, m != 0ull)) {
      int rr[GATHER];
#pragma unroll
      for (int u = 0; u < GATHER; ++u)
        rr[u] = gate_walk::take_nonzero(m, 0, grp);
      // rows i = off + rr: q_i, g_i, z_i and rho_i, all loads in flight
      float a[GATHER], qi[GATHER][4], gi[GATHER][4], zi[GATHER][NH],
          ri[GATHER][NH];
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const bool has = rr[u] >= 0;
        const long long i = off + (has ? rr[u] : 0);
        a[u] = has ? __bfloat162float(gate[rr[u]]) : 0.f;
        load4(q + i * D + c, has && ok, qi[u]);
        load4(g + i * D + c, has && ok, gi[u]);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          zi[u][h] = has && ok ? z[i * H + h0 + h] : 0.f;
          ri[u][h] = has && ok ? rho[i * H + h0 + h] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        float s[NH], G[NH];
        head_dots<HD>(kc, qi[u], s);
        head_dots<HD>(vc, gi[u], G);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float sc = s[h] * scale;
          const float e = gated_exp(sc, a[u], clamp);
          const float inv = 1.f / (zi[u][h] + eps);
          const float ds = (sc >= -clamp && sc <= clamp)
                               ? e * (G[h] - ri[u][h]) * inv : 0.f;
          const float w = e * inv;
#pragma unroll
          for (int j = 0; j < M::PER; ++j) {
            ak[h * M::PER + j] = fmaf(ds, qi[u][h * M::PER + j],
                                      ak[h * M::PER + j]);
            av[h * M::PER + j] = fmaf(w, gi[u][h * M::PER + j],
                                      av[h * M::PER + j]);
          }
        }
      }
    }
    if (ok) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ak[j] *= scale;
      store4(dk + cr * D + c, ak);
      store4(dv + cr * D + c, av);
    }
  }
}

// The band; a head width is checked by the dispatch below.
bool bad_geometry(int BW) {
  return BW <= 0 || BW % 32 != 0 || BW > 32 * MAX_SLOTS;
}

// The lane-group kernels (gt_fwd and the two-pass backward) read float4s:
// D a multiple of 4.
bool bad_pass_geometry(int BW, int H, int hd) {
  return bad_geometry(BW) || H <= 0 || (H * hd) % 4 != 0;
}

unsigned pass_grid(int n_tiles, int TL, int lpr) {
  const long long threads = (long long)n_tiles * TL * lpr;
  return (unsigned)((threads + PASS_THREADS - 1) / PASS_THREADS);
}

}  // namespace

// The head widths every attention kernel takes, as switch cases that
// instantiate CALL: the merged pass, whose lanes hold a head's hd features
// three times over, goes no further.  The wrapper's MERGED_HEAD_WIDTHS and
// HEAD_WIDTHS state the same sets; build() checks them against these.
#define SCGIB_HD_CASES(...)                                \
    case 1: { constexpr int HD = 1; __VA_ARGS__; } break;  \
    case 2: { constexpr int HD = 2; __VA_ARGS__; } break;  \
    case 4: { constexpr int HD = 4; __VA_ARGS__; } break;  \
    case 8: { constexpr int HD = 8; __VA_ARGS__; } break;  \
    case 16: { constexpr int HD = 16; __VA_ARGS__; } break; \
    case 32: { constexpr int HD = 32; __VA_ARGS__; } break;

#define SCGIB_DISPATCH_HD(hd, ...)                         \
  switch (hd) {                                            \
    SCGIB_HD_CASES(__VA_ARGS__)                            \
    default: return (int)cudaErrorInvalidValue;            \
  }

// The lane-group kernels also take hd = 64 and 128: a lane holds four
// features whatever hd is, and a head spans 16 or 32 lanes, so the per-head
// butterfly stays inside a warp and the registers do not grow.  Other
// widths are zero-padded up to one of these by the wrapper.
#define SCGIB_DISPATCH_PASS_HD(hd, ...)                       \
  switch (hd) {                                               \
    SCGIB_HD_CASES(__VA_ARGS__)                               \
    case 64: { constexpr int HD = 64; __VA_ARGS__; } break;   \
    case 128: { constexpr int HD = 128; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;               \
  }

extern "C" {

// q, k, v, out 16-byte aligned and H * hd a multiple of 4 (the wrapper
// checks).
int scgib_gt_fwd(const void* blocks, const void* col_off, int n_tiles, int TL,
                 int BW, const void* q, const void* k, const void* v, int H,
                 int hd, float scale, float clamp, float eps, void* out,
                 void* z, void* stream) {
  if (bad_pass_geometry(BW, H, hd)) return (int)cudaErrorInvalidValue;
  const int lpr = lanes_per_row(H * hd);
  const long long rows = (long long)n_tiles * TL;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_PASS_HD(
      hd, gt_fwd_kernel<HD><<<pass_grid(n_tiles, TL, lpr), PASS_THREADS, 0,
                              s>>>(
      (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW, rows,
      (const float*)q, (const float*)k, (const float*)v, H, scale, clamp,
      eps, lpr, (float*)out, (float*)z));
  return (int)cudaGetLastError();
}

// q, k, v, g, dq 16-byte aligned and H * hd a multiple of 4 (the wrapper
// checks).
int scgib_gt_bwd_rows(const void* blocks, const void* col_off, int n_tiles,
                      int TL, int BW, const void* q, const void* k,
                      const void* v, const void* g, const void* z, int H,
                      int hd, float scale, float clamp, float eps, void* dq,
                      void* rho, void* stream) {
  if (bad_pass_geometry(BW, H, hd)) return (int)cudaErrorInvalidValue;
  const int lpr = lanes_per_row(H * hd);
  const long long rows = (long long)n_tiles * TL;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_PASS_HD(
      hd, gt_bwd_rows_kernel<HD><<<pass_grid(n_tiles, TL, lpr),
                                   PASS_THREADS, 0, s>>>(
      (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW, rows,
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)z, H, scale, clamp, eps, lpr, (float*)dq, (float*)rho));
  return (int)cudaGetLastError();
}

// q, k, v, g, dk, dv 16-byte aligned and H * hd a multiple of 4 (the
// wrapper checks).
int scgib_gt_bwd_cols(const void* blocks, const void* col_off, int n_tiles,
                      int TL, int BW, const void* q, const void* k,
                      const void* v, const void* g, const void* z,
                      const void* rho, int H, int hd, float scale,
                      float clamp, float eps, void* dk, void* dv,
                      void* stream) {
  if (bad_pass_geometry(BW, H, hd)) return (int)cudaErrorInvalidValue;
  const int lpr = lanes_per_row(H * hd);
  const long long rows = (long long)n_tiles * TL;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_PASS_HD(
      hd, gt_bwd_cols_kernel<HD><<<pass_grid(n_tiles, TL, lpr),
                                   PASS_THREADS, 0, s>>>(
      (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW, rows,
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)z, (const float*)rho, H, scale, clamp, eps, lpr,
      (float*)dk, (float*)dv));
  return (int)cudaGetLastError();
}

// dk and dv must be zeroed by the caller (they are accumulated).
int scgib_gt_bwd_merged(const void* blocks, const void* col_off, int n_tiles,
                        int TL, int BW, const void* q, const void* k,
                        const void* v, const void* g, const void* z, int H,
                        int hd, float scale, float clamp, float eps,
                        void* dq, void* dk, void* dv, void* stream) {
  if (bad_geometry(BW)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, H);
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(hd, gt_bwd_merged_kernel<HD><<<grid, THREADS, 0, s>>>(
      (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)z, H, scale, clamp, eps, (float*)dq, (float*)dk,
      (float*)dv));
  return (int)cudaGetLastError();
}

// For the report: registers a thread, shared memory a block and blocks an
// SM of gt_bwd_rows_kernel (which = 0), gt_bwd_cols_kernel (1),
// gt_fwd_kernel (2) or gt_bwd_merged_kernel (3) at head width hd.
int scgib_gt_kernel_info(int which, int hd, int* info) {
  const void* kernel = nullptr;
  int threads = PASS_THREADS;
  if (which == 3) {
    SCGIB_DISPATCH_HD(hd, kernel = (const void*)gt_bwd_merged_kernel<HD>);
    threads = THREADS;
  } else {
    SCGIB_DISPATCH_PASS_HD(
        hd, kernel = which == 0   ? (const void*)gt_bwd_rows_kernel<HD>
                     : which == 1 ? (const void*)gt_bwd_cols_kernel<HD>
                                  : (const void*)gt_fwd_kernel<HD>);
  }
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  int per_sm = 0;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, 0)))
    return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = per_sm;
  return 0;
}

}  // extern "C"
