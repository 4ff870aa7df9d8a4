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
//                  The row pass and the merged pass are one template,
//                  gt_row_pass_kernel<HD, MERGED>.
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
// All four kernels (the forward, the default two-pass backward and the
// merged backward).  Their first design ran one block per (row
// tile, head), a warp walking eight rows in turn, each lane testing its
// columns of the gate two bytes at a time and reading k / v for a nonzero
// as hd scalar loads: every head re-read the gate (8 x 2.5 MB at S), a row
// was a chain of dependent loads, and 48-128 registers capped the warps an
// SM.  It ran at 7-9% of the byte bound.  Now a group of lanes owns a row
// (a column in the column pass) with all its heads: as many lanes as cover
// D in pieces of F features, at least 4 (16 at D = 64, so a warp takes two
// rows).  A lane holds F = 4 features (one float4) up to hd = 128, and
// hd / 32 past it, so a head's features lie on at most 32 adjacent lanes
// (or 4 / hd heads a lane below hd = 4; hd is a power of two up to 512, so
// a head never leaves its warp, and the wrapper pads any other width with
// zeros up to the next one).  A head wider than 512 features (any multiple
// of 512; the wrapper pads to the next) is swept 512 features at a time in
// that layout, each lane adding its share of the head's other sweeps to
// every dot product before the butterfly (WIDE below): the scores are
// recomputed in every sweep, which re-reads q and k (g and v) hd / 512
// times, and no lane holds more registers than at hd 512.  The group reads
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
// registers (half as many at 8 features a lane), so the second trip over
// them reads nothing; only rows with
// more nonzeros (rare in molecules) gather the rest again.  The column
// pass relies on A = A^T (the packers symmetrize every edge list): the
// rows that attend to column c of tile tc lie in the window col_off[tc],
// and the gate of (row col_off[tc] + r, column c) is
// blocks[tc][c - tc * TL][r], row c of the column's own slab; it reads
// q_i, g_i, z_i and rho_i for each nonzero and needs one trip.  Every
// output element is summed by one lane over its row's nonzeros in the
// walk's fixed order: no atomics, the same bits in every run.  All four
// kernels take D a multiple of 4 and 16-byte aligned blocks and feature
// rows (the wrappers check, and copy a misaligned feature operand).
//
// gt_bwd_merged is the row pass with the column pass folded into its
// second trip: each nonzero (i, j) adds this lane's features of its dk_j
// and dv_j terms with atomicAdd into buffers the caller zeroed, and no rho
// is written.  The merged pass exists because the TPU grid runs its
// programs in order, which made the read-modify-write of overlapping dk /
// dv windows race-free there.  CUDA blocks run in no order, hence the
// atomics, and its sums are taken in an order that changes from run to
// run.  Its first design (a block per (row tile, head), a warp per row,
// hd features three times over in every lane) re-read the gate per head,
// ran at 7% of the byte bound and could not go past hd = 32; in the
// lane-group layout it serves every width the two passes serve.  Two-pass
// is the default.
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

constexpr int PASS_THREADS = 128; // every kernel's block
constexpr int GATHER = 4;         // nonzeros whose rows are loaded together
                                  // (at 4 features a lane)
constexpr int MAX_BAND = 256;     // one segment of gate vectors
                                  // (gate_walk::SEGV a lane) covers it
constexpr int MIN_LANES = 4;      // a row's lanes: at BW = 256 one segment
                                  // then covers the band

__device__ __forceinline__ float gated_exp(float s, float a, float clamp) {
  return expf(fminf(fmaxf(s, -clamp), clamp)) * a;
}

// Heads wider than SWEEP features: one instantiation, HD = WIDE, serves
// every head width that is a multiple of SWEEP, taken at run time.  Its
// lanes are laid out as at SWEEP: a warp holds SWEEP features of one head,
// and the row's passes c0 sweep the head SWEEP features at a time.  Every
// dot product of two rows over the head is then this lane's own F features
// plus its F features of each of the head's other sweeps, read from memory
// (other_sweeps), before the butterfly over the warp: the full-width
// scores are recomputed in every sweep, and no lane holds more than it
// does at SWEEP.
constexpr int SWEEP = 512;
constexpr int WIDE = 0;

// How a lane's F features c .. c + F - 1 fall into heads of width HD (the
// sweep's SWEEP features of a WIDE head): F is 4, or HD / 32 past HD = 128
// so that a head never spans more than a warp; NH heads a lane (4 / HD
// below HD = 4, else 1) of PER features each; one head spans LPH adjacent
// lanes.  NG nonzeros are gathered at once: half as many at 8 features a
// lane, which keeps the registers of hd <= 128.
template <int HD>
struct Heads {
  static constexpr int W = HD == WIDE ? SWEEP : HD;
  static constexpr int F = W > 128 ? W / 32 : 4;
  static constexpr int NH = W >= 4 ? 1 : 4 / W;
  static constexpr int PER = W >= 4 ? F : W;
  static constexpr int LPH = W >= 4 ? W / F : 1;
  static constexpr int NG = F > 4 ? GATHER / 2 : GATHER;
};

// The head width of row features: HD, or hd (a multiple of SWEEP) for WIDE.
// hd is every kernel's last argument, which the other instantiations ignore.
template <int HD>
__device__ __forceinline__ int head_width(int hd) {
  return HD == WIDE ? hd : HD;
}

// F features from p in 16-byte vectors (zeros where !ok).
template <int F>
__device__ __forceinline__ void loadf(const float* __restrict__ p, bool ok,
                                      float* x) {
#pragma unroll
  for (int i = 0; i < F / 4; ++i) {
    const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(p) + i)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

template <int F>
__device__ __forceinline__ void storef(float* p, const float* x) {
#pragma unroll
  for (int i = 0; i < F / 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

// This lane's share of a . b over the other sweeps of its WIDE head, for
// rows a and b (their first feature) and this lane's features c .. c + F -
// 1 in a head of hw features: 0 unless HD is WIDE.
template <int HD>
__device__ __forceinline__ float other_sweeps(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              int c, int hw, bool ok) {
  float s = 0.f;
  if constexpr (HD != WIDE) return s;
  if (!ok) return s;
  const int own = (c % hw) / SWEEP;
  const int base = c - own * SWEEP;
#pragma unroll 1
  for (int w = 0; w < hw / SWEEP; ++w) {
    if (w == own) continue;
    const float4* x = reinterpret_cast<const float4*>(a + base + w * SWEEP);
    const float4* y = reinterpret_cast<const float4*>(b + base + w * SWEEP);
#pragma unroll
    for (int i = 0; i < Heads<HD>::F / 4; ++i) {
      const float4 p = __ldg(x + i), r = __ldg(y + i);
      s = fmaf(p.x, r.x, s); s = fmaf(p.y, r.y, s);
      s = fmaf(p.z, r.z, s); s = fmaf(p.w, r.w, s);
    }
  }
  return s;
}

// out[u] = a . b over head u of this lane, in every lane of the head: each
// lane sums its own features (and, for a WIDE head, `rest`, its share of
// the other sweeps), then a butterfly over the head's lanes.  Every lane of
// the warp calls this together.
template <int HD>
__device__ __forceinline__ void head_dots(const float* a, const float* b,
                                          float* out, float rest = 0.f) {
  using M = Heads<HD>;
#pragma unroll
  for (int u = 0; u < M::NH; ++u) {
    float s = u == 0 ? rest : 0.f;
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

// Lanes a row's group takes for D features at F a lane: enough for D / F
// pieces, rounded up to a power of two, at least MIN_LANES and at most a
// warp (wider rows are covered in passes of 32 F features).
int lanes_per_row(int D, int F) {
  int lpr = MIN_LANES;
  while (lpr < 32 && F * lpr < D) lpr *= 2;
  return lpr;
}

// Forward: lane group of `lpr` lanes per row i < n_rows, features as in
// the row pass.  One trip over the row's nonzeros: per head the gated
// exponential e, z += e and acc += e v_j, every k / v load of NG nonzeros
// in flight before any is used; then out = acc / (z + eps).
template <int HD>
__global__ void __launch_bounds__(PASS_THREADS)
gt_fwd_kernel(const __nv_bfloat16* __restrict__ blocks,
              const long long* __restrict__ col_off, int TL, int BW,
              long long n_rows, const float* __restrict__ q,
              const float* __restrict__ k, const float* __restrict__ v,
              int H, float scale, float clamp, float eps, int lpr,
              float* __restrict__ out, float* __restrict__ z, int hd) {
  using M = Heads<HD>;
  constexpr int NH = M::NH, F = M::F, NG = M::NG;
  const gate_walk::LaneGroup grp = gate_walk::lane_group(lpr);
  const long long row =
      ((long long)blockIdx.x * PASS_THREADS + threadIdx.x) / lpr;
  const bool active = row < n_rows;
  const long long i = active ? row : 0;
  const int hw = head_width<HD>(hd);
  const int D = H * hw;
  const long long off = col_off[i / TL];
  const __nv_bfloat16* gate = blocks + i * BW;
  for (int c0 = 0; c0 < D; c0 += F * lpr) {
    const int c = c0 + F * grp.lig;
    const bool ok = active && c < D;
    float qi[F], acc[F], zs[NH];
    loadf<F>(q + i * D + c, ok, qi);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h) zs[h] = 0.f;
    unsigned long long m = gate_walk::gate_mask(gate, active, BW / 8, 0, grp);
    while (__any_sync(FULL, m != 0ull)) {
      float a[NG], kj[NG][F], vj[NG][F], rest[NG];
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const int col = gate_walk::take_nonzero(m, 0, grp);
        const bool has = col >= 0;
        const long long j = off + (has ? col : 0);
        a[u] = has ? __bfloat162float(gate[col]) : 0.f;
        loadf<F>(k + j * D + c, has && ok, kj[u]);
        loadf<F>(v + j * D + c, has && ok, vj[u]);
        rest[u] = other_sweeps<HD>(q + i * D, k + j * D, c, hw, has && ok);
      }
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        float s[NH];
        head_dots<HD>(qi, kj[u], s, rest[u]);
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
      storef<F>(out + i * D + c, acc);
      if (NH > 1 || c % hw == 0) {      // the head's leading lane
#pragma unroll
        for (int h = 0; h < NH; ++h) z[i * H + c / hw + h] = zs[h];
      }
    }
  }
}

// The row pass's terms for up to NG nonzero columns (col < 0: none) of row
// i's window at `off`: this lane's features of each k_j (kept for dq),
// and per head the gated exponential e, the clip flag and G = g_i . v_j.
// Every k / v load is issued before any is used.
template <int HD>
__device__ __forceinline__ void row_terms(
    const int* col, const __nv_bfloat16* __restrict__ gate, long long off,
    int D, int c, int hw, bool ok, const float* __restrict__ k,
    const float* __restrict__ v, const float* qi, const float* gi,
    const float* __restrict__ qrow, const float* __restrict__ grow,
    float scale, float clamp, float (*kj)[Heads<HD>::F],
    float (*e)[Heads<HD>::NH], float (*G)[Heads<HD>::NH],
    bool (*inside)[Heads<HD>::NH]) {
  using M = Heads<HD>;
  constexpr int NH = M::NH, F = M::F, NG = M::NG;
  float a[NG], vj[NG][F], rest_s[NG], rest_g[NG];
#pragma unroll
  for (int u = 0; u < NG; ++u) {
    const bool has = col[u] >= 0;
    const long long j = off + (has ? col[u] : 0);
    a[u] = has ? __bfloat162float(gate[col[u]]) : 0.f;
    loadf<F>(k + j * D + c, has && ok, kj[u]);
    loadf<F>(v + j * D + c, has && ok, vj[u]);
    rest_s[u] = other_sweeps<HD>(qrow, k + j * D, c, hw, has && ok);
    rest_g[u] = other_sweeps<HD>(grow, v + j * D, c, hw, has && ok);
  }
#pragma unroll
  for (int u = 0; u < NG; ++u) {
    float s[NH];
    head_dots<HD>(qi, kj[u], s, rest_s[u]);
    head_dots<HD>(gi, vj[u], G[u], rest_g[u]);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float sc = s[h] * scale;
      e[u][h] = gated_exp(sc, a[u], clamp);
      inside[u][h] = (sc >= -clamp) && (sc <= clamp);
    }
  }
}

// The second trip's work for NG terms: dq[f] += dS(head of f) * k_j[f] (e =
// 0 adds 0); and, in the merged pass, this lane's features of
// dk_j += dS q_i scale and dv_j += W g_i, with atomicAdd into buffers the
// caller zeroed.
template <int HD, bool MERGED>
__device__ __forceinline__ void add_terms(
    const int* col, long long off, int D, int c, bool ok,
    const float (*kj)[Heads<HD>::F], const float (*e)[Heads<HD>::NH],
    const float (*G)[Heads<HD>::NH], const bool (*inside)[Heads<HD>::NH],
    const float* rh, const float* inv, const float* qi, const float* gi,
    float scale, float* acc, float* __restrict__ dk,
    float* __restrict__ dv) {
  using M = Heads<HD>;
#pragma unroll
  for (int u = 0; u < M::NG; ++u) {
    float ds[M::NH];
#pragma unroll
    for (int h = 0; h < M::NH; ++h) {
      ds[h] = inside[u][h] ? e[u][h] * (G[u][h] - rh[h]) * inv[h] : 0.f;
#pragma unroll
      for (int j = 0; j < M::PER; ++j)
        acc[h * M::PER + j] = fmaf(ds[h], kj[u][h * M::PER + j],
                                   acc[h * M::PER + j]);
    }
    if (MERGED && ok && col[u] >= 0) {
      float* dkj = dk + (off + col[u]) * D + c;
      float* dvj = dv + (off + col[u]) * D + c;
#pragma unroll
      for (int h = 0; h < M::NH; ++h) {
        const float w = e[u][h] * inv[h];
#pragma unroll
        for (int j = 0; j < M::PER; ++j) {
          const int f = h * M::PER + j;
          atomicAdd(dkj + f, ds[h] * scale * qi[f]);
          atomicAdd(dvj + f, w * gi[f]);
        }
      }
    }
  }
}

// Row pass: lane group of `lpr` lanes per row i < n_rows; in each pass c0
// over the features, lane lig holds features c = c0 + F lig of heads
// c / hw onwards.  Two trips over the row's nonzeros: rho first, then dq.
// MERGED: the merged backward, which in its second trip also adds each
// nonzero's dk and dv terms (and writes no rho); else the two-pass
// backward's row pass, which writes dq and rho.
template <int HD, bool MERGED>
__global__ void __launch_bounds__(PASS_THREADS)
gt_row_pass_kernel(const __nv_bfloat16* __restrict__ blocks,
                   const long long* __restrict__ col_off, int TL, int BW,
                   long long n_rows, const float* __restrict__ q,
                   const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ g, const float* __restrict__ z,
                   int H, float scale, float clamp, float eps, int lpr,
                   float* __restrict__ dq, float* __restrict__ rho,
                   float* __restrict__ dk, float* __restrict__ dv, int hd) {
  using M = Heads<HD>;
  constexpr int NH = M::NH, F = M::F, NG = M::NG;
  const gate_walk::LaneGroup grp = gate_walk::lane_group(lpr);
  const long long row =
      ((long long)blockIdx.x * PASS_THREADS + threadIdx.x) / lpr;
  const bool active = row < n_rows;
  const long long i = active ? row : 0;
  const int hw = head_width<HD>(hd);
  const int D = H * hw;
  const long long off = col_off[i / TL];
  const __nv_bfloat16* gate = blocks + i * BW;
  for (int c0 = 0; c0 < D; c0 += F * lpr) {
    const int c = c0 + F * grp.lig;
    const bool ok = active && c < D;
    const int h0 = c / hw;              // this lane's first head
    float qi[F], gi[F], inv[NH], rh[NH];
    loadf<F>(q + i * D + c, ok, qi);
    loadf<F>(g + i * D + c, ok, gi);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      inv[h] = ok ? 1.f / (z[i * H + h0 + h] + eps) : 0.f;
      rh[h] = 0.f;
    }
    unsigned long long m = gate_walk::gate_mask(gate, active, BW / 8, 0, grp);

    // first trip: rho; the first NG nonzeros' terms stay in registers
    int col0[NG];
    float k0[NG][F], e0[NG][NH], G0[NG][NH];
    bool in0[NG][NH];
#pragma unroll
    for (int u = 0; u < NG; ++u)
      col0[u] = gate_walk::take_nonzero(m, 0, grp);
    row_terms<HD>(col0, gate, off, D, c, hw, ok, k, v, qi, gi, q + i * D,
                  g + i * D, scale, clamp, k0, e0, G0, in0);
#pragma unroll
    for (int u = 0; u < NG; ++u)
#pragma unroll
      for (int h = 0; h < NH; ++h) rh[h] = fmaf(G0[u][h], e0[u][h] * inv[h],
                                                rh[h]);
    const unsigned long long rest = m;   // the nonzeros past the first NG
    while (__any_sync(FULL, m != 0ull)) {
      int col[NG];
      float kj[NG][F], e[NG][NH], G[NG][NH];
      bool in[NG][NH];
#pragma unroll
      for (int u = 0; u < NG; ++u)
        col[u] = gate_walk::take_nonzero(m, 0, grp);
      row_terms<HD>(col, gate, off, D, c, hw, ok, k, v, qi, gi, q + i * D,
                    g + i * D, scale, clamp, kj, e, G, in);
#pragma unroll
      for (int u = 0; u < NG; ++u)
#pragma unroll
        for (int h = 0; h < NH; ++h) rh[h] = fmaf(G[u][h], e[u][h] * inv[h],
                                                  rh[h]);
    }

    // second trip: dS and dq (and the merged pass's dk, dv), from the
    // registers, then the rest again
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
    add_terms<HD, MERGED>(col0, off, D, c, ok, k0, e0, G0, in0, rh, inv, qi,
                          gi, scale, acc, dk, dv);
    m = rest;
    while (__any_sync(FULL, m != 0ull)) {
      int col[NG];
      float kj[NG][F], e[NG][NH], G[NG][NH];
      bool in[NG][NH];
#pragma unroll
      for (int u = 0; u < NG; ++u)
        col[u] = gate_walk::take_nonzero(m, 0, grp);
      row_terms<HD>(col, gate, off, D, c, hw, ok, k, v, qi, gi, q + i * D,
                    g + i * D, scale, clamp, kj, e, G, in);
      add_terms<HD, MERGED>(col, off, D, c, ok, kj, e, G, in, rh, inv, qi,
                            gi, scale, acc, dk, dv);
    }
    if (ok) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] *= scale;
      storef<F>(dq + i * D + c, acc);
      if (!MERGED && (NH > 1 || c % hw == 0)) {   // the head's leading lane
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
                   float* __restrict__ dv, int hd) {
  using M = Heads<HD>;
  constexpr int NH = M::NH, F = M::F, NG = M::NG;
  const gate_walk::LaneGroup grp = gate_walk::lane_group(lpr);
  const long long col =
      ((long long)blockIdx.x * PASS_THREADS + threadIdx.x) / lpr;
  const bool active = col < n_rows;
  const long long cr = active ? col : 0;
  const int hw = head_width<HD>(hd);
  const int D = H * hw;
  const long long off = col_off[cr / TL];
  // A[off + r, c] = A[c, off + r]: row c of this tile's slab
  const __nv_bfloat16* gate = blocks + cr * BW;
  for (int c0 = 0; c0 < D; c0 += F * lpr) {
    const int c = c0 + F * grp.lig;
    const bool ok = active && c < D;
    const int h0 = c / hw;
    float kc[F], vc[F], ak[F], av[F];
    loadf<F>(k + cr * D + c, ok, kc);
    loadf<F>(v + cr * D + c, ok, vc);
#pragma unroll
    for (int f = 0; f < F; ++f) ak[f] = av[f] = 0.f;
    unsigned long long m = gate_walk::gate_mask(gate, active, BW / 8, 0, grp);
    while (__any_sync(FULL, m != 0ull)) {
      int rr[NG];
#pragma unroll
      for (int u = 0; u < NG; ++u)
        rr[u] = gate_walk::take_nonzero(m, 0, grp);
      // rows i = off + rr: q_i, g_i, z_i and rho_i, all loads in flight
      float a[NG], qi[NG][F], gi[NG][F], zi[NG][NH], ri[NG][NH];
      float rest_s[NG], rest_g[NG];
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const bool has = rr[u] >= 0;
        const long long i = off + (has ? rr[u] : 0);
        rest_s[u] = other_sweeps<HD>(k + cr * D, q + i * D, c, hw, has && ok);
        rest_g[u] = other_sweeps<HD>(v + cr * D, g + i * D, c, hw, has && ok);
        a[u] = has ? __bfloat162float(gate[rr[u]]) : 0.f;
        loadf<F>(q + i * D + c, has && ok, qi[u]);
        loadf<F>(g + i * D + c, has && ok, gi[u]);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          zi[u][h] = has && ok ? z[i * H + h0 + h] : 0.f;
          ri[u][h] = has && ok ? rho[i * H + h0 + h] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        float s[NH], G[NH];
        head_dots<HD>(kc, qi[u], s, rest_s[u]);
        head_dots<HD>(vc, gi[u], G, rest_g[u]);
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
      for (int f = 0; f < F; ++f) ak[f] *= scale;
      storef<F>(dk + cr * D + c, ak);
      storef<F>(dv + cr * D + c, av);
    }
  }
}

// Every kernel reads float4s: D a multiple of 4, and a band of whole
// 32-column pieces up to MAX_BAND.
bool bad_geometry(int BW, int H, int hd) {
  return BW <= 0 || BW % 32 != 0 || BW > MAX_BAND || H <= 0 ||
         (H * hd) % 4 != 0;
}

unsigned pass_grid(int n_tiles, int TL, int lpr) {
  const long long threads = (long long)n_tiles * TL * lpr;
  return (unsigned)((threads + PASS_THREADS - 1) / PASS_THREADS);
}

}  // namespace

// The head widths the attention kernels take, as switch cases that
// instantiate their body with HD: a lane holds 4 features up to hd = 128
// (a head on hd / 4 lanes) and hd / 32 past it, so the per-head butterfly
// stays inside a warp; every multiple of SWEEP past SWEEP runs the WIDE
// instantiation in sweeps of SWEEP features.  Other widths are
// zero-padded up to one of these by the wrapper; the wrapper's
// HEAD_WIDTHS and SWEEP state the same set, and build() checks it against
// this one.
#define SCGIB_DISPATCH_HD(hd, ...)                            \
  switch (hd) {                                               \
    case 1: { constexpr int HD = 1; __VA_ARGS__; } break;     \
    case 2: { constexpr int HD = 2; __VA_ARGS__; } break;     \
    case 4: { constexpr int HD = 4; __VA_ARGS__; } break;     \
    case 8: { constexpr int HD = 8; __VA_ARGS__; } break;     \
    case 16: { constexpr int HD = 16; __VA_ARGS__; } break;   \
    case 32: { constexpr int HD = 32; __VA_ARGS__; } break;   \
    case 64: { constexpr int HD = 64; __VA_ARGS__; } break;   \
    case 128: { constexpr int HD = 128; __VA_ARGS__; } break; \
    case 256: { constexpr int HD = 256; __VA_ARGS__; } break; \
    case 512: { constexpr int HD = 512; __VA_ARGS__; } break; \
    default:                                                  \
      if (hd <= SWEEP || hd % SWEEP != 0)                     \
        return (int)cudaErrorInvalidValue;                    \
      { constexpr int HD = WIDE; __VA_ARGS__; }               \
  }

extern "C" {

// Every entry: blocks, the feature operands and the outputs 16-byte
// aligned and H * hd a multiple of 4 (the wrapper checks).

int scgib_gt_fwd(const void* blocks, const void* col_off, int n_tiles, int TL,
                 int BW, const void* q, const void* k, const void* v, int H,
                 int hd, float scale, float clamp, float eps, void* out,
                 void* z, void* stream) {
  if (bad_geometry(BW, H, hd)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_tiles * TL;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(
      hd, const int lpr = lanes_per_row(H * hd, Heads<HD>::F);
      gt_fwd_kernel<HD><<<pass_grid(n_tiles, TL, lpr), PASS_THREADS, 0, s>>>(
          (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
          rows, (const float*)q, (const float*)k, (const float*)v, H, scale,
          clamp, eps, lpr, (float*)out, (float*)z, hd));
  return (int)cudaGetLastError();
}

int scgib_gt_bwd_rows(const void* blocks, const void* col_off, int n_tiles,
                      int TL, int BW, const void* q, const void* k,
                      const void* v, const void* g, const void* z, int H,
                      int hd, float scale, float clamp, float eps, void* dq,
                      void* rho, void* stream) {
  if (bad_geometry(BW, H, hd)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_tiles * TL;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(
      hd, const int lpr = lanes_per_row(H * hd, Heads<HD>::F);
      gt_row_pass_kernel<HD, false><<<pass_grid(n_tiles, TL, lpr),
                                      PASS_THREADS, 0, s>>>(
          (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
          rows, (const float*)q, (const float*)k, (const float*)v,
          (const float*)g, (const float*)z, H, scale, clamp, eps, lpr,
          (float*)dq, (float*)rho, nullptr, nullptr, hd));
  return (int)cudaGetLastError();
}

int scgib_gt_bwd_cols(const void* blocks, const void* col_off, int n_tiles,
                      int TL, int BW, const void* q, const void* k,
                      const void* v, const void* g, const void* z,
                      const void* rho, int H, int hd, float scale,
                      float clamp, float eps, void* dk, void* dv,
                      void* stream) {
  if (bad_geometry(BW, H, hd)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_tiles * TL;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(
      hd, const int lpr = lanes_per_row(H * hd, Heads<HD>::F);
      gt_bwd_cols_kernel<HD><<<pass_grid(n_tiles, TL, lpr), PASS_THREADS, 0,
                               s>>>(
          (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
          rows, (const float*)q, (const float*)k, (const float*)v,
          (const float*)g, (const float*)z, (const float*)rho, H, scale,
          clamp, eps, lpr, (float*)dk, (float*)dv, hd));
  return (int)cudaGetLastError();
}

// dk and dv must be zeroed by the caller (they are accumulated).
int scgib_gt_bwd_merged(const void* blocks, const void* col_off, int n_tiles,
                        int TL, int BW, const void* q, const void* k,
                        const void* v, const void* g, const void* z, int H,
                        int hd, float scale, float clamp, float eps,
                        void* dq, void* dk, void* dv, void* stream) {
  if (bad_geometry(BW, H, hd)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_tiles * TL;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(
      hd, const int lpr = lanes_per_row(H * hd, Heads<HD>::F);
      gt_row_pass_kernel<HD, true><<<pass_grid(n_tiles, TL, lpr),
                                     PASS_THREADS, 0, s>>>(
          (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
          rows, (const float*)q, (const float*)k, (const float*)v,
          (const float*)g, (const float*)z, H, scale, clamp, eps, lpr,
          (float*)dq, nullptr, (float*)dk, (float*)dv, hd));
  return (int)cudaGetLastError();
}

// For the report: registers a thread, shared memory a block and blocks an
// SM of the kernel that gt_bwd_rows (which = 0), gt_bwd_cols (1), gt_fwd
// (2) or gt_bwd_merged (3) launches at head width hd.
int scgib_gt_kernel_info(int which, int hd, int* info) {
  const void* kernel = nullptr;
  SCGIB_DISPATCH_HD(
      hd, kernel = which == 0   ? (const void*)gt_row_pass_kernel<HD, false>
                   : which == 1 ? (const void*)gt_bwd_cols_kernel<HD>
                   : which == 2 ? (const void*)gt_fwd_kernel<HD>
                                : (const void*)gt_row_pass_kernel<HD, true>);
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  int per_sm = 0;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, PASS_THREADS, 0)))
    return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = per_sm;
  return 0;
}

}  // extern "C"
