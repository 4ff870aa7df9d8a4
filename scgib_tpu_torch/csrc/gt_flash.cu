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
//                  gt_row_pass_kernel<HD, MERGED, BF16>.
//   gt_fwd_staged_bf16_kernel, gt_bwd_merged_staged_bf16_kernel
//                  the forward and the merged pass with bf16 dots, staged
//                  in shared memory: their second route (below).
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
// it changes nothing for finite inputs.
//
// bf16 dots (the JAX package's bf16_dots, its default on a TPU): every
// kernel has a second instantiation, BF16, that computes what _hdot and
// _cdot compute on bf16 multiplicands with fp32 accumulation.  Each
// product's two operands are rounded to bf16 (__float2bfloat16_rn) before
// the fp32 FMA chain, and a product of two bf16 values is exact in fp32: q
// and k for the scores, w and v for out, g and v for G, dS and k for dq, dS
// and q for dk, w and g for dv.  exp, clip, z, rho, 1 / (z + eps) and the
// scale stay fp32, the scale applied after the score product and after
// the dq and dk products, as in the Pallas kernels: dS is rounded before it
// is scaled (1 / sqrt(hd) is not a power of two at hd 8, so rnd(dS * scale)
// is not rnd(dS) * scale; folded into q before the rounding it would round
// otherwise).  The forward rounds w = e / (z + eps), which needs z first,
// so its bf16 lane-group form walks the row's nonzeros twice (the staged
// forward, once).  The merged pass's BF16
// form (gt_row_pass_kernel<HD, true, true>, _bwd_merged_kernel with
// bf16=True) is the bf16 row pass whose atomicAdds take the rounded dS and
// q for dk and the rounded w and g for dv, as _cdot(dS_cat, q_t) and
// _cdot(w_cat, g_t) round them.  Still SIMT over the same lane groups.
// Running the bf16 products on the tensor cores (mma.sync or wgmma over
// the dense [TL, BW] tile, which the sparse gate leaves mostly empty) is
// untried, as are TMA and bf16 storage of q, k and v.
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

// x rounded to bf16 (round to nearest even, JAX's astype) and back, where
// BF16: an operand of a product of the bf16-dot kernels (_hdot, _cdot).  A
// product of two bf16 values is exact in fp32, so fp32 FMA over rounded
// operands is the TPU's bf16 x bf16 product with fp32 accumulation.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// F features from p in 16-byte vectors (zeros where !ok), each rounded to
// bf16 where BF16: every feature a kernel loads (q, k, v, g) is an operand
// of a product.
template <int F, bool BF16 = false>
__device__ __forceinline__ void loadf(const float* __restrict__ p, bool ok,
                                      float* x) {
#pragma unroll
  for (int i = 0; i < F / 4; ++i) {
    const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(p) + i)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    x[4 * i] = rnd<BF16>(v.x); x[4 * i + 1] = rnd<BF16>(v.y);
    x[4 * i + 2] = rnd<BF16>(v.z); x[4 * i + 3] = rnd<BF16>(v.w);
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
// 1 in a head of hw features: 0 unless HD is WIDE.  BF16: over the
// operands rounded to bf16.
template <int HD, bool BF16 = false>
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
      s = fmaf(rnd<BF16>(p.x), rnd<BF16>(r.x), s);
      s = fmaf(rnd<BF16>(p.y), rnd<BF16>(r.y), s);
      s = fmaf(rnd<BF16>(p.z), rnd<BF16>(r.z), s);
      s = fmaf(rnd<BF16>(p.w), rnd<BF16>(r.w), s);
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
// in flight before any is used; then out = acc / (z + eps).  BF16 (bf16
// dots): q, k and v rounded to bf16, and w = e / (z + eps) rounded before
// its product with v_j, as _fwd_kernel rounds w_cat; w needs z, so a first
// trip sums z from the scores alone, and the second adds w v_j.
template <int HD, bool BF16>
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
    float qi[F], acc[F], zs[NH], winv[NH];
    loadf<F, BF16>(q + i * D + c, ok, qi);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h) zs[h] = 0.f;
    if constexpr (BF16) {
      unsigned long long m =
          gate_walk::gate_mask(gate, active, BW / 8, 0, grp);
      while (__any_sync(FULL, m != 0ull)) {
        float a[NG], kj[NG][F], rest[NG];
#pragma unroll
        for (int u = 0; u < NG; ++u) {
          const int col = gate_walk::take_nonzero(m, 0, grp);
          const bool has = col >= 0;
          const long long j = off + (has ? col : 0);
          a[u] = has ? __bfloat162float(gate[col]) : 0.f;
          loadf<F, true>(k + j * D + c, has && ok, kj[u]);
          rest[u] = other_sweeps<HD, true>(q + i * D, k + j * D, c, hw,
                                           has && ok);
        }
#pragma unroll
        for (int u = 0; u < NG; ++u) {
          float s[NH];
          head_dots<HD>(qi, kj[u], s, rest[u]);
#pragma unroll
          for (int h = 0; h < NH; ++h)
            zs[h] += gated_exp(s[h] * scale, a[u], clamp);
        }
      }
#pragma unroll
      for (int h = 0; h < NH; ++h) winv[h] = 1.f / (zs[h] + eps);
    }
    unsigned long long m = gate_walk::gate_mask(gate, active, BW / 8, 0, grp);
    while (__any_sync(FULL, m != 0ull)) {
      float a[NG], kj[NG][F], vj[NG][F], rest[NG];
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const int col = gate_walk::take_nonzero(m, 0, grp);
        const bool has = col >= 0;
        const long long j = off + (has ? col : 0);
        a[u] = has ? __bfloat162float(gate[col]) : 0.f;
        loadf<F, BF16>(k + j * D + c, has && ok, kj[u]);
        loadf<F, BF16>(v + j * D + c, has && ok, vj[u]);
        rest[u] = other_sweeps<HD, BF16>(q + i * D, k + j * D, c, hw,
                                         has && ok);
      }
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        float s[NH];
        head_dots<HD>(qi, kj[u], s, rest[u]);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float e = gated_exp(s[h] * scale, a[u], clamp);
          float w = e;
          if constexpr (BF16) w = rnd<true>(e * winv[h]);
          else zs[h] += e;
#pragma unroll
          for (int j = 0; j < M::PER; ++j)
            acc[h * M::PER + j] = fmaf(w, vj[u][h * M::PER + j],
                                       acc[h * M::PER + j]);
        }
      }
    }
    if (ok) {
      if constexpr (!BF16) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float inv = 1.f / (zs[h] + eps);
#pragma unroll
          for (int j = 0; j < M::PER; ++j) acc[h * M::PER + j] *= inv;
        }
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
// Every k / v load is issued before any is used.  BF16: k_j and v_j (and
// the other sweeps' features) rounded to bf16.
template <int HD, bool BF16>
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
    loadf<F, BF16>(k + j * D + c, has && ok, kj[u]);
    loadf<F, BF16>(v + j * D + c, has && ok, vj[u]);
    rest_s[u] = other_sweeps<HD, BF16>(qrow, k + j * D, c, hw, has && ok);
    rest_g[u] = other_sweeps<HD, BF16>(grow, v + j * D, c, hw, has && ok);
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
// caller zeroed.  BF16: dS rounded to bf16 before its products with k_j
// and (merged) q_i, and before the scale, as _bwd_rows_kernel and
// _bwd_merged_kernel round dS_cat; W rounded before its product with g_i,
// as _bwd_merged_kernel rounds w_cat (q_i, g_i and k_j are rounded at
// load).
template <int HD, bool MERGED, bool BF16>
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
      ds[h] = rnd<BF16>(inside[u][h] ? e[u][h] * (G[u][h] - rh[h]) * inv[h]
                                     : 0.f);
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
        const float w = rnd<BF16>(e[u][h] * inv[h]);
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
// backward's row pass, which writes dq and rho.  BF16 (bf16 dots): q, g,
// k and v rounded to bf16 as they are loaded, and dS (and, MERGED, W)
// before its products (add_terms).
template <int HD, bool MERGED, bool BF16>
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
    loadf<F, BF16>(q + i * D + c, ok, qi);
    loadf<F, BF16>(g + i * D + c, ok, gi);
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
    row_terms<HD, BF16>(col0, gate, off, D, c, hw, ok, k, v, qi, gi,
                        q + i * D, g + i * D, scale, clamp, k0, e0, G0, in0);
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
      row_terms<HD, BF16>(col, gate, off, D, c, hw, ok, k, v, qi, gi,
                          q + i * D, g + i * D, scale, clamp, kj, e, G, in);
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
    add_terms<HD, MERGED, BF16>(col0, off, D, c, ok, k0, e0, G0, in0, rh, inv,
                                qi, gi, scale, acc, dk, dv);
    m = rest;
    while (__any_sync(FULL, m != 0ull)) {
      int col[NG];
      float kj[NG][F], e[NG][NH], G[NG][NH];
      bool in[NG][NH];
#pragma unroll
      for (int u = 0; u < NG; ++u)
        col[u] = gate_walk::take_nonzero(m, 0, grp);
      row_terms<HD, BF16>(col, gate, off, D, c, hw, ok, k, v, qi, gi,
                          q + i * D, g + i * D, scale, clamp, kj, e, G, in);
      add_terms<HD, MERGED, BF16>(col, off, D, c, ok, kj, e, G, in, rh, inv,
                                  qi, gi, scale, acc, dk, dv);
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
// in the row pass.  BF16 (bf16 dots): k, v, q and g rounded to bf16 as they
// are loaded, and dS and w before their products with q_i and g_i, as
// _bwd_cols_kernel rounds dS_cat and w_cat.
template <int HD, bool BF16>
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
    loadf<F, BF16>(k + cr * D + c, ok, kc);
    loadf<F, BF16>(v + cr * D + c, ok, vc);
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
        rest_s[u] = other_sweeps<HD, BF16>(k + cr * D, q + i * D, c, hw,
                                           has && ok);
        rest_g[u] = other_sweeps<HD, BF16>(v + cr * D, g + i * D, c, hw,
                                           has && ok);
        a[u] = has ? __bfloat162float(gate[rr[u]]) : 0.f;
        loadf<F, BF16>(q + i * D + c, has && ok, qi[u]);
        loadf<F, BF16>(g + i * D + c, has && ok, gi[u]);
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
          const float ds = rnd<BF16>((sc >= -clamp && sc <= clamp)
                                         ? e * (G[h] - ri[u][h]) * inv : 0.f);
          const float w = rnd<BF16>(e * inv);
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

// --- The staged bf16 kernels: rows 6b and 9b --------------------------------
//
// The forward and the merged backward with bf16 dots, the JAX package's
// own attention on a TPU, have a design of their own where a block's
// operands fit its shared memory (the route, chosen on the host by shape:
// ops/kernels/gt_flash.py::gt_route; other shapes run the lane-group
// kernels above).  One block takes row tile t, or the heads of one of its
// `split` equal parts of the features (Db = D / split features, whole
// heads).  The tile's rows attend to one contiguous window of k and v,
// rows [col_off[t], col_off[t] + BW), as the TPU kernel's block load
// (gt_flash.py:130, 137): the block copies that window of k and v, its own
// q rows (and g rows, and 1 / (z + eps)), and its gate rows [TL, BW] into
// shared memory with 16-byte cp.async copies, rounds every copied operand
// to bf16 once, in place, and then walks each row's nonzeros as the lane
// groups do (a group per row, 4 features a lane, the ballot walk over the
// staged gate), every k_j and v_j read from shared memory.  The rounding
// points are the lane-group kernels' (the comment above gt_fwd_kernel and
// add_terms), and so are the sums' orders but for dk and dv.
//
// gt_fwd_staged_bf16_kernel makes one trip over a row's nonzeros: each
// exponential is computed once and kept, in registers for the first KEEP
// nonzeros and past them in `spill` (device memory the wrapper allocates,
// a row slot of BW - KEEP nonzeros a head for each group of lanes, written
// by each head's leading lane; molecule rows have at most 8 nonzeros, so
// it is rarely touched); z is summed, and w = rnd(e / (z + eps)) times the
// staged v_j is added from the kept values.  No score or exponential is
// computed twice, and no row of k or v is read twice from device memory.
//
// gt_bwd_merged_staged_bf16_kernel runs in two phases.  The row phase is
// the row pass (rho, then dq; the first NG nonzeros' terms kept in
// registers, the rest recomputed from shared memory) and marks each
// nonzero (r, j) in a 64-bit mask of column j (integer atomicOr).  The
// column phase gives each window column j to a lane group, which walks
// the rows of its mask, recomputes their terms from the same operands in
// the same order (so the same dS and W) and sums dk_j and dv_j in
// registers, in row order; then one float4 atomicAdd of each into dk and
// dv (the TPU kernel's window, gt_flash.py:242-245): Db / 4 global
// atomics a touched window column instead of 2 D a nonzero.  Shared-memory
// float atomics, the first design, are compare-and-swap loops on this card
// and were slower (PERF.md).  Windows of neighbouring tiles overlap, so
// the global sums stay unordered where more than two tiles add to a row.

constexpr int STAGED_MAX_THREADS = 512;   // a staged block: 128, 256 or
                                          // 512 threads
constexpr int STAGED_MAX_FEATURES = 128;   // a block's features: one pass
                                           // of at most 32 lanes of 4
constexpr int KEEP = 2 * GATHER;        // exponentials the staged forward
                                        // keeps in registers a row
constexpr size_t SMEM_LIMIT = 232448;   // shared memory one block may take

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// This thread's 16-byte copies of rows r0 .. r0 + rows - 1 of x (`stride`
// floats a row), features cb .. cb + width - 1, into dst [rows][width]:
// pieces threadIdx.x, threadIdx.x + blockDim.x, ... (round_staged
// rounds the same pieces, so a thread needs only its own copies landed).
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ x,
                                      long long r0, int rows, int stride,
                                      int cb, int width) {
  const int per_row = width / 4;
  for (int p = threadIdx.x; p < rows * per_row; p += blockDim.x) {
    const int r = p / per_row;
    cp_async16(dst + 4 * p,
               x + (r0 + r) * stride + cb + 4 * (p - r * per_row));
  }
}

__device__ __forceinline__ void stage_bytes(void* dst, const void* src,
                                            int pieces) {
  for (int p = threadIdx.x; p < pieces; p += blockDim.x)
    cp_async16(static_cast<char*>(dst) + 16 * p,
               static_cast<const char*>(src) + 16 * p);
}

// The pieces of dst that this thread staged, rounded to bf16 in place.
__device__ __forceinline__ void round_staged(float* dst, int pieces) {
  float4* d = reinterpret_cast<float4*>(dst);
  for (int p = threadIdx.x; p < pieces; p += blockDim.x) {
    float4 x = d[p];
    x.x = rnd<true>(x.x); x.y = rnd<true>(x.y);
    x.z = rnd<true>(x.z); x.w = rnd<true>(x.w);
    d[p] = x;
  }
}

// 4 features from shared memory (zeros where !ok).
__device__ __forceinline__ void load4(const float* p, bool ok, float* x) {
  const float4 v = ok ? *reinterpret_cast<const float4*>(p)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// gate_walk::gate_mask over a gate row staged in shared memory.
__device__ __forceinline__ unsigned long long gate_mask_shared(
    const __nv_bfloat16* arow, int nvec, const gate_walk::LaneGroup& g) {
  uint4 v[gate_walk::SEGV];
#pragma unroll
  for (int i = 0; i < gate_walk::SEGV; ++i) {
    const int q = i * g.lpr + g.lig;
    v[i] = q < nvec ? reinterpret_cast<const uint4*>(arow)[q]
                    : make_uint4(0u, 0u, 0u, 0u);
  }
  unsigned long long m = 0ull;
#pragma unroll
  for (int i = 0; i < gate_walk::SEGV; ++i) {
    const unsigned w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if (w[h] & 0x7fffu) m |= 1ull << (8 * i + 2 * h);
      if (w[h] & 0x7fff0000u) m |= 1ull << (8 * i + 2 * h + 1);
    }
  }
  return m;
}

// Per head of this lane, the gated exponential of column col (< 0: none)
// of a row whose rounded q features are qi; k staged [BW][Db].
template <int HD>
__device__ __forceinline__ void staged_exp(int col,
                                           const __nv_bfloat16* gate,
                                           const float* ks, int Db, int c,
                                           bool ok, const float* qi,
                                           float scale, float clamp,
                                           float* e) {
  const bool has = col >= 0;
  float kj[4], s[Heads<HD>::NH];
  load4(ks + (has ? col : 0) * Db + c, has && ok, kj);
  head_dots<HD>(qi, kj, s);
  const float a = has ? __bfloat162float(gate[col]) : 0.f;
#pragma unroll
  for (int h = 0; h < Heads<HD>::NH; ++h)
    e[h] = gated_exp(s[h] * scale, a, clamp);
}

// acc += rnd(e / (z + eps)) v_j over this lane's features, v staged.
template <int HD>
__device__ __forceinline__ void add_wv(int col, const float* e,
                                       const float* winv, const float* vs,
                                       int Db, int c, bool ok, float* acc) {
  using M = Heads<HD>;
  if (col < 0 || !ok) return;
  float vj[4];
  load4(vs + col * Db + c, true, vj);
#pragma unroll
  for (int h = 0; h < M::NH; ++h) {
    const float w = rnd<true>(e[h] * winv[h]);
#pragma unroll
    for (int j = 0; j < M::PER; ++j)
      acc[h * M::PER + j] = fmaf(w, vj[h * M::PER + j], acc[h * M::PER + j]);
  }
}

// Forward, bf16 dots, staged: block = (tile, part); a lane group of `lpr`
// lanes per row, rows slot, slot + slots, ... of the tile.  Shared memory:
// k and v windows and q rows [BW or TL][Db] floats, then the gate rows.
template <int HD>
__global__ void __launch_bounds__(STAGED_MAX_THREADS)
gt_fwd_staged_bf16_kernel(const __nv_bfloat16* __restrict__ blocks,
                          const long long* __restrict__ col_off, int TL,
                          int BW, const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, int H, int split,
                          int lpr, float scale, float clamp, float eps,
                          float* __restrict__ out, float* __restrict__ z,
                          float* __restrict__ spill) {
  using M = Heads<HD>;
  constexpr int NH = M::NH, NG = M::NG;
  static_assert(M::F == 4, "a staged lane holds 4 features");
  extern __shared__ float4 staged_buf[];
  const int t = blockIdx.x / split;
  const int D = H * HD, Db = D / split, cb = (blockIdx.x - t * split) * Db;
  const long long off = col_off[t], r0 = (long long)t * TL;
  float* ks = reinterpret_cast<float*>(staged_buf);
  float* vs = ks + BW * Db;
  float* qs = vs + BW * Db;
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(qs + TL * Db);
  stage(ks, k, off, BW, D, cb, Db);
  stage(vs, v, off, BW, D, cb, Db);
  stage(qs, q, r0, TL, D, cb, Db);
  stage_bytes(gs, blocks + r0 * BW, TL * BW / 8);
  cp_async_wait_all();
  round_staged(ks, BW * Db / 4);
  round_staged(vs, BW * Db / 4);
  round_staged(qs, TL * Db / 4);
  __syncthreads();

  const gate_walk::LaneGroup grp = gate_walk::lane_group(lpr);
  const int slots = blockDim.x / lpr;
  const int c = 4 * grp.lig;               // this lane's first feature
  const bool ok = c < Db;
  const int hg = (cb + c) / HD;            // and its first head
  const int hl = c / HD, Hb = Db / HD;     // in the part, and the part's
  const bool leads = ok && (NH > 1 || c % HD == 0);
  // this group's spill: [BW - KEEP][Hb]
  float* my_spill =
      spill + ((long long)blockIdx.x * slots + threadIdx.x / lpr) *
                  (BW - KEEP) * Hb;
  for (int r = threadIdx.x / lpr; r < TL; r += slots) {
    const __nv_bfloat16* gate = gs + r * BW;
    unsigned long long m = gate_mask_shared(gate, BW / 8, grp);
    float qi[4], zs[NH];
    load4(qs + r * Db + c, ok, qi);
#pragma unroll
    for (int h = 0; h < NH; ++h) zs[h] = 0.f;
    int col0[KEEP];
    float e0[KEEP][NH];
#pragma unroll
    for (int u = 0; u < KEEP; ++u)
      col0[u] = gate_walk::take_nonzero(m, 0, grp);
#pragma unroll
    for (int u = 0; u < KEEP; ++u) {
      staged_exp<HD>(col0[u], gate, ks, Db, c, ok, qi, scale, clamp, e0[u]);
#pragma unroll
      for (int h = 0; h < NH; ++h) zs[h] += e0[u][h];
    }
    const unsigned long long rest = m;     // the nonzeros past the first KEEP
    for (int n = 0; __any_sync(FULL, m != 0ull); n += NG) {
      int col[NG];
#pragma unroll
      for (int u = 0; u < NG; ++u)
        col[u] = gate_walk::take_nonzero(m, 0, grp);
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        float e[NH];
        staged_exp<HD>(col[u], gate, ks, Db, c, ok, qi, scale, clamp, e);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          zs[h] += e[h];
          if (leads && col[u] >= 0) my_spill[(n + u) * Hb + hl + h] = e[h];
        }
      }
    }
    __syncwarp();
    float winv[NH], acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < NH; ++h) winv[h] = 1.f / (zs[h] + eps);
#pragma unroll
    for (int u = 0; u < KEEP; ++u)
      add_wv<HD>(col0[u], e0[u], winv, vs, Db, c, ok, acc);
    m = rest;
    for (int n = 0; __any_sync(FULL, m != 0ull); n += NG) {
      int col[NG];
#pragma unroll
      for (int u = 0; u < NG; ++u)
        col[u] = gate_walk::take_nonzero(m, 0, grp);
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        float e[NH];
#pragma unroll
        for (int h = 0; h < NH; ++h)
          e[h] = ok && col[u] >= 0 ? my_spill[(n + u) * Hb + hl + h] : 0.f;
        add_wv<HD>(col[u], e, winv, vs, Db, c, ok, acc);
      }
    }
    __syncwarp();                          // before the next row's spill
    if (ok) {
      const long long i = r0 + r;
      storef<4>(out + i * D + cb + c, acc);
      if (NH > 1 || c % HD == 0) {      // the head's leading lane
#pragma unroll
        for (int h = 0; h < NH; ++h) z[i * H + hg + h] = zs[h];
      }
    }
  }
}

// The merged pass's terms for NG columns (col < 0: none), from the staged
// k and v: per head the gated exponential, G = g_i . v_j and the clip flag.
template <int HD>
__device__ __forceinline__ void staged_terms(
    const int* col, const __nv_bfloat16* gate, const float* ks,
    const float* vs, int Db, int c, bool ok, const float* qi,
    const float* gi, float scale, float clamp, float (*e)[Heads<HD>::NH],
    float (*G)[Heads<HD>::NH], bool (*inside)[Heads<HD>::NH]) {
  using M = Heads<HD>;
#pragma unroll
  for (int u = 0; u < M::NG; ++u) {
    const bool has = col[u] >= 0;
    const int j = has ? col[u] : 0;
    float kj[4], vj[4], s[M::NH];
    load4(ks + j * Db + c, has && ok, kj);
    load4(vs + j * Db + c, has && ok, vj);
    head_dots<HD>(qi, kj, s);
    head_dots<HD>(gi, vj, G[u]);
    const float a = has ? __bfloat162float(gate[j]) : 0.f;
#pragma unroll
    for (int h = 0; h < M::NH; ++h) {
      const float sc = s[h] * scale;
      e[u][h] = gated_exp(sc, a, clamp);
      inside[u][h] = (sc >= -clamp) && (sc <= clamp);
    }
  }
}

// The row phase's second trip for NG terms: dq += rnd(dS) k_j, dS rounded
// as add_terms rounds it.
template <int HD>
__device__ __forceinline__ void staged_dq(
    const int* col, const float (*e)[Heads<HD>::NH],
    const float (*G)[Heads<HD>::NH], const bool (*inside)[Heads<HD>::NH],
    const float* rh, const float* inv, const float* ks, int Db, int c,
    bool ok, float* acc) {
  using M = Heads<HD>;
#pragma unroll
  for (int u = 0; u < M::NG; ++u) {
    if (col[u] < 0 || !ok) continue;
    float kj[4];
    load4(ks + col[u] * Db + c, true, kj);
#pragma unroll
    for (int h = 0; h < M::NH; ++h) {
      const float ds = rnd<true>(
          inside[u][h] ? e[u][h] * (G[u][h] - rh[h]) * inv[h] : 0.f);
#pragma unroll
      for (int j = 0; j < M::PER; ++j)
        acc[h * M::PER + j] = fmaf(ds, kj[h * M::PER + j],
                                   acc[h * M::PER + j]);
    }
  }
}

// Row r's nonzero columns into the tile's column masks (bit r % 64 of
// word r / 64 of column j), by the group's first lane.
__device__ __forceinline__ void mark_columns(const int* col, int n, int r,
                                             int words,
                                             unsigned long long* cols,
                                             const gate_walk::LaneGroup& g) {
  if (g.lig != 0) return;
  for (int u = 0; u < n; ++u)
    if (col[u] >= 0)
      atomicOr(cols + col[u] * words + r / 64, 1ull << (r % 64));
}

// Merged backward, bf16 dots, staged: block = (tile, part), lane groups as
// in the forward.  Shared memory: k and v windows [BW][Db] and q and g
// rows [TL][Db] (floats), the gate rows [TL][BW], 1 / (z + eps) and rho
// [TL][Hb], and the column masks [BW][words].  Row phase: a group a row,
// rho (the first NG nonzeros' terms kept, the rest recomputed), dq, and
// the row's nonzeros into the column masks.  Column phase: a group a
// window column j, over the rows of its mask the terms again (the same
// operands in the same order, so the same dS and W), dk_j += rnd(dS) q_i
// and dv_j += rnd(W) g_i in registers, then one float4 atomic of each
// into dk (scaled) and dv.  dk and dv must be zeroed by the caller.
template <int HD>
__global__ void __launch_bounds__(STAGED_MAX_THREADS)
gt_bwd_merged_staged_bf16_kernel(
    const __nv_bfloat16* __restrict__ blocks,
    const long long* __restrict__ col_off, int TL, int BW,
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ z, int H, int split, int lpr, float scale,
    float clamp, float eps, float* __restrict__ dq, float* __restrict__ dk,
    float* __restrict__ dv) {
  using M = Heads<HD>;
  constexpr int NH = M::NH, NG = M::NG;
  static_assert(M::F == 4, "a staged lane holds 4 features");
  extern __shared__ float4 staged_buf[];
  const int t = blockIdx.x / split;
  const int D = H * HD, Db = D / split, Hb = Db / HD;
  const int cb = (blockIdx.x - t * split) * Db;
  const int words = (TL + 63) / 64;
  const long long off = col_off[t], r0 = (long long)t * TL;
  float* ks = reinterpret_cast<float*>(staged_buf);
  float* vs = ks + BW * Db;
  float* qs = vs + BW * Db;
  float* gs = qs + TL * Db;
  __nv_bfloat16* gate_s = reinterpret_cast<__nv_bfloat16*>(gs + TL * Db);
  float* invs = reinterpret_cast<float*>(gate_s + TL * BW);
  float* rhos = invs + TL * Hb;
  unsigned long long* cols =
      reinterpret_cast<unsigned long long*>(rhos + TL * Hb);
  stage(ks, k, off, BW, D, cb, Db);
  stage(vs, v, off, BW, D, cb, Db);
  stage(qs, q, r0, TL, D, cb, Db);
  stage(gs, g, r0, TL, D, cb, Db);
  stage_bytes(gate_s, blocks + r0 * BW, TL * BW / 8);
  for (int p = threadIdx.x; p < TL * Hb; p += blockDim.x)
    invs[p] = 1.f / (z[(r0 + p / Hb) * H + cb / HD + p % Hb] + eps);
  for (int p = threadIdx.x; p < BW * words; p += blockDim.x) cols[p] = 0ull;
  cp_async_wait_all();
  round_staged(ks, BW * Db / 4);
  round_staged(vs, BW * Db / 4);
  round_staged(qs, TL * Db / 4);
  round_staged(gs, TL * Db / 4);
  __syncthreads();

  const gate_walk::LaneGroup grp = gate_walk::lane_group(lpr);
  const int slots = blockDim.x / lpr;
  const int c = 4 * grp.lig;
  const bool ok = c < Db;
  const int hl = c / HD;         // this lane's first head in the part
  for (int r = threadIdx.x / lpr; r < TL; r += slots) {
    const __nv_bfloat16* gate = gate_s + r * BW;
    unsigned long long m = gate_mask_shared(gate, BW / 8, grp);
    float qi[4], gi[4], inv[NH], rh[NH];
    load4(qs + r * Db + c, ok, qi);
    load4(gs + r * Db + c, ok, gi);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      inv[h] = ok ? invs[r * Hb + hl + h] : 0.f;
      rh[h] = 0.f;
    }
    // first trip: rho; the first NG nonzeros' terms stay in registers
    int col0[NG];
    float e0[NG][NH], G0[NG][NH];
    bool in0[NG][NH];
#pragma unroll
    for (int u = 0; u < NG; ++u)
      col0[u] = gate_walk::take_nonzero(m, 0, grp);
    mark_columns(col0, NG, r, words, cols, grp);
    staged_terms<HD>(col0, gate, ks, vs, Db, c, ok, qi, gi, scale, clamp, e0,
                     G0, in0);
#pragma unroll
    for (int u = 0; u < NG; ++u)
#pragma unroll
      for (int h = 0; h < NH; ++h) rh[h] = fmaf(G0[u][h], e0[u][h] * inv[h],
                                                rh[h]);
    const unsigned long long rest = m;
    while (__any_sync(FULL, m != 0ull)) {
      int col[NG];
      float e[NG][NH], G[NG][NH];
      bool in[NG][NH];
#pragma unroll
      for (int u = 0; u < NG; ++u)
        col[u] = gate_walk::take_nonzero(m, 0, grp);
      mark_columns(col, NG, r, words, cols, grp);
      staged_terms<HD>(col, gate, ks, vs, Db, c, ok, qi, gi, scale, clamp, e,
                       G, in);
#pragma unroll
      for (int u = 0; u < NG; ++u)
#pragma unroll
        for (int h = 0; h < NH; ++h) rh[h] = fmaf(G[u][h], e[u][h] * inv[h],
                                                  rh[h]);
    }
    // second trip: dq
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    staged_dq<HD>(col0, e0, G0, in0, rh, inv, ks, Db, c, ok, acc);
    m = rest;
    while (__any_sync(FULL, m != 0ull)) {
      int col[NG];
      float e[NG][NH], G[NG][NH];
      bool in[NG][NH];
#pragma unroll
      for (int u = 0; u < NG; ++u)
        col[u] = gate_walk::take_nonzero(m, 0, grp);
      staged_terms<HD>(col, gate, ks, vs, Db, c, ok, qi, gi, scale, clamp, e,
                       G, in);
      staged_dq<HD>(col, e, G, in, rh, inv, ks, Db, c, ok, acc);
    }
    if (ok) {
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[f] *= scale;
      storef<4>(dq + (r0 + r) * D + cb + c, acc);
      if (NH > 1 || c % HD == 0) {      // the head's leading lane
#pragma unroll
        for (int h = 0; h < NH; ++h) rhos[r * Hb + hl + h] = rh[h];
      }
    }
  }
  __syncthreads();

  // column phase: dk_j and dv_j of window column j, summed over the tile's
  // rows in row order, then added once
  for (int j = threadIdx.x / lpr; j < BW; j += slots) {
    float kj[4], vj[4], ak[4] = {0.f, 0.f, 0.f, 0.f},
                        av[4] = {0.f, 0.f, 0.f, 0.f};
    load4(ks + j * Db + c, ok, kj);
    load4(vs + j * Db + c, ok, vj);
    bool touched = false;
    for (int w = 0; w < words; ++w) {
      unsigned long long b = cols[j * words + w];
      touched |= b != 0ull;
      while (__any_sync(FULL, b != 0ull)) {
        const int rr = b ? 64 * w + __ffsll((long long)b) - 1 : -1;
        b &= b - 1ull;
        const bool has = rr >= 0;
        const int r = has ? rr : 0;
        float qr[4], gr[4], s[NH], G[NH];
        load4(qs + r * Db + c, has && ok, qr);
        load4(gs + r * Db + c, has && ok, gr);
        head_dots<HD>(qr, kj, s);
        head_dots<HD>(gr, vj, G);
        const float a = has ? __bfloat162float(gate_s[r * BW + j]) : 0.f;
        if (!(has && ok)) continue;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float sc = s[h] * scale;
          const float e = gated_exp(sc, a, clamp);
          const float inv = invs[r * Hb + hl + h];
          const float ds = rnd<true>((sc >= -clamp && sc <= clamp)
                                         ? e * (G[h] - rhos[r * Hb + hl + h]) *
                                               inv
                                         : 0.f);
          const float wv = rnd<true>(e * inv);
#pragma unroll
          for (int jj = 0; jj < M::PER; ++jj) {
            const int f = h * M::PER + jj;
            ak[f] = fmaf(ds, qr[f], ak[f]);
            av[f] = fmaf(wv, gr[f], av[f]);
          }
        }
      }
    }
    if (touched && ok) {
      const long long at = (off + j) * D + cb + c;
      atomicAdd(reinterpret_cast<float4*>(dk + at),
                make_float4(ak[0] * scale, ak[1] * scale, ak[2] * scale,
                            ak[3] * scale));
      atomicAdd(reinterpret_cast<float4*>(dv + at),
                make_float4(av[0], av[1], av[2], av[3]));
    }
  }
}

// Every kernel reads float4s: D a multiple of 4, and a band of whole
// 32-column pieces up to MAX_BAND.
bool bad_geometry(int BW, int H, int hd) {
  return BW <= 0 || BW % 32 != 0 || BW > MAX_BAND || H <= 0 ||
         (H * hd) % 4 != 0;
}

// The staged kernels take whole heads a part, at most STAGED_MAX_FEATURES
// features a block, tiles of whole warps of rows and blocks of 128, 256 or
// 512 threads.
bool bad_staged(int TL, int BW, int H, int hd, int split, int threads) {
  if (bad_geometry(BW, H, hd) || split < 1 || H % split != 0) return true;
  const int Db = H * hd / split;
  return Db % 4 != 0 || Db > STAGED_MAX_FEATURES || TL <= 0 || TL % 32 != 0 ||
         (threads != 128 && threads != 256 && threads != STAGED_MAX_THREADS);
}

// Dynamic shared memory of a staged block (merged: the backward's).
size_t staged_smem(bool merged, int TL, int BW, int Db, int Hb) {
  const size_t gate = (size_t)TL * BW * sizeof(__nv_bfloat16);
  if (!merged) return 4 * (size_t)(2 * BW + TL) * Db + gate;
  return 4 * ((size_t)(2 * BW + 2 * TL) * Db + (size_t)2 * TL * Hb) + gate +
         8 * (size_t)BW * ((TL + 63) / 64);
}

// Let `kernel` take up to SMEM_LIMIT of dynamic shared memory (once each).
int allow_smem(const void* kernel) {
  static const void* done[64];
  static int n_done = 0;
  for (int i = 0; i < n_done; ++i)
    if (done[i] == kernel) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
  if (err == 0 && n_done < 64) done[n_done++] = kernel;
  return err;
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

// The head widths of the staged kernels: a lane holds 4 features.
#define SCGIB_DISPATCH_STAGED_HD(hd, ...)                     \
  switch (hd) {                                               \
    case 1: { constexpr int HD = 1; __VA_ARGS__; } break;     \
    case 2: { constexpr int HD = 2; __VA_ARGS__; } break;     \
    case 4: { constexpr int HD = 4; __VA_ARGS__; } break;     \
    case 8: { constexpr int HD = 8; __VA_ARGS__; } break;     \
    case 16: { constexpr int HD = 16; __VA_ARGS__; } break;   \
    case 32: { constexpr int HD = 32; __VA_ARGS__; } break;   \
    case 64: { constexpr int HD = 64; __VA_ARGS__; } break;   \
    case 128: { constexpr int HD = 128; __VA_ARGS__; } break; \
    default:                                                  \
      return (int)cudaErrorInvalidValue;                      \
  }

extern "C" {

// Every entry: blocks, the feature operands and the outputs 16-byte
// aligned and H * hd a multiple of 4 (the wrapper checks).

// bf16: the bf16-dot instantiation (bf16_dots=True), else the fp32 one.
int scgib_gt_fwd(const void* blocks, const void* col_off, int n_tiles, int TL,
                 int BW, const void* q, const void* k, const void* v, int H,
                 int hd, float scale, float clamp, float eps, int bf16,
                 void* out, void* z, void* stream) {
  if (bad_geometry(BW, H, hd)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_tiles * TL;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(
      hd, const int lpr = lanes_per_row(H * hd, Heads<HD>::F);
      auto* kernel = bf16 ? gt_fwd_kernel<HD, true> : gt_fwd_kernel<HD, false>;
      kernel<<<pass_grid(n_tiles, TL, lpr), PASS_THREADS, 0, s>>>(
          (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
          rows, (const float*)q, (const float*)k, (const float*)v, H, scale,
          clamp, eps, lpr, (float*)out, (float*)z, hd));
  return (int)cudaGetLastError();
}

int scgib_gt_bwd_rows(const void* blocks, const void* col_off, int n_tiles,
                      int TL, int BW, const void* q, const void* k,
                      const void* v, const void* g, const void* z, int H,
                      int hd, float scale, float clamp, float eps, int bf16,
                      void* dq, void* rho, void* stream) {
  if (bad_geometry(BW, H, hd)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_tiles * TL;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(
      hd, const int lpr = lanes_per_row(H * hd, Heads<HD>::F);
      auto* kernel = bf16 ? gt_row_pass_kernel<HD, false, true>
                          : gt_row_pass_kernel<HD, false, false>;
      kernel<<<pass_grid(n_tiles, TL, lpr), PASS_THREADS, 0, s>>>(
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
                      float clamp, float eps, int bf16, void* dk, void* dv,
                      void* stream) {
  if (bad_geometry(BW, H, hd)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_tiles * TL;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(
      hd, const int lpr = lanes_per_row(H * hd, Heads<HD>::F);
      auto* kernel = bf16 ? gt_bwd_cols_kernel<HD, true>
                          : gt_bwd_cols_kernel<HD, false>;
      kernel<<<pass_grid(n_tiles, TL, lpr), PASS_THREADS, 0, s>>>(
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
                        int hd, float scale, float clamp, float eps, int bf16,
                        void* dq, void* dk, void* dv, void* stream) {
  if (bad_geometry(BW, H, hd)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_tiles * TL;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(
      hd, const int lpr = lanes_per_row(H * hd, Heads<HD>::F);
      auto* kernel = bf16 ? gt_row_pass_kernel<HD, true, true>
                          : gt_row_pass_kernel<HD, true, false>;
      kernel<<<pass_grid(n_tiles, TL, lpr), PASS_THREADS, 0, s>>>(
          (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
          rows, (const float*)q, (const float*)k, (const float*)v,
          (const float*)g, (const float*)z, H, scale, clamp, eps, lpr,
          (float*)dq, nullptr, (float*)dk, (float*)dv, hd));
  return (int)cudaGetLastError();
}

// For the report: registers a thread, shared memory a block and blocks an
// SM of the kernel that gt_bwd_rows (which = 0), gt_bwd_cols (1), gt_fwd
// (2), gt_bwd_merged (3), or with bf16 dots gt_bwd_rows (4), gt_bwd_cols
// (5), gt_fwd (6) or gt_bwd_merged (7) launches at head width hd.
int scgib_gt_kernel_info(int which, int hd, int* info) {
  const void* kernel = nullptr;
  SCGIB_DISPATCH_HD(
      hd, const void* table[] = {
              (const void*)gt_row_pass_kernel<HD, false, false>,
              (const void*)gt_bwd_cols_kernel<HD, false>,
              (const void*)gt_fwd_kernel<HD, false>,
              (const void*)gt_row_pass_kernel<HD, true, false>,
              (const void*)gt_row_pass_kernel<HD, false, true>,
              (const void*)gt_bwd_cols_kernel<HD, true>,
              (const void*)gt_fwd_kernel<HD, true>,
              (const void*)gt_row_pass_kernel<HD, true, true>};
      if (which < 0 || which > 7) return (int)cudaErrorInvalidValue;
      kernel = table[which]);
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

// The staged forward with bf16 dots (the gt_fwd wrapper's staged route):
// n_tiles * split blocks of `threads`.  spill: n_tiles * split * (threads
// / lanes_per_row(H * hd / split, 4)) * (BW - KEEP) * (H / split) floats
// the wrapper allocates.
int scgib_gt_fwd_staged(const void* blocks, const void* col_off, int n_tiles,
                        int TL, int BW, const void* q, const void* k,
                        const void* v, int H, int hd, int split, int threads,
                        float scale, float clamp, float eps, void* out,
                        void* z, void* spill, void* stream) {
  if (bad_staged(TL, BW, H, hd, split, threads))
    return (int)cudaErrorInvalidValue;
  const int Db = H * hd / split;
  const size_t smem = staged_smem(false, TL, BW, Db, Db / hd);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_STAGED_HD(
      hd, auto* kernel = gt_fwd_staged_bf16_kernel<HD>;
      if (const int err = allow_smem((const void*)kernel)) return err;
      kernel<<<n_tiles * split, threads, smem, s>>>(
          (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
          (const float*)q, (const float*)k, (const float*)v, H, split,
          lanes_per_row(Db, 4), scale, clamp, eps, (float*)out, (float*)z,
          (float*)spill));
  return (int)cudaGetLastError();
}

// The staged merged backward with bf16 dots (the gt_bwd_merged wrapper's
// staged route).  dk and dv must be zeroed by the caller.
int scgib_gt_bwd_merged_staged(const void* blocks, const void* col_off,
                               int n_tiles, int TL, int BW, const void* q,
                               const void* k, const void* v, const void* g,
                               const void* z, int H, int hd, int split,
                               int threads, float scale, float clamp,
                               float eps, void* dq, void* dk, void* dv,
                               void* stream) {
  if (bad_staged(TL, BW, H, hd, split, threads))
    return (int)cudaErrorInvalidValue;
  const int Db = H * hd / split;
  const size_t smem = staged_smem(true, TL, BW, Db, Db / hd);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_STAGED_HD(
      hd, auto* kernel = gt_bwd_merged_staged_bf16_kernel<HD>;
      if (const int err = allow_smem((const void*)kernel)) return err;
      kernel<<<n_tiles * split, threads, smem, s>>>(
          (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)g, (const float*)z, H, split, lanes_per_row(Db, 4),
          scale, clamp, eps, (float*)dq, (float*)dk, (float*)dv));
  return (int)cudaGetLastError();
}

// For the report: registers a thread, shared memory a block (static and
// dynamic) and blocks an SM of the staged forward (which = 0) or merged
// backward (1) at this shape; an error for a shape they do not take.
int scgib_gt_staged_info(int which, int hd, int H, int TL, int BW, int split,
                         int threads, int* info) {
  if (which < 0 || which > 1 || bad_staged(TL, BW, H, hd, split, threads))
    return (int)cudaErrorInvalidValue;
  const int Db = H * hd / split;
  const size_t smem = staged_smem(which == 1, TL, BW, Db, Db / hd);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const void* kernel = nullptr;
  SCGIB_DISPATCH_STAGED_HD(
      hd, kernel = which ? (const void*)gt_bwd_merged_staged_bf16_kernel<HD>
                         : (const void*)gt_fwd_staged_bf16_kernel<HD>);
  int err = allow_smem(kernel);
  if (err) return err;
  cudaFuncAttributes attr;
  if ((err = (int)cudaFuncGetAttributes(&attr, kernel))) return err;
  int per_sm = 0;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)))
    return err;
  info[0] = attr.numRegs;
  info[1] = (int)(attr.sharedSizeBytes + smem);
  info[2] = per_sm;
  return 0;
}

}  // extern "C"
