// Banded-adjacency kernels for Hopper (sm_90a): the CUDA counterparts of the
// five Pallas kernels in scgib_tpu/ops/pallas/banded.py.
//
//   banded_spmm    out = A x  (+ x with add_self) over the banded layout.
//                  Replaces _spmm_kernel (#4, recon cross term),
//                  _spmm_self_kernel (#3, GIN backward stage 2) and
//                  _pool_kernel (#5, candidate pooling, window 1024).
//   gin_fused_fwd  relu((h + A h) W1 + b1) W2 + b2 per row tile.
//                  Replaces _kernel (#1).
//   gin_fused_bwd  recompute z0 = h + A h and z1 = z0 W1 + b1, then
//                  gz1 = (g W2^T) * [z1 > 0], gz0 = gz1 W1^T, and one
//                  partial of dW1, db1, dW2, db2 per block.  Replaces
//                  _bwd_kernel (#2).
//
// Layout (graph/banded.py): blocks [T, 128, W] bf16, col_off [T] int64; row
// tile t of 128 rows reads the window x[col_off[t] : col_off[t] + W].  The
// entries are edge counts, 0 or 1 but for repeated edges.
//
// What bounds them on an H100.  At the main path's widths (d <= 64, N = 3072
// or 9728 rows) a call moves a few MB and does well under a GFLOP, so the
// floor is a few microseconds: HBM bytes for the SpMM and the forward
// (gin_fused_fwd at S, d = 64: blocks 5.0 MB, h and out 2.5 MB each, 3.0
// us at 3.35 TB/s), fp32 operations for the backward.  What keeps such
// kernels far above it is latency: walking a band in dense column chunks
// makes each chunk a dependent load, a barrier and a product over mostly
// zeros (a band row holds 2-4 ones in 256, a pooling row ~3 in 1024).
//
// banded_spmm (band_row below) is a sparse gather.  A group of lanes owns
// one row: as many lanes as cover the row's feature columns in float4s
// (16 at d = 64, 8 at d = 32), so a warp takes two to four rows at once.
// The group reads the row's slab with 16-byte loads, all issued together
// with the window offset and, for x + A x, the row of x itself: one round
// trip.  It then finds the nonzeros with warp ballots, without a barrier or
// shared memory (the scan and the walk are gate_walk.cuh, which the
// attention kernels in gt_flash.cu share), and gathers only those x rows,
// four at a time, all in flight together: the second round trip, a third
// only past four nonzeros.
// Sums are fp32 FMA in registers, exact for the 0/1 operand (the pooling
// needs no hi/lo split), in the same order in every run.
//
// gin_fused_fwd and gin_fused_bwd share that gather: a tile's z0 = h + A h
// goes to shared memory by band_row (gather_z0), 16 columns a lane when the
// width allows, so that one pass covers the tile; their products run on
// the tensor cores as mma.sync m16n8k8 TF32 with the 3xTF32 split (hi*hi +
// hi*lo + lo*hi, fp32 accumulate; about 21 bits, not TF32's 11), each warp
// keeping two to sixteen independent accumulator chains so the mma
// latencies overlap.  W1, W2 and the biases are staged in shared memory
// with cp.async while the gather runs.  Widths are padded with zeros in
// shared memory, so any width up to 128 runs.  Neither kernel uses
// atomics: both give the same bits from run to run on one card.
//
// gin_fused_fwd: one block of 8 warps per row tile of 32 rows (304 blocks
// at S), at most 85 registers a thread so that three blocks share an SM
// and hide each other's round trips; all 304 fit on the card at once.
// The products (z0 W1, then relu(z1) W2 at 3xTF32: 159 MFLOP at S, d =
// 64, about 1 us at the tensor cores' rate against 2.4 us at the fp32
// SIMT peak) write relu(z1) to shared memory and the output from the
// fragments straight to global memory.  The weights' copies allocate in
// L1, which the blocks on an SM share: staged through L2 alone, every
// block's 32 KB of weights (at width 64) was 40% of the bytes into the SMs
// at S.  Measured on the card (clock64 per phase, S, d = 64): a block
// spends ~7200 cycles on the gather and its staging and ~5600 on the two
// products; the 85-register cap, the L1-allocating copies and 32-row
// tiles each measured faster than the alternatives tried (64-row tiles, a
// persistent grid, weights read through L1 in the products; PERF.md).  It
// is latency-bound.  The first design walked the band in dense
// 32-column chunks staged in shared memory (a barrier and a product over
// mostly zeros per chunk) and ran both products as fp32 SIMT out of shared
// memory: 13x its byte bound.
//
// gin_fused_bwd is persistent: one block of 8 warps per SM stages W1, W2
// and b1 once, loops over row tiles of 64 rows (32 above width 64), and
// keeps dW1 and dW2 in registers across its tiles, so the grid writes one
// small partial per block that the caller sums in a fixed order.  Its five
// products are z1, g W2^T, gz0, dW2 and dW1.  What bounds it on the card
// is latency more than the tensor cores: one tile is a chain of the weight
// and g staging, the gather's two round trips and five dependent products,
// with 8 warps an SM to hide it (more blocks an SM would cap registers at
// 128 and spill; measured slower).
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (ops/kernels/banded.py).  Every entry launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_walk.cuh"

namespace {

constexpr int TILE = 128;         // rows of one banded block

using gate_walk::FULL;
using gate_walk::SEGV;
constexpr int SPMM_THREADS = 128;
constexpr int GIN_THREADS = 256;  // 8 warps: gin_fused_fwd, gin_fused_bwd

// --- sparse gather of one band row (banded_spmm, the GIN kernels) ----------

// VEC consecutive floats, as float4s when VEC is a multiple of 4 (p then
// 16-byte aligned).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float v[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float v[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// One lane group of `lpr` lanes (a power of two; every group of the warp
// calls this together) adds, for its row `arow` of A,
//   acc[j] += sum_k A[row][k] * xw[k * ld + c + j],  j < VEC,
// over the band k < W, where rows k >= rows_left (windows running past the
// end of x) read as 0, with GATHER rows of x in flight.  `active` is false
// for a group without a row; `col_ok` false for a lane past the last
// column.
template <int VEC, int GATHER>
__device__ void band_row(const __nv_bfloat16* __restrict__ arow, bool active,
                         int W, const float* __restrict__ xw,
                         long long rows_left, int ld, int c, bool col_ok,
                         int lpr, float acc[VEC]) {
  const gate_walk::LaneGroup grp = gate_walk::lane_group(lpr);
  const int nvec = W / 8;                  // 16-byte vectors in a row
  for (int s0 = 0; s0 < nvec; s0 += SEGV * lpr) {
    unsigned long long m = gate_walk::gate_mask(arow, active, nvec, s0, grp);
    // take the group's nonzeros GATHER at a time; every lane of the group
    // gathers its columns of each x row
    while (__any_sync(FULL, m != 0ull)) {
      int col[GATHER];
#pragma unroll
      for (int u = 0; u < GATHER; ++u)
        col[u] = gate_walk::take_nonzero(m, s0, grp);
      float a[GATHER], xv[GATHER][VEC];
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        a[u] = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) xv[u][j] = 0.f;
        if (col[u] >= 0 && col[u] < rows_left) {
          a[u] = __bfloat162float(arow[col[u]]);
          if (col_ok) load_vec<VEC>(xw + (long long)col[u] * ld + c, xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < GATHER; ++u)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = fmaf(a[u], xv[u][j], acc[j]);
    }
  }
}

// out[T*128, d] = A x (+ x): one lane group of `lpr` lanes per row, columns
// in passes of lpr * VEC.
template <int VEC>
__global__ void __launch_bounds__(SPMM_THREADS)
banded_spmm_kernel(const __nv_bfloat16* __restrict__ blocks,
                   const long long* __restrict__ col_off, int W,
                   const float* __restrict__ x, long long nx, int d,
                   float* __restrict__ out, long long nrows, int add_self,
                   int lpr) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * SPMM_THREADS + threadIdx.x) >> 5;
  const long long row = warp * (32 / lpr) + lane / lpr;
  const bool active = row < nrows;
  const long long r = active ? row : 0;
  const long long off = col_off[r / TILE];
  const __nv_bfloat16* arow = blocks + r * W;
  for (int c0 = 0; c0 < d; c0 += lpr * VEC) {
    const int c = c0 + (lane % lpr) * VEC;
    const bool col_ok = active && c < d;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    if (add_self && col_ok) load_vec<VEC>(x + r * d + c, acc);
    band_row<VEC, 4>(arow, active, W, x + off * d, nx - off, d, c, col_ok,
                     lpr, acc);
    if (col_ok) store_vec<VEC>(out + r * d + c, acc);
  }
}

// --- 3xTF32 tensor-core products (gin_fused_bwd) ---------------------------

// x = hi + lo exactly, hi the top 11 significant bits (a TF32 value, cut
// by a mask: a cvt costs several instructions and is the bottleneck of the
// products otherwise).  The tensor core reads lo's top 11 bits too, so the
// split keeps about 21 of the 24 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i] += A[m0:m0+16, 0:K] B[0:K, n0 + i step : + 8] for i < cnt <= NT, by
// one warp, in the m16n8k8 fragment layout (c[i][0], c[i][1] at row
// m0 + lane/4, columns n0 + i step + 2 (lane%4) and + 1; c[i][2], c[i][3]
// eight rows below).  A(m, k) and B(k, n) read shared memory; K is a
// multiple of 8.  Each operand is split into a TF32 high part and a TF32
// remainder, and the three products that matter are summed smallest first
// in fp32.  The NT products share each A fragment and form independent
// chains of dependent mma, issued without branches so that they overlap.
template <int NT, class FA, class FB>
__device__ __forceinline__ void mma_3xtf32(float c[NT][4], FA A, FB B,
                                           int m0, int n0, int step, int cnt,
                                           int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    split_tf32(A(m0 + g, k0 + t), ah[0], al[0]);
    split_tf32(A(m0 + g + 8, k0 + t), ah[1], al[1]);
    split_tf32(A(m0 + g, k0 + t + 4), ah[2], al[2]);
    split_tf32(A(m0 + g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      // no branch: a chain past cnt repeats the first one's reads, and its
      // sums are never stored
      const int n = n0 + (i < cnt ? i : 0) * step + g;
      uint32_t bh[2], bl[2];
      split_tf32(B(k0 + t, n), bh[0], bl[0]);
      split_tf32(B(k0 + t + 4, n), bh[1], bl[1]);
      mma_tf32(c[i], al, bh);
      mma_tf32(c[i], ah, bl);
      mma_tf32(c[i], ah, bh);
    }
  }
}

// The 16 x 8 output tiles of an [M, N] product that this warp of 8 takes:
// row tile m0 = 16 (warp % (M/16)), column tiles n0 + i step for i < cnt.
// M / 16 divides 8.
struct WarpTiles {
  int m0, n0, step, cnt;
};

__device__ __forceinline__ WarpTiles warp_tiles(int M, int N) {
  const int warp = threadIdx.x >> 5, nm = M / 16, wpm = 8 / nm;
  const int first = warp / nm, nn = N / 8;
  // a warp without a tile reads tile 0, in bounds, and stores nothing
  return {(warp % nm) * 16, first < nn ? first * 8 : 0, wpm * 8,
          first < nn ? (nn - first + wpm - 1) / wpm : 0};
}

__host__ __device__ constexpr int pad16(int v) { return (v + 15) & ~15; }

// The row dimensions of the weight-gradient products are padded to 16,
// 32, 64 or 128, so that their row tiles divide the 8 warps.
__host__ __device__ constexpr int pad_pow2(int v) {
  return v <= 16 ? 16 : v <= 32 ? 32 : v <= 64 ? 64 : 128;
}

// Shared-memory floats of gin_fused_bwd: W1 [DP][HP+4], W2 [HP][OP+4],
// b1 [HP], and per tile z0 [MT][DP+4], g [MT][OP+4], z1 and gz1 [MT][HP+4],
// with DP = pad_pow2(din), HP = pad_pow2(hid), OP = pad16(dout) and the
// padding zero.  Rows are padded by 4 floats so the fragment reads of a
// warp spread over the banks.
__host__ __device__ constexpr int bwd_smem_floats(int mt, int din, int hid,
                                                  int dout) {
  return pad_pow2(din) * (pad_pow2(hid) + 4)
         + pad_pow2(hid) * (pad16(dout) + 4) + pad_pow2(hid)
         + mt * ((pad_pow2(din) + 4) + (pad16(dout) + 4)
                 + 2 * (pad_pow2(hid) + 4));
}

// Zero the entries of a shared [RP, CP] array (row stride ld) outside its
// [R, C] corner.
__device__ void zero_pad(float* a, int R, int C, int RP, int CP, int ld) {
  if (R == RP && C == CP) return;
  for (int e = threadIdx.x; e < RP * CP; e += GIN_THREADS) {
    const int r = e / CP, c = e % CP;
    if (r >= R || c >= C) a[r * ld + c] = 0.f;
  }
}

// sum_r a[r * ld], as four interleaved partial sums added in a fixed order.
template <int R>
__device__ __forceinline__ float column_sum(const float* a, int ld) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < R; ++r) s[r % 4] += a[r * ld];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// Copy a row-major [R, C] matrix into shared memory with row stride ld
// (a multiple of 4; dst 16-byte aligned), asynchronously: 16-byte copies
// when the rows allow it, else 4-byte ones.  The caller commits and waits.
// CACHE_L1: the 16-byte copies allocate in L1 too (cp.async.ca), so that
// the blocks on one SM share one read from L2 of what they all stage.
template <bool CACHE_L1 = false>
__device__ void stage_async(float* dst, int ld, const float* src, int R,
                            int C) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  if (C % 4 == 0 && ((uintptr_t)src & 15) == 0) {
    const int cv = C / 4;
    for (int e = threadIdx.x; e < R * cv; e += GIN_THREADS) {
      const int r = e / cv, c = (e % cv) * 4;
      const uint32_t to = base + 4u * (r * ld + c);
      const float* from = src + (long long)r * C + c;
      if constexpr (CACHE_L1)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(to),
                     "l"(from));
      else
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to),
                     "l"(from));
    }
  } else {
    for (int e = threadIdx.x; e < R * C; e += GIN_THREADS) {
      const int r = e / C, c = e % C;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       base + 4u * (r * ld + c)),
                   "l"(src + e));
    }
  }
}

// z0 = h + A h for the MT rows from row0 (inside one band tile: MT divides
// 128) into shared memory, row stride ld: a lane group of lpr lanes a row,
// VEC columns a lane, GATHER rows of h in flight (band_row).
template <int VEC, int MT, int GATHER>
__device__ __forceinline__ void gather_z0(
    const __nv_bfloat16* __restrict__ blocks,
    const long long* __restrict__ col_off, int W, const float* __restrict__ h,
    long long n, int din, long long row0, int lpr, float* sz0, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / lpr;                  // rows a warp gathers at once
  const long long off = col_off[row0 / TILE];
  for (int r1 = 0; r1 < MT; r1 += (GIN_THREADS / 32) * rpw) {
    const int r = r1 + warp * rpw + lane / lpr;
    const bool active = r < MT;
    const long long row = row0 + (active ? r : 0);
    for (int c0 = 0; c0 < din; c0 += lpr * VEC) {
      const int c = c0 + (lane % lpr) * VEC;
      const bool col_ok = active && c < din;
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
      if (col_ok) load_vec<VEC>(h + row * din + c, acc);
      band_row<VEC, GATHER>(blocks + row * W, active, W, h + off * din,
                            n - off, din, c, col_ok, lpr, acc);
      if (col_ok) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) sz0[r * ld + c + j] = acc[j];
      }
    }
  }
}

// Persistent: each block loops over row tiles of MT rows; MAXFR bounds the
// dW1 / dW2 fragments a warp keeps in registers (4 up to widths 64, 16 up
// to 128).  part[block] = [dW1 (din x hid) | db1 | dW2 (hid x dout) | db2].
template <int VEC, int MT, int MAXFR>
__global__ void __launch_bounds__(GIN_THREADS, 1)
gin_fused_bwd_kernel(const __nv_bfloat16* __restrict__ blocks,
                     const long long* __restrict__ col_off, int W,
                     const float* __restrict__ h, long long n, int din,
                     const float* __restrict__ g,
                     const float* __restrict__ w1,
                     const float* __restrict__ b1, int hid,
                     const float* __restrict__ w2, int dout,
                     float* __restrict__ gz0, float* __restrict__ part,
                     int lpr) {
  extern __shared__ float smem[];
  const int DP = pad_pow2(din), HP = pad_pow2(hid), OP = pad16(dout);
  const int LD = DP + 4, LH = HP + 4, LO = OP + 4;
  float* sw1 = smem;                 // W1[k][j]
  float* sw2 = sw1 + DP * LH;        // W2[j][o]
  float* sb1 = sw2 + HP * LO;
  float* sz0 = sb1 + HP;             // z0 = h + A h
  float* sg = sz0 + MT * LD;         // this tile's rows of g
  float* sz1 = sg + MT * LO;         // pre-activation z1
  float* sgz1 = sz1 + MT * LH;       // (g W2^T) * [z1 > 0]
  const int tid = threadIdx.x, lane = tid & 31;
  const int fg = lane >> 2, ft = lane & 3;   // fragment row / column group

  // zeros in the padding of the staged operands, once (the copies never
  // write there, and the products fill z1 and gz1 whole)
  zero_pad(sw1, din, hid, DP, HP, LH);
  zero_pad(sw2, hid, dout, HP, OP, LO);
  zero_pad(sb1, 1, hid, 1, HP, HP);
  zero_pad(sz0, MT, din, MT, DP, LD);
  zero_pad(sg, MT, dout, MT, OP, LO);
  stage_async(sw1, LH, w1, din, hid);
  stage_async(sw2, LO, w2, hid, dout);
  stage_async(sb1, HP, b1, 1, hid);
  asm volatile("cp.async.commit_group;");

  float dw1[MAXFR][4], dw2[MAXFR][4];
#pragma unroll
  for (int i = 0; i < MAXFR; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) dw1[i][q] = dw2[i][q] = 0.f;
  float db = 0.f;   // threads < 128: db1[tid]; the others db2[tid - 128]
  const WarpTiles t1 = warp_tiles(DP, HP), t2 = warp_tiles(HP, OP);
  const WarpTiles tz = warp_tiles(MT, HP), t0 = warp_tiles(MT, DP);

  for (long long tile = blockIdx.x; tile < n / MT; tile += gridDim.x) {
    const long long row0 = tile * MT;
    stage_async(sg, LO, g + row0 * dout, MT, dout);
    asm volatile("cp.async.commit_group;");
    gather_z0<VEC, MT, 2>(blocks, col_off, W, h, n, din, row0, lpr, sz0, LD);
    asm volatile("cp.async.wait_all;");
    __syncthreads();

    // z1 = z0 W1 + b1
    {
      float c[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = tz.n0 + i * tz.step + 2 * ft;
        c[i][0] = c[i][2] = sb1[j];
        c[i][1] = c[i][3] = sb1[j + 1];
      }
      mma_3xtf32<4>(c, [=](int m, int k) { return sz0[m * LD + k]; },
                    [=](int k, int j) { return sw1[k * LH + j]; }, tz.m0,
                    tz.n0, tz.step, tz.cnt, DP);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < tz.cnt) {
          float* z = sz1 + (tz.m0 + fg) * LH + tz.n0 + i * tz.step + 2 * ft;
          z[0] = c[i][0]; z[1] = c[i][1];
          z[8 * LH] = c[i][2]; z[8 * LH + 1] = c[i][3];
        }
      }
    }
    __syncthreads();

    // gz1 = (g W2^T) * [z1 > 0]
    {
      float c[4][4] = {};
      mma_3xtf32<4>(c, [=](int m, int k) { return sg[m * LO + k]; },
                    [=](int k, int j) { return sw2[j * LO + k]; }, tz.m0,
                    tz.n0, tz.step, tz.cnt, OP);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < tz.cnt) {
          const int e = (tz.m0 + fg) * LH + tz.n0 + i * tz.step + 2 * ft;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int eq = e + (q >> 1) * 8 * LH + (q & 1);
            sgz1[eq] = sz1[eq] > 0.f ? c[i][q] : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // gz0 = gz1 W1^T, straight to global memory
    {
      float c[4][4] = {};
      mma_3xtf32<4>(c, [=](int m, int k) { return sgz1[m * LH + k]; },
                    [=](int k, int i) { return sw1[i * LH + k]; }, t0.m0,
                    t0.n0, t0.step, t0.cnt, HP);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = t0.n0 + i * t0.step + 2 * ft;
        float* o = gz0 + (row0 + t0.m0 + fg) * din + col;
        if (i < t0.cnt && col < din) { o[0] = c[i][0]; o[8 * din] = c[i][2]; }
        if (i < t0.cnt && col + 1 < din) {
          o[1] = c[i][1]; o[8 * din + 1] = c[i][3];
        }
      }
    }
    // dW2 += relu(z1)^T g and dW1 += z0^T gz1 over the tile's rows
    mma_3xtf32<MAXFR>(dw2,
                      [=](int j, int r) {
                        return fmaxf(sz1[r * LH + j], 0.f);
                      },
                      [=](int r, int o) { return sg[r * LO + o]; }, t2.m0,
                      t2.n0, t2.step, t2.cnt, MT);
    mma_3xtf32<MAXFR>(dw1, [=](int k, int r) { return sz0[r * LD + k]; },
                      [=](int r, int j) { return sgz1[r * LH + j]; }, t1.m0,
                      t1.n0, t1.step, t1.cnt, MT);
    if (tid < hid) {
      db += column_sum<MT>(sgz1 + tid, LH);
    } else if (tid >= 128 && tid - 128 < dout) {
      db += column_sum<MT>(sg + tid - 128, LO);
    }
    __syncthreads();   // the next tile overwrites z0, g, z1 and gz1
  }
  asm volatile("cp.async.wait_all;");

  // this block's partial
  float* pw1 = part + (long long)blockIdx.x
                          * (din * hid + hid + hid * dout + dout);
  float* pb1 = pw1 + din * hid;
  float* pw2 = pb1 + hid;
  float* pb2 = pw2 + hid * dout;
#pragma unroll
  for (int i = 0; i < MAXFR; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int dm = fg + 8 * (q >> 1), dn = 2 * ft + (q & 1);
      const int k = t1.m0 + dm, j = t1.n0 + i * t1.step + dn;
      if (i < t1.cnt && k < din && j < hid) pw1[k * hid + j] = dw1[i][q];
      const int j2 = t2.m0 + dm, o = t2.n0 + i * t2.step + dn;
      if (i < t2.cnt && j2 < hid && o < dout) pw2[j2 * dout + o] = dw2[i][q];
    }
  }
  if (tid < hid) pb1[tid] = db;
  else if (tid >= 128 && tid - 128 < dout) pb2[tid - 128] = db;
}

// Shared-memory floats of gin_fused_fwd: W1 [DP][HP+4], W2 [HP][OP+4],
// b1 [HP], b2 [OP], and per tile z0 [MT][DP+4] and relu(z1) [MT][HP+4],
// padded as in gin_fused_bwd.
__host__ __device__ constexpr int fwd_smem_floats(int mt, int din, int hid,
                                                  int dout) {
  return pad_pow2(din) * (pad_pow2(hid) + 4)
         + pad_pow2(hid) * (pad16(dout) + 4) + pad_pow2(hid) + pad16(dout)
         + mt * ((pad_pow2(din) + 4) + (pad_pow2(hid) + 4));
}

// c[i] = the bias pair of the columns of this lane's fragments of tile i.
template <int NT>
__device__ __forceinline__ void bias_frags(float c[NT][4], const float* sb,
                                           const WarpTiles& t) {
  const int ft = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int j = t.n0 + (i < t.cnt ? i : 0) * t.step + 2 * ft;
    c[i][0] = c[i][2] = sb[j];
    c[i][1] = c[i][3] = sb[j + 1];
  }
}

// One row tile of MT rows a block (MT divides 128).  NT bounds the
// 16 x 8 output tiles a warp takes in either product.  At most 85
// registers, so that 3 blocks share an SM; the weights' copies allocate
// in L1 (the source note says why).
template <int VEC, int MT, int NT>
__global__ void __launch_bounds__(GIN_THREADS, 3)
gin_fused_fwd_kernel(const __nv_bfloat16* __restrict__ blocks,
                     const long long* __restrict__ col_off, int W,
                     const float* __restrict__ h, long long n, int din,
                     const float* __restrict__ w1,
                     const float* __restrict__ b1, int hid,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2, int dout,
                     float* __restrict__ out, int lpr) {
  extern __shared__ float smem[];
  const int DP = pad_pow2(din), HP = pad_pow2(hid), OP = pad16(dout);
  const int LD = DP + 4, LH = HP + 4, LO = OP + 4;
  float* sw1 = smem;                 // W1[k][j]
  float* sw2 = sw1 + DP * LH;        // W2[j][o]
  float* sb1 = sw2 + HP * LO;
  float* sb2 = sb1 + HP;
  float* sz0 = sb2 + OP;             // z0 = h + A h
  float* sz1 = sz0 + MT * LD;        // relu(z0 W1 + b1)
  const int lane = threadIdx.x & 31;
  const int fg = lane >> 2, ft = lane & 3;   // fragment row / column group

  // zeros in the padding (the copies never write there, and the first
  // product fills z1 whole), then the weights, while the gather runs
  zero_pad(sw1, din, hid, DP, HP, LH);
  zero_pad(sw2, hid, dout, HP, OP, LO);
  zero_pad(sb1, 1, hid, 1, HP, HP);
  zero_pad(sb2, 1, dout, 1, OP, OP);
  zero_pad(sz0, MT, din, MT, DP, LD);
  stage_async<true>(sw1, LH, w1, din, hid);
  stage_async<true>(sw2, LO, w2, hid, dout);
  stage_async<true>(sb1, HP, b1, 1, hid);
  stage_async<true>(sb2, OP, b2, 1, dout);
  asm volatile("cp.async.commit_group;");
  const long long row0 = (long long)blockIdx.x * MT;
  gather_z0<VEC, MT, 2>(blocks, col_off, W, h, n, din, row0, lpr, sz0, LD);
  asm volatile("cp.async.wait_all;");
  __syncthreads();

  // relu(z1) = relu(z0 W1 + b1)
  const WarpTiles t1 = warp_tiles(MT, HP), t2 = warp_tiles(MT, OP);
  {
    float c[NT][4];
    bias_frags<NT>(c, sb1, t1);
    mma_3xtf32<NT>(c, [=](int m, int k) { return sz0[m * LD + k]; },
                   [=](int k, int j) { return sw1[k * LH + j]; }, t1.m0,
                   t1.n0, t1.step, t1.cnt, DP);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (i < t1.cnt) {
        float* z = sz1 + (t1.m0 + fg) * LH + t1.n0 + i * t1.step + 2 * ft;
        z[0] = fmaxf(c[i][0], 0.f); z[1] = fmaxf(c[i][1], 0.f);
        z[8 * LH] = fmaxf(c[i][2], 0.f); z[8 * LH + 1] = fmaxf(c[i][3], 0.f);
      }
    }
  }
  __syncthreads();

  // out = relu(z1) W2 + b2, straight to global memory
  float c[NT][4];
  bias_frags<NT>(c, sb2, t2);
  mma_3xtf32<NT>(c, [=](int m, int k) { return sz1[m * LH + k]; },
                 [=](int k, int o) { return sw2[k * LO + o]; }, t2.m0, t2.n0,
                 t2.step, t2.cnt, HP);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = t2.n0 + i * t2.step + 2 * ft;
    float* o = out + (row0 + t2.m0 + fg) * dout + col;
    if (i < t2.cnt && col < dout) { o[0] = c[i][0]; o[8 * dout] = c[i][2]; }
    if (i < t2.cnt && col + 1 < dout) {
      o[1] = c[i][1]; o[8 * dout + 1] = c[i][3];
    }
  }
}

// Raise a kernel's dynamic shared-memory cap when a launch needs more than
// it was last given: once per size in practice, so a launch inside CUDA
// graph capture makes no attribute call.
int set_smem(const void* kernel, size_t bytes, size_t* granted) {
  if (bytes <= *granted) return 0;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (!err) *granted = bytes;
  return err;
}

// Lanes a row's group takes: enough to cover d columns in VEC-wide pieces,
// rounded up to a power of two, at most a warp.
int lanes_per_row(int d, int vec) {
  int need = (d + vec - 1) / vec, lpr = 1;
  while (lpr < need && lpr < 32) lpr *= 2;
  return lpr;
}

// The instantiation of a GIN kernel for these widths and its shared memory.
struct GinPlan {
  const void* kernel;
  size_t* granted;
  int mt, vec;
  size_t smem;
};

template <int VEC, int MT, int MAXFR>
GinPlan bwd_plan(int din, int hid, int dout) {
  static size_t granted = 0;
  return {(const void*)gin_fused_bwd_kernel<VEC, MT, MAXFR>, &granted, MT,
          VEC, sizeof(float) * (size_t)bwd_smem_floats(MT, din, hid, dout)};
}

GinPlan plan_bwd(int din, int hid, int dout) {
  const bool narrow = din <= 64 && hid <= 64 && dout <= 64;
  if (din % 16 == 0)
    return narrow ? bwd_plan<16, 64, 4>(din, hid, dout)
                  : bwd_plan<16, 32, 16>(din, hid, dout);
  return narrow ? bwd_plan<1, 64, 4>(din, hid, dout)
                : bwd_plan<1, 32, 16>(din, hid, dout);
}

template <int VEC, int MT, int NT>
GinPlan fwd_plan(int din, int hid, int dout) {
  static size_t granted = 0;
  return {(const void*)gin_fused_fwd_kernel<VEC, MT, NT>, &granted, MT, VEC,
          sizeof(float) * (size_t)fwd_smem_floats(MT, din, hid, dout)};
}

// Row tiles of 32: a warp takes at most two (widths up to 64) or four
// (up to 128) output tiles of each product.
GinPlan plan_fwd(int din, int hid, int dout) {
  const bool narrow = din <= 64 && hid <= 64 && dout <= 64;
  if (din % 16 == 0)
    return narrow ? fwd_plan<16, 32, 2>(din, hid, dout)
                  : fwd_plan<16, 32, 4>(din, hid, dout);
  return narrow ? fwd_plan<1, 32, 2>(din, hid, dout)
                : fwd_plan<1, 32, 4>(din, hid, dout);
}

// gin_fused_bwd's grid: the blocks that fit on the card at once, at most
// one per tile.
int bwd_grid(const GinPlan& p, long long n, int* grid) {
  int err = set_smem(p.kernel, p.smem, p.granted);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, p.kernel, GIN_THREADS, p.smem)))
    return err;
  long long tiles = n / p.mt, cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(tiles < cap ? tiles : cap);
  return 0;
}

}  // namespace

extern "C" {

// out[T*128, d] = A x (+ x when add_self; then x has T*128 rows too).
// blocks and x 16-byte aligned (the wrapper checks).
int scgib_banded_spmm(const void* blocks, const void* col_off, int n_tiles,
                      int W, const void* x, long long nx, int d, void* out,
                      int add_self, void* stream) {
  const int vec = d % 4 == 0 ? 4 : 1;
  const int lpr = lanes_per_row(d, vec);
  const long long rows = (long long)n_tiles * TILE;
  const long long per_block = (SPMM_THREADS / 32) * (32 / lpr);
  const unsigned grid = (unsigned)((rows + per_block - 1) / per_block);
  auto* k = vec == 4 ? banded_spmm_kernel<4> : banded_spmm_kernel<1>;
  k<<<grid, SPMM_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)blocks, (const long long*)col_off, W,
      (const float*)x, nx, d, (float*)out, rows, add_self, lpr);
  return (int)cudaGetLastError();
}

// h and blocks 16-byte aligned (the wrapper checks).
int scgib_gin_fused_fwd(const void* blocks, const void* col_off, int n_tiles,
                        int W, const void* h, long long n, int din,
                        const void* w1, const void* b1, int hid,
                        const void* w2, const void* b2, int dout, void* out,
                        void* stream) {
  const GinPlan p = plan_fwd(din, hid, dout);
  int err = set_smem(p.kernel, p.smem, p.granted);
  if (err) return err;
  const int lpr = lanes_per_row(din, p.vec);
  void* args[] = {(void*)&blocks, (void*)&col_off, (void*)&W, (void*)&h,
                  (void*)&n, (void*)&din, (void*)&w1, (void*)&b1,
                  (void*)&hid, (void*)&w2, (void*)&b2, (void*)&dout,
                  (void*)&out, (void*)&lpr};
  err = (int)cudaLaunchKernel(p.kernel, dim3(n_tiles * (TILE / p.mt)),
                              dim3(GIN_THREADS), args, p.smem,
                              (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}

// Blocks gin_fused_bwd launches for n rows at these widths: the number of
// partials the caller allocates, din * hid + hid + hid * dout + dout floats
// each.  Returns a CUDA error, or 0.
int scgib_gin_fused_bwd_grid(long long n, int din, int hid, int dout,
                             int* grid) {
  return bwd_grid(plan_bwd(din, hid, dout), n, grid);
}

// h and blocks 16-byte aligned (the wrapper checks);
// `grid` from scgib_gin_fused_bwd_grid.
int scgib_gin_fused_bwd(const void* blocks, const void* col_off, int W,
                        const void* h, long long n, int din, const void* g,
                        const void* w1, const void* b1, int hid,
                        const void* w2, int dout, void* gz0, void* part,
                        int grid, void* stream) {
  const GinPlan p = plan_bwd(din, hid, dout);
  int err = set_smem(p.kernel, p.smem, p.granted);
  if (err) return err;
  const int lpr = lanes_per_row(din, p.vec);
  void* args[] = {(void*)&blocks, (void*)&col_off, (void*)&W, (void*)&h,
                  (void*)&n, (void*)&din, (void*)&g, (void*)&w1, (void*)&b1,
                  (void*)&hid, (void*)&w2, (void*)&dout, (void*)&gz0,
                  (void*)&part, (void*)&lpr};
  err = (int)cudaLaunchKernel(p.kernel, dim3(grid), dim3(GIN_THREADS), args,
                              p.smem, (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}

// For the report: registers a thread, shared memory a block (static +
// dynamic) and blocks an SM of the kernel a call at these widths launches;
// which = 0 banded_spmm (width din), 1 gin_fused_bwd, 2 gin_fused_fwd.
int scgib_kernel_info(int which, int din, int hid, int dout, int* info) {
  const void* kernel;
  size_t dyn = 0;
  int threads, err;
  if (which == 0) {
    kernel = din % 4 == 0 ? (const void*)banded_spmm_kernel<4>
                          : (const void*)banded_spmm_kernel<1>;
    threads = SPMM_THREADS;
  } else {
    const GinPlan p = which == 1 ? plan_bwd(din, hid, dout)
                                 : plan_fwd(din, hid, dout);
    if ((err = set_smem(p.kernel, p.smem, p.granted))) return err;
    kernel = p.kernel;
    dyn = p.smem;
    threads = GIN_THREADS;
  }
  cudaFuncAttributes attr;
  if ((err = (int)cudaFuncGetAttributes(&attr, kernel))) return err;
  int per_sm = 0;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, dyn)))
    return err;
  info[0] = attr.numRegs;
  info[1] = (int)(attr.sharedSizeBytes + dyn);
  info[2] = per_sm;
  return 0;
}

}  // extern "C"
