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
//                  partial of dW1, db1, dW2, db2 per block; the next row
//                  tile's gather runs under this tile's products.
//                  Replaces _bwd_kernel (#2).
//   blocks_zero,   the 0/1 blocks themselves, from index arrays: a band's
//   blocks_scatter from COO edges (models/scgib.py::_resolve_band), the
//                  pooling's from the clipped centre ids
//                  (ops/pool.py::pool_blocks).  Replaces no Pallas kernel:
//                  the JAX package builds them with XLA scatters
//                  (build_blocks_jax, and the pool's .at[].add).
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
// gin_fused_fwd's bf16 mode (the JAX package's compute_dtype="bfloat16",
// which its GIN casts h, W1 and W2 to) reads h, W1 and W2 in bf16 (half of
// h's bytes), sums A h over the bf16 rows in fp32 (the 0/1 entries times
// bf16 values are exact), rounds z0 and relu(z1) to bf16, and runs each
// product as one m16n8k16 bf16 mma.sync (fp32 accumulate) in place of the
// three TF32 ones; the biases are added in fp32 after the products and the
// output is fp32, JAX's _kernel rounding point for rounding point.  Its
// kernel, gin_fused_fwd_bf16_kernel, keeps the operands in bf16 in shared
// memory (28 KB a block at width 64, against 52.7 KB of floats for the
// float32 kernel): W1 and W2 are copied as bf16 with 16-byte cp.async
// before the gather starts, the gather stores z0 rounded once and the first
// product's epilogue relu(z1) rounded once, and the products read their
// fragments with ldmatrix, converting nothing; the gather takes 8 lanes a
// row at width 64 (one 16-byte load of a row of h a lane), so all 8 warps
// gather the tile's 32 rows in one pass.  The padded widths (9 features run
// as 16) are zeros in shared memory.
// The backward is gin_fused_bwd and banded_spmm on the bf16-rounded h, W1
// and W2 in fp32, as JAX's _bwd runs its fp32 kernels.
//
// gin_fused_bwd is persistent: one block per SM stages W1, W2 and b1 once,
// walks its row tiles (blockIdx.x, then every gridDim.x-th) and keeps dW1
// and dW2 in registers across them, so the grid writes one small partial
// per block that the caller sums in a fixed order.  Its five products are
// z1, g W2^T, gz0, dW2 and dW1.  What bounds it on the card is latency more
// than the tensor cores: a tile is the g copy and the gather's round trips
// (latency-bound), then five dependent products.  Walked in series by 8
// warps, a tile paid both one after the other (S = 403,712 rows at W = 384,
// d 64: ~48 tiles a block, 0.65 ms); more blocks an SM, to hide one with
// another, cap registers at 128 and spill (measured slower).  So a block
// is a pipeline of two warp roles over a ring of two stages of z0 and g in
// shared memory.  8 producer warps (setmaxnreg: 88 registers) copy tile
// k's rows of g by cp.async and gather its z0 into stage k % 2, then
// arrive on the stage's named barrier; 8 consumer warps (168 registers)
// run the products of tile k - 1 from the other stage, sync among
// themselves on a barrier of their own, and free a stage for tile k + 2 on
// a third; no __syncthreads past the prologue.  Every warp gathers tile 0,
// as the serial kernel did, so a block with one tile runs in series; from
// its second tile on, each tile's gather runs under the products of the
// tile before (0.47 ms at that shape).  The gather and the products are
// the serial kernel's code on the same rows and fragments, so the sums,
// their order and the bits are too.  Eight producer warps gather a 64-row
// tile at width 64 in one pass (4 lanes a row); four, in two passes,
// measured 20% slower there, and 80 registers in place of 88 slower at
// width 32.  Width rule (plan_bwd): two stages at every width; row tiles of
// 64 where every width is at most 64 (139,520 bytes of shared memory at
// 64), of 16 above, where two stages of 32 rows and the float weights
// would need 237 KB at 128.
//
// scgib_blocks writes the [T, tile, W] bf16 counts of n items in two
// passes: blocks_zero stores zeros over the whole output in 16-byte
// vectors, then blocks_scatter takes one item a thread, finds its slot and
// adds 1 with a bf16 atomicAdd (a band may repeat an edge, so counts add;
// integer counts up to 256 are exact in bf16 in any order, so the blocks
// are bit-equal to a float32 scatter cast once).  It is bound by the bytes
// it writes: at Peptides-func's shapes 273 M entries, 547 MB, 0.16 ms at
// 3.35 TB/s, against ~1.6 M items scattered.  The route it replaces zeroed
// a float32 buffer twice that size, scattered ones into it and cast it
// (five or more kernels, ~7x the bound).  The two passes are what keep it
// correct for any item order: the packers emit edges sorted by receiver
// and ego-net rows by centre (data/flat.py, graph/batching.py), but a
// build that relied on that (a tile's slab built in shared memory and
// stored once) would need the sorting checked, and the pooling's slab of
// 128 x 4864 entries (1.2 MB at Peptides-func's window) fits no block.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (ops/kernels/banded.py).  Every entry launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gate_walk.cuh"

namespace {

constexpr int TILE = 128;         // rows of one banded block

using gate_walk::FULL;
using gate_walk::SEGV;
constexpr int SPMM_THREADS = 128;
constexpr int GIN_THREADS = 256;  // 8 warps: the gin_fused_fwd kernels

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

// VEC consecutive bf16 values as floats, as 16-byte vectors of 8 when VEC is
// a multiple of 8 (p then 16-byte aligned).
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float v[VEC]) {
  if constexpr (VEC % 8 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + j);
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(b[i]);
        v[j + 2 * i] = f.x; v[j + 2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __bfloat162float(p[j]);
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
//   acc[s VEC + j] += sum_k A[row][k] * xw[k * ld + c + s lpr VEC + j],
// j < VEC, s < SPREAD (SPREAD pieces of VEC columns a lane, lpr VEC apart),
// over the band k < W, where rows k >= rows_left (windows running past the
// end of x) read as 0, with GATHER rows of x in flight.  `active` is false
// for a group without a row; `col_ok` false for a lane past the last
// column, and piece s > 0 is read where its columns lie before ld.  x is
// float, or bf16 (gin_fused_fwd's bf16 mode), summed in fp32.
template <int VEC, int GATHER, typename T, int SPREAD = 1>
__device__ void band_row(const __nv_bfloat16* __restrict__ arow, bool active,
                         int W, const T* __restrict__ xw,
                         long long rows_left, int ld, int c, bool col_ok,
                         int lpr, float acc[VEC * SPREAD]) {
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
      float a[GATHER], xv[GATHER][VEC * SPREAD];
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        a[u] = 0.f;
#pragma unroll
        for (int j = 0; j < VEC * SPREAD; ++j) xv[u][j] = 0.f;
        if (col[u] >= 0 && col[u] < rows_left) {
          a[u] = __bfloat162float(arow[col[u]]);
#pragma unroll
          for (int s = 0; s < SPREAD; ++s)
            if (col_ok && (s == 0 || c + s * lpr * VEC < ld))
              load_vec<VEC>(xw + (long long)col[u] * ld + c + s * lpr * VEC,
                            xv[u] + s * VEC);
        }
      }
#pragma unroll
      for (int u = 0; u < GATHER; ++u)
#pragma unroll
        for (int j = 0; j < VEC * SPREAD; ++j)
          acc[j] = fmaf(a[u], xv[u][j], acc[j]);
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

// --- the blocks themselves (scgib_blocks) -----------------------------------

constexpr int BUILD_THREADS = 256;
constexpr int ZERO_VECS = 4;      // 16-byte stores a thread of the zero pass

// out[0 : total] = 0 in 16-byte stores (out 16-byte aligned); the first
// block also writes the total % 8 entries past the last whole vector.
__global__ void __launch_bounds__(BUILD_THREADS)
blocks_zero_kernel(__nv_bfloat16* __restrict__ out, long long total) {
  const long long nvec = total / 8;
  uint4* v = reinterpret_cast<uint4*>(out);
  const long long base =
      (long long)blockIdx.x * BUILD_THREADS * ZERO_VECS + threadIdx.x;
#pragma unroll
  for (int j = 0; j < ZERO_VECS; ++j) {
    const long long i = base + (long long)j * BUILD_THREADS;
    if (i < nvec) v[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (blockIdx.x == 0 && threadIdx.x < total % 8)
    out[nvec * 8 + threadIdx.x] = __float2bfloat16(0.f);
}

// One thread an item i: row r = rows[i], source c = src[i] (i itself where
// src is null), tile t = r / tile; adds 1 at [t, r - t tile, c - off[t]]
// where mask[i] (or no mask), 0 <= r, t < T and 0 <= c - off[t] < W, and
// drops the item otherwise.
__global__ void __launch_bounds__(BUILD_THREADS)
blocks_scatter_kernel(const long long* __restrict__ rows,
                      const long long* __restrict__ src,
                      const unsigned char* __restrict__ mask,
                      const long long* __restrict__ off, long long n, int T,
                      int tile, int W, __nv_bfloat16* __restrict__ out) {
  const long long i = (long long)blockIdx.x * BUILD_THREADS + threadIdx.x;
  if (i >= n || (mask != nullptr && !mask[i])) return;
  const long long r = rows[i];
  const long long t = r / tile;
  if (r < 0 || t >= T) return;
  const long long col = (src != nullptr ? src[i] : i) - off[t];
  if (col < 0 || col >= W) return;
  atomicAdd(out + r * W + col, __float2bfloat16(1.f));
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

// --- bf16 tensor-core products (gin_fused_fwd's bf16 mode) ------------------

// Two floats rounded to bf16 (round to nearest even, as JAX's astype), lo in
// the low half: one register of an mma.sync bf16 fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 16 x 8 output tiles of an [M, N] product that this warp of 8 takes:
// row tile m0 = 16 (warp % (M/16)), column tiles n0 + i step for i < cnt.
// M / 16 divides 8.
struct WarpTiles {
  int m0, n0, step, cnt;
};

__device__ __forceinline__ WarpTiles warp_tiles(int M, int N, int warp) {
  const int nm = M / 16, wpm = 8 / nm;
  const int first = warp / nm, nn = N / 8;
  // a warp without a tile reads tile 0, in bounds, and stores nothing
  return {(warp % nm) * 16, first < nn ? first * 8 : 0, wpm * 8,
          first < nn ? (nn - first + wpm - 1) / wpm : 0};
}

__device__ __forceinline__ WarpTiles warp_tiles(int M, int N) {
  return warp_tiles(M, N, threadIdx.x >> 5);
}

__host__ __device__ constexpr int pad16(int v) { return (v + 15) & ~15; }

// The row dimensions of the weight-gradient products are padded to 16,
// 32, 64 or 128, so that their row tiles divide the 8 warps.
__host__ __device__ constexpr int pad_pow2(int v) {
  return v <= 16 ? 16 : v <= 32 ? 32 : v <= 64 ? 64 : 128;
}

// gin_fused_bwd's warp roles (the source note says why): two warpgroups of
// producers gather the block's next row tile into one of two stages of a
// ring in shared memory while two warpgroups of consumers run the products
// of the tile before from the other.  setmaxnreg moves registers from the
// producers, whose gather needs few, to the consumers, which keep the
// weight-gradient fragments across tiles.
constexpr int BWD_PRODUCERS = 8;        // warps: a 64-row tile a pass at 64
constexpr int BWD_CONSUMERS = 8;        // warps: the products' split
constexpr int BWD_THREADS = 32 * (BWD_PRODUCERS + BWD_CONSUMERS);
constexpr int BWD_PRODUCER_REGS = 88;
constexpr int BWD_CONSUMER_REGS = 168;
static_assert(32 * (BWD_PRODUCERS * BWD_PRODUCER_REGS
                    + BWD_CONSUMERS * BWD_CONSUMER_REGS)
                  <= 65536 / BWD_THREADS / 8 * 8 * BWD_THREADS,
              "the roles' registers exceed the block's at launch");
static_assert(BWD_CONSUMERS == 8, "warp_tiles splits a product over 8");

// gin_fused_bwd's named barriers (0 is __syncthreads'): BAR_FULL + s, stage
// s holds a tile (producers arrive, consumers wait); BAR_EMPTY + s, stage s
// is free again (consumers arrive, producers wait); BAR_PRODUCTS, the
// consumers among themselves.
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PRODUCTS = 5;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory floats of gin_fused_bwd: W1 [DP][HP+4], W2 [HP][OP+4],
// b1 [HP], two stages of z0 [MT][DP+4] and g [MT][OP+4], and z1 and gz1
// [MT][HP+4], with DP = pad_pow2(din), HP = pad_pow2(hid), OP = pad16(dout)
// and the padding zero.  Rows are padded by 4 floats so the fragment reads
// of a warp spread over the banks.
__host__ __device__ constexpr int bwd_smem_floats(int mt, int din, int hid,
                                                  int dout) {
  return pad_pow2(din) * (pad_pow2(hid) + 4)
         + pad_pow2(hid) * (pad16(dout) + 4) + pad_pow2(hid)
         + mt * (2 * (pad_pow2(din) + 4) + 2 * (pad16(dout) + 4)
                 + 2 * (pad_pow2(hid) + 4));
}

// Zero the entries of a shared [RP, CP] array (row stride ld) outside its
// [R, C] corner, by the block's first THREADS threads.
template <int THREADS = GIN_THREADS>
__device__ void zero_pad(float* a, int R, int C, int RP, int CP, int ld) {
  if (R == RP && C == CP) return;
  for (int e = threadIdx.x; e < RP * CP; e += THREADS) {
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
// THREADS: the block's first THREADS threads copy.
template <bool CACHE_L1 = false, int THREADS = GIN_THREADS>
__device__ void stage_async(float* dst, int ld, const float* src, int R,
                            int C) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  if (C % 4 == 0 && ((uintptr_t)src & 15) == 0) {
    const int cv = C / 4;
    for (int e = threadIdx.x; e < R * cv; e += THREADS) {
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
    for (int e = threadIdx.x; e < R * C; e += THREADS) {
      const int r = e / C, c = e % C;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       base + 4u * (r * ld + c)),
                   "l"(src + e));
    }
  }
}

// VEC columns of z0 into shared memory: as they are (fp32), or rounded to
// bf16 once (gin_fused_fwd_bf16), as 16-byte vectors of 8 when VEC allows.
template <int VEC>
__device__ __forceinline__ void store_z0(float* p, const float v[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) p[j] = v[j];
}

template <int VEC>
__device__ __forceinline__ void store_z0(__nv_bfloat16* p,
                                         const float v[VEC]) {
  if constexpr (VEC % 8 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 8)
      *reinterpret_cast<uint4*>(p + j) = make_uint4(
          pack_bf16(v[j], v[j + 1]), pack_bf16(v[j + 2], v[j + 3]),
          pack_bf16(v[j + 4], v[j + 5]), pack_bf16(v[j + 6], v[j + 7]));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = __float2bfloat16_rn(v[j]);
  }
}

// z0 = h + A h for the MT rows from row0 (inside one band tile: MT divides
// 128) into shared memory, row stride ld, by the block's first WARPS warps:
// a lane group of lpr lanes a row, SPREAD pieces of VEC columns a lane
// (band_row), GATHER rows of h in flight.  h is float or bf16, summed in
// fp32; z0 is stored fp32, or bf16 (store_z0).
template <int VEC, int MT, int GATHER, typename T, typename Z,
          int SPREAD = 1, int WARPS = GIN_THREADS / 32>
__device__ __forceinline__ void gather_z0(
    const __nv_bfloat16* __restrict__ blocks,
    const long long* __restrict__ col_off, int W, const T* __restrict__ h,
    long long n, int din, long long row0, int lpr, Z* sz0, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / lpr;                  // rows a warp gathers at once
  const long long off = col_off[row0 / TILE];
  for (int r1 = 0; r1 < MT; r1 += WARPS * rpw) {
    const int r = r1 + warp * rpw + lane / lpr;
    const bool active = r < MT;
    const long long row = row0 + (active ? r : 0);
    for (int c0 = 0; c0 < din; c0 += lpr * VEC * SPREAD) {
      const int c = c0 + (lane % lpr) * VEC;
      const bool col_ok = active && c < din;
      float acc[VEC * SPREAD];
#pragma unroll
      for (int j = 0; j < VEC * SPREAD; ++j) acc[j] = 0.f;
#pragma unroll
      for (int s = 0; s < SPREAD; ++s)
        if (col_ok && (s == 0 || c + s * lpr * VEC < din))
          load_vec<VEC>(h + row * din + c + s * lpr * VEC, acc + s * VEC);
      band_row<VEC, GATHER, T, SPREAD>(blocks + row * W, active, W,
                                       h + off * din, n - off, din, c,
                                       col_ok, lpr, acc);
#pragma unroll
      for (int s = 0; s < SPREAD; ++s)
        if (col_ok && (s == 0 || c + s * lpr * VEC < din))
          store_z0<VEC>(sz0 + r * ld + c + s * lpr * VEC, acc + s * VEC);
    }
  }
}

// Persistent: each block takes the row tiles blockIdx.x + k gridDim.x of
// MT rows, k = 0, 1, ..., tile k in stage k % 2 of the ring.  Every warp
// gathers tile 0, as a kernel without the ring would (a block with one
// tile runs in series); then the producers gather tiles 1, 2, ... while
// the consumers run the products of the tile before, so from tile 1 on a
// tile's gather runs under the products of the one before.  MAXFR bounds
// the dW1 / dW2 fragments a consumer warp keeps in registers (4 up to
// widths 64, 16 up to 128).  part[block] = [dW1 (din x hid) | db1 |
// dW2 (hid x dout) | db2].
template <int VEC, int MT, int MAXFR>
__global__ void __launch_bounds__(BWD_THREADS, 1)
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
  float* sz0 = sb1 + HP;             // z0 = h + A h, stages 0 and 1
  float* sg = sz0 + 2 * MT * LD;     // the tile's rows of g, stages 0 and 1
  float* sz1 = sg + 2 * MT * LO;     // pre-activation z1
  float* sgz1 = sz1 + MT * LH;       // (g W2^T) * [z1 > 0]
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long tiles = n / MT;    // the grid has at most a block a tile

  // every warp: zeros in the padding of the staged operands, once (the
  // copies never write there, and the products fill z1 and gz1 whole), the
  // weights, and tile 0 into stage 0
  zero_pad<BWD_THREADS>(sw1, din, hid, DP, HP, LH);
  zero_pad<BWD_THREADS>(sw2, hid, dout, HP, OP, LO);
  zero_pad<BWD_THREADS>(sb1, 1, hid, 1, HP, HP);
  zero_pad<BWD_THREADS>(sz0, 2 * MT, din, 2 * MT, DP, LD);
  zero_pad<BWD_THREADS>(sg, 2 * MT, dout, 2 * MT, OP, LO);
  stage_async<false, BWD_THREADS>(sw1, LH, w1, din, hid);
  stage_async<false, BWD_THREADS>(sw2, LO, w2, hid, dout);
  stage_async<false, BWD_THREADS>(sb1, HP, b1, 1, hid);
  stage_async<false, BWD_THREADS>(
      sg, LO, g + (long long)blockIdx.x * MT * dout, MT, dout);
  asm volatile("cp.async.commit_group;");
  gather_z0<VEC, MT, 2, float, float, 1, BWD_THREADS / 32>(
      blocks, col_off, W, h, n, din, (long long)blockIdx.x * MT, lpr, sz0,
      LD);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  if (warp < BWD_PRODUCERS) {
    // producers: tile k into stage k % 2 once tile k - 2 has left it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        BWD_PRODUCER_REGS));
    int kt = 1;
    for (long long tile = blockIdx.x + (long long)gridDim.x; tile < tiles;
         tile += gridDim.x, ++kt) {
      const int s = kt & 1;
      if (kt >= 2) bar_sync(BAR_EMPTY + s, BWD_THREADS);
      const long long row0 = tile * MT;
      stage_async<false, 32 * BWD_PRODUCERS>(sg + s * MT * LO, LO,
                                             g + row0 * dout, MT, dout);
      asm volatile("cp.async.commit_group;");
      gather_z0<VEC, MT, 2, float, float, 1, BWD_PRODUCERS>(
          blocks, col_off, W, h, n, din, row0, lpr, sz0 + s * MT * LD, LD);
      asm volatile("cp.async.wait_all;" ::: "memory");
      bar_arrive(BAR_FULL + s, BWD_THREADS);
    }
    return;
  }

  // consumers: the products of tile k from stage k % 2
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
      BWD_CONSUMER_REGS));
  constexpr int CONSUMER_THREADS = 32 * BWD_CONSUMERS;
  const int cw = warp - BWD_PRODUCERS, ct = tid - 32 * BWD_PRODUCERS;
  const int fg = (tid & 31) >> 2, ft = tid & 3;  // fragment row / col group
  float dw1[MAXFR][4], dw2[MAXFR][4];
#pragma unroll
  for (int i = 0; i < MAXFR; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) dw1[i][q] = dw2[i][q] = 0.f;
  float db = 0.f;   // ct < 128: db1[ct]; the others db2[ct - 128]
  const WarpTiles t1 = warp_tiles(DP, HP, cw), t2 = warp_tiles(HP, OP, cw);
  const WarpTiles tz = warp_tiles(MT, HP, cw), t0 = warp_tiles(MT, DP, cw);

  int kt = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++kt) {
    const int s = kt & 1;
    if (kt >= 1) bar_sync(BAR_FULL + s, BWD_THREADS);
    const long long row0 = tile * MT;
    const float* z0 = sz0 + s * MT * LD;
    const float* gt = sg + s * MT * LO;

    // z1 = z0 W1 + b1
    {
      float c[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = tz.n0 + i * tz.step + 2 * ft;
        c[i][0] = c[i][2] = sb1[j];
        c[i][1] = c[i][3] = sb1[j + 1];
      }
      mma_3xtf32<4>(c, [=](int m, int k) { return z0[m * LD + k]; },
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
    bar_sync(BAR_PRODUCTS, CONSUMER_THREADS);

    // gz1 = (g W2^T) * [z1 > 0]
    {
      float c[4][4] = {};
      mma_3xtf32<4>(c, [=](int m, int k) { return gt[m * LO + k]; },
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
    bar_sync(BAR_PRODUCTS, CONSUMER_THREADS);

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
                      [=](int r, int o) { return gt[r * LO + o]; }, t2.m0,
                      t2.n0, t2.step, t2.cnt, MT);
    mma_3xtf32<MAXFR>(dw1, [=](int k, int r) { return z0[r * LD + k]; },
                      [=](int r, int j) { return sgz1[r * LH + j]; }, t1.m0,
                      t1.n0, t1.step, t1.cnt, MT);
    if (ct < hid) {
      db += column_sum<MT>(sgz1 + ct, LH);
    } else if (ct >= 128 && ct - 128 < dout) {
      db += column_sum<MT>(gt + ct - 128, LO);
    }
    // stage s is free for tile k + 2, where the block has one
    if (tile + 2LL * gridDim.x < tiles)
      bar_arrive(BAR_EMPTY + s, BWD_THREADS);
    bar_sync(BAR_PRODUCTS, CONSUMER_THREADS);   // the next tile's z1, gz1
  }

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
  if (ct < hid) pb1[ct] = db;
  else if (ct >= 128 && ct - 128 < dout) pb2[ct - 128] = db;
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

// --- gin_fused_fwd_bf16: the bf16 mode on bf16 shared memory ----------------

// Rows of gin_fused_fwd_bf16's shared arrays are padded by 8 bf16 values (16
// bytes): at a row stride of 2 P + 16 bytes (P a multiple of 16) the 8 rows
// an ldmatrix reads fall on 8 different 16-byte bank groups.
constexpr int BF16_PAD = 8;

// Pieces of VEC columns a lane gathers in gin_fused_fwd_bf16 (band_row's
// SPREAD): two where VEC is 1, so that 9 features take a group of 8 lanes a
// row and a warp gathers 4 rows at once, as at width 64.
template <int VEC>
constexpr int bf16_spread = VEC == 1 ? 2 : 1;

// Bytes of gin_fused_fwd_bf16's shared memory: b1 [HP] and b2 [OP] in fp32,
// then in bf16 W1 [DP][HP+8], W2 [HP][OP+8], and per tile z0 [MT][DP+8] and
// relu(z1) [MT][HP+8], with DP, HP, OP the widths padded to 16 (zeros there).
__host__ __device__ constexpr int fwd_bf16_smem_bytes(int mt, int din,
                                                      int hid, int dout) {
  return 4 * (pad16(hid) + pad16(dout))
         + 2 * (pad16(din) * (pad16(hid) + BF16_PAD)
                + pad16(hid) * (pad16(dout) + BF16_PAD)
                + mt * (pad16(din) + pad16(hid) + 2 * BF16_PAD));
}

// zero_pad of a bf16 array: a warp a row, a lane a column.
__device__ void zero_pad(__nv_bfloat16* a, int R, int C, int RP, int CP,
                         int ld) {
  if (R == RP && C == CP) return;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < RP; r += GIN_THREADS / 32)
    for (int c = (r < R ? C : 0) + lane; c < CP; c += 32)
      a[r * ld + c] = __float2bfloat16_rn(0.f);
}

// Copy a row-major [R, C] bf16 matrix into shared memory with row stride ld
// (values; dst 16-byte aligned, ld a multiple of 8) asynchronously,
// allocating in L1 as stage_async<true> does: 16-byte copies of 8 values
// where the rows allow it, else 4-byte copies of 2, else (an odd C) plain
// loads and stores.  A thread's row and piece advance without a division.
// The caller commits and waits.
__device__ void stage_bf16_async(__nv_bfloat16* dst, int ld,
                                 const __nv_bfloat16* src, int R, int C) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  const int step = C % 8 == 0 && ((uintptr_t)src & 15) == 0  ? 8
                   : C % 2 == 0 && ((uintptr_t)src & 3) == 0 ? 2
                                                              : 1;
  const int cv = C / step, dr = GIN_THREADS / cv, dc = GIN_THREADS % cv;
  int r = threadIdx.x / cv, q = threadIdx.x % cv;   // row, piece
  while (r < R) {
    const int c = q * step;
    const uint32_t to = base + 2u * (r * ld + c);
    const __nv_bfloat16* from = src + (long long)r * C + c;
    if (step == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(to),
                   "l"(from));
    else if (step == 2)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(to),
                   "l"(from));
    else
      dst[r * ld + c] = *from;
    r += dr;
    q += dc;
    if (q >= cv) {
      q -= cv;
      ++r;
    }
  }
}

// Four 8 x 8 bf16 matrices from shared memory (ldmatrix): lane l gives the
// address of row l % 8 of matrix l / 8 and gets, of each, (row l / 4,
// columns 2 (l % 4), + 1), or with TRANS (rows 2 (l % 4), + 1, column l / 4).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4],
                                            const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
}

// The tiles of an [M, N] product (N a multiple of 16) that this warp of 8
// takes in gin_fused_fwd_bf16: row tile m0 = 16 (warp % (M/16)), and the
// pairs of adjacent 8-column tiles first + i step, i < cnt.  M / 16
// divides 8.
struct PairTiles {
  int m0, first, step, cnt;
};

__device__ __forceinline__ PairTiles pair_tiles(int M, int N) {
  const int warp = threadIdx.x >> 5, nm = M / 16, wpm = 8 / nm;
  const int first = warp / nm, np = N / 16;
  // a warp without a pair reads pair 0, in bounds, and stores nothing
  return {(warp % nm) * 16, first < np ? first : 0, wpm,
          first < np ? (np - first + wpm - 1) / wpm : 0};
}

// c[2 i + s] = A[m0:m0+16, 0:K] B[0:K, 16 p + 8 s : + 8] for this warp's
// pairs p = t.first + i t.step (i < t.cnt <= NT / 2), one m16n8k16 bf16
// mma.sync a tile and k-step, fp32 accumulate; A [M][lda] and B [K][ldb]
// are bf16 row-major in shared memory, read by ldmatrix and converted
// nowhere.  Lane l addresses row l % 16 and column 8 (l / 16) of a 16 x 16
// block: of A (x4) its four 8 x 8 quarters in the order of the A fragment's
// registers, of B (x4.trans) the two k-halves of both tiles of a pair.  K is
// a multiple of 16.  A pair past t.cnt repeats pair t.first's reads (no
// branch), and its sums are never stored.
template <int NT>
__device__ __forceinline__ void mma_bf16_ldm(float c[NT][4],
                                             const __nv_bfloat16* A, int lda,
                                             const __nv_bfloat16* B, int ldb,
                                             const PairTiles& t, int K) {
  const int lane = threadIdx.x & 31, lr = lane & 15, lc = (lane >> 4) * 8;
  const __nv_bfloat16* a = A + (t.m0 + lr) * lda + lc;
  const __nv_bfloat16* b[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i)
    b[i] = B + lr * ldb + 16 * (t.first + (i < t.cnt ? i : 0) * t.step) + lc;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldmatrix_x4<false>(af, a + k0);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
      uint32_t bf[4];
      ldmatrix_x4<true>(bf, b[i] + k0 * ldb);
      mma_bf16_16816(c[2 * i], af, bf);
      mma_bf16_16816(c[2 * i + 1], af, bf + 2);
    }
  }
}

// The column of this lane's fragment pair (c[.][0], c[.][1]) in tile s of
// pair i.
__device__ __forceinline__ int pair_col(const PairTiles& t, int i, int s) {
  return 16 * (t.first + i * t.step) + 8 * s + 2 * (threadIdx.x & 3);
}

// gin_fused_fwd's bf16 mode (the JAX package's compute_dtype="bfloat16"),
// designed for its rounding points: one row tile of MT rows a block (MT
// divides 128), NT bounding the 16 x 8 output tiles a warp takes in either
// product.  W1 and W2 are copied as bf16 into shared memory with cp.async
// before the gather starts and arrive while it runs.  The gather sums A h
// over the bf16 rows of h in fp32 and stores z0 = h + A h rounded to bf16
// once; the first product's epilogue adds b1 in fp32 and stores relu(z1)
// rounded to bf16 once (JAX's _kernel rounds both there); the products read
// their bf16 operands with ldmatrix into m16n8k16 bf16 mma.sync, fp32
// accumulate, and b2 is added in fp32 to the fp32 output.
template <int VEC, int MT, int NT>
__global__ void __launch_bounds__(GIN_THREADS, 3)
gin_fused_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ blocks,
                          const long long* __restrict__ col_off, int W,
                          const __nv_bfloat16* __restrict__ h, long long n,
                          int din, const __nv_bfloat16* __restrict__ w1,
                          const float* __restrict__ b1, int hid,
                          const __nv_bfloat16* __restrict__ w2,
                          const float* __restrict__ b2, int dout,
                          float* __restrict__ out, int lpr) {
  extern __shared__ float smem[];
  const int DP = pad16(din), HP = pad16(hid), OP = pad16(dout);
  const int LD = DP + BF16_PAD, LH = HP + BF16_PAD, LO = OP + BF16_PAD;
  float* sb1 = smem;
  float* sb2 = sb1 + HP;
  __nv_bfloat16* sw1 = reinterpret_cast<__nv_bfloat16*>(sb2 + OP);  // W1[k][j]
  __nv_bfloat16* sw2 = sw1 + DP * LH;                               // W2[j][o]
  __nv_bfloat16* sz0 = sw2 + HP * LO;       // bf16(h + A h)
  __nv_bfloat16* sz1 = sz0 + MT * LD;       // bf16(relu(z0 W1 + b1))
  const int fg = (threadIdx.x & 31) >> 2;  // fragment row

  // the weights and biases first, in flight while the padding is zeroed
  // (the copies never write there, and the first product fills z1 whole)
  // and the gather runs
  stage_bf16_async(sw1, LH, w1, din, hid);
  stage_bf16_async(sw2, LO, w2, hid, dout);
  stage_async<true>(sb1, HP, b1, 1, hid);
  stage_async<true>(sb2, OP, b2, 1, dout);
  asm volatile("cp.async.commit_group;");
  zero_pad(sw1, din, hid, DP, HP, LH);
  zero_pad(sw2, hid, dout, HP, OP, LO);
  zero_pad(sb1, 1, hid, 1, HP, HP);
  zero_pad(sb2, 1, dout, 1, OP, OP);
  zero_pad(sz0, MT, din, MT, DP, LD);
  const long long row0 = (long long)blockIdx.x * MT;
  gather_z0<VEC, MT, 2, __nv_bfloat16, __nv_bfloat16, bf16_spread<VEC>>(
      blocks, col_off, W, h, n, din, row0, lpr, sz0, LD);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // relu(z1) = relu(z0 W1 + b1), rounded to bf16
  const PairTiles t1 = pair_tiles(MT, HP), t2 = pair_tiles(MT, OP);
  {
    float c[NT][4] = {};
    mma_bf16_ldm<NT>(c, sz0, LD, sw1, LH, t1, DP);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (i < t1.cnt) {
          const int col = pair_col(t1, i, s);
          const float* f = c[2 * i + s];
          const float2 b = *reinterpret_cast<const float2*>(sb1 + col);
          __nv_bfloat16* z = sz1 + (t1.m0 + fg) * LH + col;
          *reinterpret_cast<uint32_t*>(z) = pack_bf16(
              fmaxf(f[0] + b.x, 0.f), fmaxf(f[1] + b.y, 0.f));
          *reinterpret_cast<uint32_t*>(z + 8 * LH) = pack_bf16(
              fmaxf(f[2] + b.x, 0.f), fmaxf(f[3] + b.y, 0.f));
        }
      }
    }
  }
  __syncthreads();

  // out = relu(z1) W2 + b2, straight to global memory
  float c[NT][4] = {};
  mma_bf16_ldm<NT>(c, sz1, LH, sw2, LO, t2, HP);
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int col = pair_col(t2, i, s);
      if (i < t2.cnt && col < dout) {
        const float* f = c[2 * i + s];
        const float2 b = *reinterpret_cast<const float2*>(sb2 + col);
        float* o = out + (row0 + t2.m0 + fg) * dout + col;
        if (col + 1 < dout && dout % 2 == 0) {   // 8-byte aligned pairs
          *reinterpret_cast<float2*>(o) = make_float2(f[0] + b.x, f[1] + b.y);
          *reinterpret_cast<float2*>(o + 8 * dout) =
              make_float2(f[2] + b.x, f[3] + b.y);
        } else {
          o[0] = f[0] + b.x;
          o[8 * dout] = f[2] + b.x;
          if (col + 1 < dout) {
            o[1] = f[1] + b.y;
            o[8 * dout + 1] = f[3] + b.y;
          }
        }
      }
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
  int mt, vec;     // rows a tile; columns a lane gathers (lanes_per_row)
  size_t smem;
  int threads = GIN_THREADS;
};

template <int VEC, int MT, int MAXFR>
GinPlan bwd_plan(int din, int hid, int dout) {
  static size_t granted = 0;
  return {(const void*)gin_fused_bwd_kernel<VEC, MT, MAXFR>, &granted, MT,
          VEC, sizeof(float) * (size_t)bwd_smem_floats(MT, din, hid, dout),
          BWD_THREADS};
}

// gin_fused_bwd keeps two stages of z0 and g at every width.  Row tiles of
// 64 where every width is at most 64 (139,520 bytes of shared memory at
// 64); of 16 above, where the float weights alone take 135,680 bytes at 128
// and two stages of 32-row tiles would need 237 KB (186,368 bytes at 16).
// ops/kernels/banded.py::bwd_tile_rows mirrors the rule.
GinPlan plan_bwd(int din, int hid, int dout) {
  const bool narrow = din <= 64 && hid <= 64 && dout <= 64;
  if (din % 16 == 0)
    return narrow ? bwd_plan<16, 64, 4>(din, hid, dout)
                  : bwd_plan<16, 16, 16>(din, hid, dout);
  return narrow ? bwd_plan<1, 64, 4>(din, hid, dout)
                : bwd_plan<1, 16, 16>(din, hid, dout);
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

template <int VEC, int MT, int NT>
GinPlan fwd_bf16_plan(int din, int hid, int dout) {
  static size_t granted = 0;
  return {(const void*)gin_fused_fwd_bf16_kernel<VEC, MT, NT>, &granted, MT,
          VEC * bf16_spread<VEC>,
          (size_t)fwd_bf16_smem_bytes(MT, din, hid, dout)};
}

// gin_fused_fwd_bf16: row tiles of 32 as plan_fwd; h gathered 8 values (one
// 16-byte load) a lane where din allows it, so that at width 64 a row takes
// 8 lanes and the 8 warps gather the tile's 32 rows in one pass; else one
// value a lane in two pieces (bf16_spread), 9 features on 8 lanes too.
GinPlan plan_fwd_bf16(int din, int hid, int dout) {
  const bool narrow = din <= 64 && hid <= 64 && dout <= 64;
  if (din % 8 == 0)
    return narrow ? fwd_bf16_plan<8, 32, 2>(din, hid, dout)
                  : fwd_bf16_plan<8, 32, 4>(din, hid, dout);
  return narrow ? fwd_bf16_plan<1, 32, 2>(din, hid, dout)
                : fwd_bf16_plan<1, 32, 4>(din, hid, dout);
}

// Launch gin_fused_fwd (either mode) for these widths.
int launch_fwd(const GinPlan& p, const void* blocks, const void* col_off,
               int n_tiles, int W, const void* h, long long n, int din,
               const void* w1, const void* b1, int hid, const void* w2,
               const void* b2, int dout, void* out, void* stream) {
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
           &per_sm, p.kernel, p.threads, p.smem)))
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

// out[T, tile, W] bf16 = the counts of n items (blocks_scatter_kernel):
// the zero pass, then the scatter.  rows, src and off int64, mask bool; src
// and mask may be null; out 16-byte aligned (a fresh torch allocation).
int scgib_blocks(const void* rows, const void* src, const void* mask,
                 const void* off, long long n, int T, int tile, int W,
                 void* out, void* stream) {
  const long long total = (long long)T * tile * W;
  const long long per_block = (long long)BUILD_THREADS * ZERO_VECS * 8;
  if (total > 0)
    blocks_zero_kernel<<<(unsigned)((total + per_block - 1) / per_block),
                         BUILD_THREADS, 0, (cudaStream_t)stream>>>(
        (__nv_bfloat16*)out, total);
  if (n > 0)
    blocks_scatter_kernel<<<(unsigned)((n + BUILD_THREADS - 1) /
                                       BUILD_THREADS),
                            BUILD_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)rows, (const long long*)src,
        (const unsigned char*)mask, (const long long*)off, n, T, tile, W,
        (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

// h and blocks 16-byte aligned (the wrapper checks).
int scgib_gin_fused_fwd(const void* blocks, const void* col_off, int n_tiles,
                        int W, const void* h, long long n, int din,
                        const void* w1, const void* b1, int hid,
                        const void* w2, const void* b2, int dout, void* out,
                        void* stream) {
  return launch_fwd(plan_fwd(din, hid, dout), blocks, col_off,
                    n_tiles, W, h, n, din, w1, b1, hid, w2, b2, dout, out,
                    stream);
}

// The bf16 mode: h, w1 and w2 bf16, b1, b2 and out float; h and blocks
// 16-byte aligned (the wrapper checks).  gin_fused_fwd_bf16_kernel, on bf16
// shared memory.
int scgib_gin_fused_fwd_bf16(const void* blocks, const void* col_off,
                             int n_tiles, int W, const void* h, long long n,
                             int din, const void* w1, const void* b1,
                             int hid, const void* w2, const void* b2,
                             int dout, void* out, void* stream) {
  return launch_fwd(plan_fwd_bf16(din, hid, dout), blocks, col_off, n_tiles,
                    W, h, n, din, w1, b1, hid, w2, b2, dout, out, stream);
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
  err = (int)cudaLaunchKernel(p.kernel, dim3(grid), dim3(p.threads), args,
                              p.smem, (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}

// For the report: registers a thread, shared memory a block (static +
// dynamic), blocks an SM, threads a block and, for the GIN kernels, rows a
// tile (0 for banded_spmm) of the kernel a call at these widths launches;
// which = 0 banded_spmm (width din), 1 gin_fused_bwd, 2 gin_fused_fwd,
// 3 gin_fused_fwd_bf16.
int scgib_kernel_info(int which, int din, int hid, int dout, int* info) {
  const void* kernel;
  size_t dyn = 0;
  int threads, err, mt = 0;
  if (which == 0) {
    kernel = din % 4 == 0 ? (const void*)banded_spmm_kernel<4>
                          : (const void*)banded_spmm_kernel<1>;
    threads = SPMM_THREADS;
  } else {
    const GinPlan p = which == 1   ? plan_bwd(din, hid, dout)
                      : which == 2 ? plan_fwd(din, hid, dout)
                                   : plan_fwd_bf16(din, hid, dout);
    if ((err = set_smem(p.kernel, p.smem, p.granted))) return err;
    kernel = p.kernel;
    dyn = p.smem;
    threads = p.threads;
    mt = p.mt;
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
  info[3] = threads;
  info[4] = mt;
  return 0;
}

}  // extern "C"
