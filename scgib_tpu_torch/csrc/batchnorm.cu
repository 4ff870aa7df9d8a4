// The GIN layer's tail, masked BatchNorm -> ReLU -> padding rows zeroed, as
// four kernels for Hopper (sm_90a).  They replace no Pallas kernel: on the
// TPU, XLA fused the ~30 tensor expressions of MaskedBatchNorm.forward
// (scgib_tpu/models/layers.py) and the relu and row mask after it
// (models/encoders.py); in the port each expression and its autograd
// backward was a kernel of its own, ~60 a call.
//
//   bn_stats        per column of the rows the mask keeps: S1 = sum x,
//                   S2 = sum x^2, and the count, into totals [S1 | S2 | n]
//                   (float64).
//   bn_apply        count' = max(n, 1), mean = S1 / count',
//                   var = max(S2 / count' - mean^2, 0),
//                   a = scale rsqrt(var + eps), c = bias - mean a,
//                   y = relu(x a + c) m; in eval mode a and c from the
//                   running statistics.  Keeps a, c, mean, rsqrt(var + eps)
//                   and whether the clamp passed for the backward; one
//                   thread a column moves the running statistics
//                   (unbiased variance, momentum) unless they are frozen.
//   bn_grad_stats   with g = dy m [x a + c > 0]: per column sum g and
//                   sum g x, and from them dbias = sum g,
//                   dscale = (sum g x - mean sum g) rsqrt(var + eps), and
//                   the two per-column terms of dx, dS1 and dS2 (0 in eval
//                   mode): the gradient autograd takes through the composed
//                   ops, the clamp's mask included.
//   bn_grad_apply   dx = g a + m (dS1 + 2 x dS2).
//
// x, y, dy and dx are float32 [n, f] rows; the mask one byte a row (null:
// every row kept).  With a sync-BN group the caller all-reduces the totals
// between bn_stats and bn_apply, and dS1 and dS2 between bn_grad_stats and
// bn_grad_apply; dscale and dbias stay the rank's own.
//
// What bounds them on an H100.  At the main path's 9728 x 64 a call moves
// 2.5 MB for each [n, f] tensor it reads or writes: the forward (x read
// twice, y written) 7.5 MB, 2.2 us at 3.35 TB/s; the backward (dy and x
// twice, dx) 12.5 MB, 3.7 us.  x was just written by the conv and sits in
// L2, so latency bounds them more than HBM.  The layout answers that: a
// block is tx x ty threads, tx threads across the columns (4 columns a
// thread in one 16-byte load where f % 4 == 0) and ty down the rows, each
// thread owning the same columns for its whole walk, so its coefficients
// stay in registers and no index is divided.  The two reductions take row
// slices of ~16 rows a thread, 8 rows' loads in flight at once, and at most
// 64 slices, summed in float64 (no lower a precision than float32's
// result); each block writes one partial, and the last block to finish,
// found by a ticket counter, adds the partials in a fixed order (staged
// through shared memory in rounds whose loads are all in flight together)
// and resets the counter.  No atomics touch the data: every run
// gives the same bits.  The apply kernels take 4 rows a thread; the
// coefficients are worked out in float64 once a block, a thread a column.
// Measured on the card (16 calls in one CUDA graph, against ~1.7 us for a
// one-element add; clock64 per phase): at 9728 x 64 bn_stats takes ~8.3
// us, bn_grad_stats ~9.9, each apply ~3.6; a reduction spends ~2.5 us on
// its rows' walk, ~1.1 us on the block's tree, ~0.7 us on the ticket and
// 1.5-2.5 us in the last block.  Fewer or more rows a thread, 4 or 16 rows
// in flight, and a serial (not tree) block sum measured no faster.
//
// The counters are per device: calls of one kind must follow each other
// (one stream, as a step's are), never overlap.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (ops/kernels/batchnorm.py).  Every entry launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SLICES = 64;     // row slices of a reduction grid
constexpr int SLICE_ROWS = 16;     // rows a thread walks in a slice
constexpr int UNROLL = 8;          // rows whose loads are in flight together
constexpr int APPLY_ROWS = 4;      // rows a thread of an apply kernel takes
constexpr int STAGE = 5120;        // doubles of a reduction kernel's shared
                                   // buffer: the block's tree, then the
                                   // last block's rounds of partials (38
                                   // slices of 129 values at once)
constexpr int MAX_VALUES = 2 * 32 * 4 + 1;   // a tile's partial, at most

enum { STATS_TICKET = 0, GRAD_TICKET = 1 };
__device__ unsigned int tickets[2] = {0u, 0u};

struct Geo {
  int vec, tx, ty, ct, tiles;
};

// tx threads across the columns (VEC a thread, tx a power of two up to 32),
// ty = THREADS / tx down the rows; a tile is the ct = tx VEC columns a block
// covers.
Geo geometry(int f) {
  Geo g;
  g.vec = f % 4 == 0 ? 4 : 1;
  const int lanes = (f + g.vec - 1) / g.vec;
  g.tx = 1;
  while (g.tx < lanes && g.tx < 32) g.tx *= 2;
  g.ty = THREADS / g.tx;
  g.ct = g.tx * g.vec;
  g.tiles = (f + g.ct - 1) / g.ct;
  return g;
}

int slices(const Geo& g, long long n) {
  const long long want = (n + (long long)g.ty * SLICE_ROWS - 1) /
                         ((long long)g.ty * SLICE_ROWS);
  return (int)(want < 1 ? 1 : want > MAX_SLICES ? MAX_SLICES : want);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float v[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
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

__device__ __forceinline__ bool kept(const uint8_t* mask, long long r) {
  return mask == nullptr || mask[r] != 0;
}

// The block's per-thread sums `acc` (NV values of VEC columns a thread) and
// `cnt` (rows counted; tx == 0's) into its partial: NV ct column values in
// order, then the count where `with_count`.  The rows' sums are added as a
// tree over ty (row ty takes row ty + s, s = ty_n / 2, ..., 1: a fixed
// order), each thread carrying its own sums in registers and passing them
// on through two buffers in turn, one barrier a step.  `red` holds
// 2 NV THREADS VEC doubles.
template <int VEC, int NV>
__device__ void block_partial(const double (&acc)[NV][VEC], int cnt,
                              bool with_count, int tx, int ty, int tx_n,
                              double* red, double* __restrict__ out) {
  __shared__ int cnt_red[2][THREADS];
  const int ty_n = THREADS / tx_n, ct = tx_n * VEC;
  const int half = NV * THREADS * VEC;
  double cur[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      cur[k][j] = acc[k][j];
      red[(k * ty_n + ty) * ct + tx * VEC + j] = cur[k][j];
    }
  if (tx == 0) cnt_red[0][ty] = cnt;
  int p = 0;
  for (int s = ty_n / 2; s > 0; s /= 2, p ^= 1) {
    __syncthreads();
    if (ty < s) {
      const double* from = red + p * half;
      double* to = red + (p ^ 1) * half;
      double o[NV][VEC];
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o[k][j] = from[(k * ty_n + ty + s) * ct + tx * VEC + j];
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          cur[k][j] += o[k][j];
          to[(k * ty_n + ty) * ct + tx * VEC + j] = cur[k][j];
        }
      if (tx == 0) {
        cnt += cnt_red[p][ty + s];
        cnt_red[p ^ 1][ty] = cnt;
      }
    }
  }
  if (ty == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[k * ct + tx * VEC + j] = cur[k][j];
    if (with_count && tx == 0) out[NV * ct] = (double)cnt;
  }
}

// After every thread wrote its share of the block's partial: true in the
// last block of the grid to get here (which then resets the ticket).
__device__ bool last_block(int ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned blocks = gridDim.x * gridDim.y;
    last = atomicAdd(&tickets[ticket], 1u) == blocks - 1;
    if (last) tickets[ticket] = 0u;
  }
  __syncthreads();
  return last;
}

// In the last block: the nv values of tile t summed over the grid's slices
// in a fixed order, into sums[nv] (shared).  The partials come through
// `stage` (STAGE doubles) in rounds of as many slices as it holds, each
// round's loads a fixed number a thread, all in flight together before any
// is stored; then each value adds its round's slices from shared memory.
__device__ void tile_sums(const double* __restrict__ part, int t, int nv,
                          double* stage, double* sums) {
  const int slices = gridDim.x, chunk = STAGE / nv;
  const double* base = part + (long long)t * slices * nv;
  __syncthreads();                   // the last tile's sums are read
  for (int v = threadIdx.x; v < nv; v += THREADS) sums[v] = 0.0;
  for (int b0 = 0; b0 < slices; b0 += chunk) {
    const int count = min(chunk, slices - b0) * nv;
    __syncthreads();
    double v[STAGE / THREADS];
#pragma unroll
    for (int k = 0; k < STAGE / THREADS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      v[k] = i < count ? __ldcg(base + (long long)b0 * nv + i) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < STAGE / THREADS; ++k) {
      const int i = threadIdx.x + k * THREADS;
      if (i < count) stage[i] = v[k];
    }
    __syncthreads();
    for (int v = threadIdx.x; v < nv; v += THREADS) {
      // four running sums (the round's slices 0, 1, 2, 3 mod 4) shorten
      // the chain of dependent adds; they join in a fixed order
      double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
      int i = v;
      for (; i + 3 * nv < count; i += 4 * nv) {
        s0 += stage[i];
        s1 += stage[i + nv];
        s2 += stage[i + 2 * nv];
        s3 += stage[i + 3 * nv];
      }
      if (i < count) s0 += stage[i];
      if (i + nv < count) s1 += stage[i + nv];
      if (i + 2 * nv < count) s2 += stage[i + 2 * nv];
      sums[v] += (s0 + s1) + (s2 + s3);
    }
  }
  __syncthreads();
}

// --- 1. the statistics -----------------------------------------------------

template <int VEC>
__global__ void __launch_bounds__(THREADS)
bn_stats_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                long long n, int f, int tx_n, long long slice_rows,
                double* __restrict__ part, double* __restrict__ totals) {
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int ty_n = THREADS / tx_n, ct = tx_n * VEC;
  const int col = blockIdx.y * ct + tx * VEC;
  const bool live = col < f;
  const long long r_begin = blockIdx.x * slice_rows;
  const long long r_end = min(n, r_begin + slice_rows);
  const int colc = live ? col : 0;          // an address in bounds
  double acc[2][VEC] = {};
  int cnt = 0;
  for (long long r0 = r_begin + ty; r0 < r_end;
       r0 += (long long)UNROLL * ty_n) {
    // every row's loads issued at once, unconditionally (a row past the
    // slice reads the slice's first and is dropped)
    float v[UNROLL][VEC];
    bool keep[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = r0 + (long long)u * ty_n;
      const long long rc = r < r_end ? r : r_begin;
      keep[u] = kept(mask, rc) && r < r_end;
      load_vec<VEC>(x + rc * f + colc, v[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!keep[u]) continue;
      ++cnt;
      if (!live) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const double d = v[u][j];
        acc[0][j] += d;
        acc[1][j] = fma(d, d, acc[1][j]);
      }
    }
  }
  const int nv = 2 * ct + 1;
  __shared__ double smem[STAGE], sums[MAX_VALUES];
  block_partial<VEC, 2>(acc, cnt, true, tx, ty, tx_n, smem,
                        part + ((long long)blockIdx.y * gridDim.x +
                                blockIdx.x) * nv);
  if (!last_block(STATS_TICKET)) return;
  for (int t = 0; t < (int)gridDim.y; ++t) {
    tile_sums(part, t, nv, smem, sums);
    for (int v = threadIdx.x; v < nv; v += THREADS) {
      if (v == 2 * ct) {
        if (t == 0) totals[2 * f] = sums[v];
      } else if (t * ct + v % ct < f) {
        totals[(v / ct) * f + t * ct + v % ct] = sums[v];
      }
    }
  }
}

// --- 2. the normalisation, ReLU and row mask -------------------------------

template <int VEC>
__global__ void __launch_bounds__(THREADS)
bn_apply_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                long long n, int f, int tx_n,
                const double* __restrict__ totals,
                const float* __restrict__ scale,
                const float* __restrict__ bias, float* run_mean,
                float* run_var, int update, double momentum, double eps,
                float* __restrict__ y, float* __restrict__ stats) {
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int ty_n = THREADS / tx_n, ct = tx_n * VEC;
  const int col = blockIdx.y * ct + tx * VEC;
  const bool live = col < f;
  const long long r0 = (long long)blockIdx.x * ty_n * APPLY_ROWS + ty;
  // the rows' loads first: the coefficients' arithmetic runs under them
  float v[APPLY_ROWS][VEC];
  bool in[APPLY_ROWS], keep[APPLY_ROWS];
#pragma unroll
  for (int u = 0; u < APPLY_ROWS; ++u) {
    const long long r = r0 + (long long)u * ty_n;
    in[u] = live && r < n;
    keep[u] = in[u] && kept(mask, r);
    if (in[u]) load_vec<VEC>(x + r * f + col, v[u]);
  }
  // the tile's coefficients in float64, a thread a column; block 0 also
  // keeps them for the backward and moves the running statistics
  __shared__ float coef[2][32 * VEC];      // ct <= 32 VEC columns
  const int k = blockIdx.y * ct + threadIdx.x;
  if (threadIdx.x < ct && k < f) {
    double mean, var, pass = 1.0;
    if (totals != nullptr) {
      const double cnt = fmax(totals[2 * f], 1.0);
      mean = totals[k] / cnt;
      const double v0 = totals[f + k] / cnt - mean * mean;
      pass = v0 >= 0.0 ? 1.0 : 0.0;
      var = v0 >= 0.0 ? v0 : 0.0;
      if (update && blockIdx.x == 0) {
        const double unbiased = var * cnt / fmax(cnt - 1.0, 1.0);
        run_mean[k] = (float)((1.0 - momentum) * run_mean[k] +
                              momentum * mean);
        run_var[k] = (float)((1.0 - momentum) * run_var[k] +
                             momentum * unbiased);
      }
    } else {
      mean = run_mean[k];
      var = run_var[k];
    }
    const double r = 1.0 / sqrt(var + eps);
    const double ad = (double)scale[k] * r;
    const float af = (float)ad, cf = (float)((double)bias[k] - mean * ad);
    coef[0][threadIdx.x] = af;
    coef[1][threadIdx.x] = cf;
    if (blockIdx.x == 0) {
      stats[k] = af;
      stats[f + k] = cf;
      stats[2 * f + k] = (float)mean;
      stats[3 * f + k] = (float)r;
      stats[4 * f + k] = (float)pass;
    }
  }
  __syncthreads();
  float a[VEC], c[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a[j] = coef[0][tx * VEC + j];
    c[j] = coef[1][tx * VEC + j];
  }
#pragma unroll
  for (int u = 0; u < APPLY_ROWS; ++u) {
    if (!in[u]) continue;
    float out[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float z = fmaf(v[u][j], a[j], c[j]);
      out[j] = keep[u] && z > 0.f ? z : 0.f;
    }
    store_vec<VEC>(y + (r0 + (long long)u * ty_n) * f + col, out);
  }
}

// --- 3. the backward's column sums -----------------------------------------

template <int VEC>
__global__ void __launch_bounds__(THREADS)
bn_grad_stats_kernel(const float* __restrict__ dy,
                     const float* __restrict__ x,
                     const uint8_t* __restrict__ mask, long long n, int f,
                     int tx_n, long long slice_rows,
                     const float* __restrict__ stats,
                     const double* __restrict__ totals,
                     const float* __restrict__ scale,
                     double* __restrict__ part, float* __restrict__ dscale,
                     float* __restrict__ dbias, float* __restrict__ terms) {
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int ty_n = THREADS / tx_n, ct = tx_n * VEC;
  const int col = blockIdx.y * ct + tx * VEC;
  const bool live = col < f;
  const long long r_begin = blockIdx.x * slice_rows;
  const long long r_end = min(n, r_begin + slice_rows);
  float a[VEC], c[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a[j] = live ? stats[col + j] : 0.f;
    c[j] = live ? stats[f + col + j] : 0.f;
  }
  double acc[2][VEC] = {};
  for (long long r0 = r_begin + ty; r0 < r_end && live;
       r0 += (long long)UNROLL * ty_n) {
    float g[UNROLL][VEC], v[UNROLL][VEC];
    bool keep[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {             // as in bn_stats
      const long long r = r0 + (long long)u * ty_n;
      const long long rc = r < r_end ? r : r_begin;
      keep[u] = kept(mask, rc) && r < r_end;
      load_vec<VEC>(dy + rc * f + col, g[u]);
      load_vec<VEC>(x + rc * f + col, v[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!keep[u]) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (!(fmaf(v[u][j], a[j], c[j]) > 0.f)) continue;
        const double gd = g[u][j];
        acc[0][j] += gd;
        acc[1][j] = fma(gd, (double)v[u][j], acc[1][j]);
      }
    }
  }
  const int nv = 2 * ct;
  __shared__ double smem[STAGE], sums[MAX_VALUES];
  block_partial<VEC, 2>(acc, 0, false, tx, ty, tx_n, smem,
                        part + ((long long)blockIdx.y * gridDim.x +
                                blockIdx.x) * nv);
  if (!last_block(GRAD_TICKET)) return;
  for (int t = 0; t < (int)gridDim.y; ++t) {
    tile_sums(part, t, nv, smem, sums);
    for (int v = threadIdx.x; v < ct; v += THREADS) {
      const int k = t * ct + v;
      if (k >= f) continue;
      const double sg = sums[v], sgx = sums[ct + v];
      const double ak = stats[k], mean = stats[2 * f + k];
      const double r = stats[3 * f + k];
      const double da = sgx - mean * sg;     // d loss / d a
      dbias[k] = (float)sg;
      dscale[k] = (float)(da * r);
      double d1 = 0.0, d2 = 0.0;
      if (totals != nullptr) {
        const double cnt = fmax(totals[2 * f], 1.0);
        // var -> r = rsqrt(var + eps) -> a = scale r; the clamp at 0
        // passes the gradient where S2 / count - mean^2 >= 0
        const double dvar = stats[4 * f + k] != 0.f
                                ? -0.5 * da * (double)scale[k] * r * r * r
                                : 0.0;
        const double dmean = -ak * sg - 2.0 * mean * dvar;
        d1 = dmean / cnt;
        d2 = dvar / cnt;
      }
      terms[k] = (float)d1;
      terms[f + k] = (float)d2;
    }
  }
}

// --- 4. the input's gradient -----------------------------------------------

template <int VEC>
__global__ void __launch_bounds__(THREADS)
bn_grad_apply_kernel(const float* __restrict__ dy,
                     const float* __restrict__ x,
                     const uint8_t* __restrict__ mask, long long n, int f,
                     int tx_n, const float* __restrict__ stats,
                     const float* __restrict__ terms,
                     float* __restrict__ dx) {
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int ty_n = THREADS / tx_n, ct = tx_n * VEC;
  const int col = blockIdx.y * ct + tx * VEC;
  if (col >= f) return;
  const long long r0 = (long long)blockIdx.x * ty_n * APPLY_ROWS + ty;
  float g[APPLY_ROWS][VEC], v[APPLY_ROWS][VEC];
  bool in[APPLY_ROWS], keep[APPLY_ROWS];
#pragma unroll
  for (int u = 0; u < APPLY_ROWS; ++u) {
    const long long r = r0 + (long long)u * ty_n;
    in[u] = r < n;
    keep[u] = in[u] && kept(mask, r);
    if (in[u]) {
      load_vec<VEC>(dy + r * f + col, g[u]);
      load_vec<VEC>(x + r * f + col, v[u]);
    }
  }
  float a[VEC], c[VEC], d1[VEC], d2[VEC];
  load_vec<VEC>(stats + col, a);
  load_vec<VEC>(stats + f + col, c);
  load_vec<VEC>(terms + col, d1);
  load_vec<VEC>(terms + f + col, d2);
#pragma unroll
  for (int u = 0; u < APPLY_ROWS; ++u) {
    if (!in[u]) continue;
    float out[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float gj =
          keep[u] && fmaf(v[u][j], a[j], c[j]) > 0.f ? g[u][j] : 0.f;
      const float m = keep[u] ? fmaf(2.f * v[u][j], d2[j], d1[j]) : 0.f;
      out[j] = fmaf(gj, a[j], m);
    }
    store_vec<VEC>(dx + (r0 + (long long)u * ty_n) * f + col, out);
  }
}

dim3 apply_grid(const Geo& g, long long n) {
  const long long rows = (long long)g.ty * APPLY_ROWS;
  const long long blocks = (n + rows - 1) / rows;
  return dim3((unsigned)(blocks < 1 ? 1 : blocks), (unsigned)g.tiles);
}

template <typename K>
int launch(K* kernel, dim3 grid, void** args, cudaStream_t stream) {
  const int err = (int)cudaLaunchKernel((const void*)kernel, grid,
                                        dim3(THREADS), args, 0, stream);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Doubles of the partials scratch that bn_stats and bn_grad_stats take for
// n rows of width f (the larger of the two).
int scgib_bn_partials(long long n, int f, long long* doubles) {
  const Geo g = geometry(f);
  *doubles = (long long)slices(g, n) * g.tiles * (2 * g.ct + 1);
  return 0;
}

// x 16-byte aligned where f % 4 == 0 (the wrapper checks); mask null or n
// bytes; totals 2 f + 1 doubles.
int scgib_bn_stats(const void* x, const void* mask, long long n, int f,
                   void* part, void* totals, void* stream) {
  const Geo g = geometry(f);
  const int s = slices(g, n);
  long long slice_rows = (n + s - 1) / s;
  int tx = g.tx;
  void* args[] = {(void*)&x, (void*)&mask, (void*)&n, (void*)&f, (void*)&tx,
                  (void*)&slice_rows, (void*)&part, (void*)&totals};
  const dim3 grid(s, g.tiles);
  return g.vec == 4
             ? launch(bn_stats_kernel<4>, grid, args, (cudaStream_t)stream)
             : launch(bn_stats_kernel<1>, grid, args, (cudaStream_t)stream);
}

// totals null: eval mode (a and c from run_mean, run_var).  stats: 5 f
// floats (a, c, mean, rsqrt(var + eps), the clamp's pass).
int scgib_bn_apply(const void* x, const void* mask, long long n, int f,
                   const void* totals, const void* scale, const void* bias,
                   void* run_mean, void* run_var, int update,
                   double momentum, double eps, void* y, void* stats,
                   void* stream) {
  const Geo g = geometry(f);
  int tx = g.tx;
  void* args[] = {(void*)&x, (void*)&mask, (void*)&n, (void*)&f,
                  (void*)&tx, (void*)&totals, (void*)&scale, (void*)&bias,
                  (void*)&run_mean, (void*)&run_var, (void*)&update,
                  (void*)&momentum, (void*)&eps, (void*)&y, (void*)&stats};
  const dim3 grid = apply_grid(g, n);
  return g.vec == 4
             ? launch(bn_apply_kernel<4>, grid, args, (cudaStream_t)stream)
             : launch(bn_apply_kernel<1>, grid, args, (cudaStream_t)stream);
}

// totals null: eval mode (terms 0).  dscale, dbias f floats; terms 2 f
// (dS1, dS2).
int scgib_bn_grad_stats(const void* dy, const void* x, const void* mask,
                        long long n, int f, const void* stats,
                        const void* totals, const void* scale, void* part,
                        void* dscale, void* dbias, void* terms,
                        void* stream) {
  const Geo g = geometry(f);
  const int s = slices(g, n);
  long long slice_rows = (n + s - 1) / s;
  int tx = g.tx;
  void* args[] = {(void*)&dy, (void*)&x, (void*)&mask, (void*)&n,
                  (void*)&f, (void*)&tx, (void*)&slice_rows,
                  (void*)&stats, (void*)&totals, (void*)&scale,
                  (void*)&part, (void*)&dscale, (void*)&dbias,
                  (void*)&terms};
  const dim3 grid(s, g.tiles);
  return g.vec == 4 ? launch(bn_grad_stats_kernel<4>, grid, args,
                             (cudaStream_t)stream)
                    : launch(bn_grad_stats_kernel<1>, grid, args,
                             (cudaStream_t)stream);
}

int scgib_bn_grad_apply(const void* dy, const void* x, const void* mask,
                        long long n, int f, const void* stats,
                        const void* terms, void* dx, void* stream) {
  const Geo g = geometry(f);
  int tx = g.tx;
  void* args[] = {(void*)&dy, (void*)&x, (void*)&mask, (void*)&n,
                  (void*)&f, (void*)&tx, (void*)&stats, (void*)&terms,
                  (void*)&dx};
  const dim3 grid = apply_grid(g, n);
  return g.vec == 4 ? launch(bn_grad_apply_kernel<4>, grid, args,
                             (cudaStream_t)stream)
                    : launch(bn_grad_apply_kernel<1>, grid, args,
                             (cudaStream_t)stream);
}

// For the report: registers a thread, shared memory a block and blocks an
// SM of the kernel a call at width f launches; which = 0 bn_stats,
// 1 bn_apply, 2 bn_grad_stats, 3 bn_grad_apply.  grid[0..1]: its grid at
// n rows.
int scgib_bn_kernel_info(int which, long long n, int f, int* info) {
  const Geo g = geometry(f);
  const bool v4 = g.vec == 4;
  const void* kernels[4] = {
      v4 ? (const void*)bn_stats_kernel<4> : (const void*)bn_stats_kernel<1>,
      v4 ? (const void*)bn_apply_kernel<4> : (const void*)bn_apply_kernel<1>,
      v4 ? (const void*)bn_grad_stats_kernel<4>
         : (const void*)bn_grad_stats_kernel<1>,
      v4 ? (const void*)bn_grad_apply_kernel<4>
         : (const void*)bn_grad_apply_kernel<1>};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernels[which]);
  if (err) return err;
  int per_sm = 0;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernels[which], THREADS, 0)))
    return err;
  const dim3 grid = which % 2 == 0 ? dim3(slices(g, n), g.tiles)
                                   : apply_grid(g, n);
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = per_sm;
  info[3] = (int)grid.x;
  info[4] = (int)grid.y;
  return 0;
}

}  // extern "C"
