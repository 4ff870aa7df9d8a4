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
// Layout (graph/banded.py): blocks [T, TL, BW] bf16 0/1 (TL = 64, BW = 128 in
// the narrow graph-transformer geometry; 128, 256 in the wide one), col_off
// [T] int64; row i of tile t = i / TL attends to the columns
// [col_off[t], col_off[t] + BW).  q, k, v, g, dq, dk, dv are [N, H, hd] f32,
// z and rho [N, H] f32, N = T * TL.
//
// What bounds them on an H100: at the main path's shapes (N = 3072 or 9728
// rows, H = 8, hd = 8) a call reads a few MB (q, k, v, g and the bf16 gate)
// and does little arithmetic, because the gate is sparse: a molecule's row
// has 2-3 edges in a window of 128 columns.  The TPU kernel computes the
// dense [TL, BW] tile per head (its matrix unit wants dense work); here that
// would be ~50x more exponentials than edges.  So the floor is the bytes, a
// few microseconds, and the design spends work only on edges: one thread
// block per (row tile, head), one warp per row, the lanes walking the row's
// window 32 columns at a time (coalesced bf16 gate reads).  Only where the
// gate is nonzero does a lane compute the score, its exponential and the
// products, reading that k / v row from global memory (L1 / L2 hold the
// window).  Warp shuffles reduce z, rho and the hd-wide sums; no shared
// memory, fp32 FMA, no max shift in the exponential (as gt_flash.py:133).
// A zero gate entry contributes exactly 0 in the TPU kernel too (a clipped
// finite score's exponential times 0), so skipping it changes nothing for
// finite inputs.
//
// The column pass relies on A = A^T (the packers symmetrize every edge
// list): the rows that attend to column c of tile tc lie in the window
// col_off[tc], and the gate of (row col_off[tc] + r, column c) equals
// blocks[tc][c - tc * TL][r], row c of the column's own slab.  So the column
// pass reads the slab by rows, like the row pass; no transposed gate is
// built.  It recomputes each entry from z and rho and is deterministic.
//
// The merged pass: the TPU grid runs its programs in order, which made the
// read-modify-write of overlapping dk / dv windows race-free there.  CUDA
// blocks run in no order, so here every edge adds its dk and dv terms to
// buffers the caller zeroed, with atomicAdd.  The sums are then taken in an
// order that changes from run to run: the merged result is not bitwise
// deterministic.  Two-pass is the default.
//
// Tensor cores, TMA and bf16 operands are later work.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (ops/kernels/gt_flash.py).  Every entry launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SLOTS = 8;      // window columns per lane: BW <= 256

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
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

template <int HD>
__global__ void __launch_bounds__(THREADS)
gt_fwd_kernel(const __nv_bfloat16* __restrict__ blocks,
              const long long* __restrict__ col_off, int TL, int BW,
              const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, int H, float scale, float clamp,
              float eps, float* __restrict__ out, float* __restrict__ z) {
  const int t = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long D = (long long)H * HD;
  const long long off = col_off[t];
  for (int r = warp; r < TL; r += WARPS) {
    const long long i = (long long)t * TL + r;
    const __nv_bfloat16* gate = blocks + i * BW;
    float qi[HD], acc[HD];
    load_row<HD>(q + i * D + h * HD, qi);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
    float zs = 0.f;
    for (int j = lane; j < BW; j += 32) {
      const float a = __bfloat162float(gate[j]);
      if (a != 0.f) {
        const long long row = (off + j) * D + h * HD;
        const float e = gated_exp(dot<HD>(qi, k + row) * scale, a, clamp);
        zs += e;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(e, v[row + d], acc[d]);
      }
    }
    zs = warp_sum(zs);
    warp_sum_row<HD>(acc);
    if (lane == 0) {
      const float inv = 1.f / (zs + eps);
#pragma unroll
      for (int d = 0; d < HD; ++d) out[i * D + h * HD + d] = acc[d] * inv;
      z[i * H + h] = zs;
    }
  }
}

// The row pass; with MERGED it also adds dk and dv (zeroed by the caller)
// instead of emitting rho.
template <int HD, bool MERGED>
__global__ void __launch_bounds__(THREADS)
gt_bwd_rows_kernel(const __nv_bfloat16* __restrict__ blocks,
                   const long long* __restrict__ col_off, int TL, int BW,
                   const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ z, int H, float scale,
                   float clamp, float eps, float* __restrict__ dq,
                   float* __restrict__ rho, float* __restrict__ dk,
                   float* __restrict__ dv) {
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
        if (MERGED) {
          const float w = e[m] * inv;
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            atomicAdd(dk + row + d, ds * scale * qi[d]);
            atomicAdd(dv + row + d, w * gi[d]);
          }
        }
      }
    }
    warp_sum_row<HD>(acc);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < HD; ++d) dq[i * D + h * HD + d] = acc[d] * scale;
      if (!MERGED) rho[i * H + h] = rh;
    }
  }
}

// The column pass: block (tc, h), one warp per column c of tile tc.
template <int HD>
__global__ void __launch_bounds__(THREADS)
gt_bwd_cols_kernel(const __nv_bfloat16* __restrict__ blocks,
                   const long long* __restrict__ col_off, int TL, int BW,
                   const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ z, const float* __restrict__ rho,
                   int H, float scale, float clamp, float eps,
                   float* __restrict__ dk, float* __restrict__ dv) {
  const int t = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long D = (long long)H * HD;
  const long long off = col_off[t];
  for (int cc = warp; cc < TL; cc += WARPS) {
    const long long c = (long long)t * TL + cc;
    // A[off + r, c] = A[c, off + r]: row cc of this tile's slab
    const __nv_bfloat16* gate = blocks + c * BW;
    float kc[HD], vc[HD], ak[HD], av[HD];
    load_row<HD>(k + c * D + h * HD, kc);
    load_row<HD>(v + c * D + h * HD, vc);
#pragma unroll
    for (int d = 0; d < HD; ++d) ak[d] = av[d] = 0.f;
    for (int rr = lane; rr < BW; rr += 32) {
      const float a = __bfloat162float(gate[rr]);
      if (a != 0.f) {
        const long long i = off + rr;
        const long long row = i * D + h * HD;
        const float s = dot<HD>(kc, q + row) * scale;
        const float e = gated_exp(s, a, clamp);
        const float inv = 1.f / (z[i * H + h] + eps);
        const float gv = dot<HD>(vc, g + row);
        const float ds = (s >= -clamp && s <= clamp)
                             ? e * (gv - rho[i * H + h]) * inv : 0.f;
        const float w = e * inv;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          ak[d] = fmaf(ds, q[row + d], ak[d]);
          av[d] = fmaf(w, g[row + d], av[d]);
        }
      }
    }
    warp_sum_row<HD>(ak);
    warp_sum_row<HD>(av);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dk[c * D + h * HD + d] = ak[d] * scale;
        dv[c * D + h * HD + d] = av[d];
      }
    }
  }
}

bool bad_geometry(int BW, int hd) {
  return BW <= 0 || BW % 32 != 0 || BW > 32 * MAX_SLOTS || hd <= 0 ||
         hd > 32 || (hd & (hd - 1)) != 0;
}

}  // namespace

// Instantiate CALL for the head width: hd in {1, 2, 4, 8, 16, 32}.
#define SCGIB_DISPATCH_HD(hd, ...)                         \
  switch (hd) {                                            \
    case 1: { constexpr int HD = 1; __VA_ARGS__; } break;  \
    case 2: { constexpr int HD = 2; __VA_ARGS__; } break;  \
    case 4: { constexpr int HD = 4; __VA_ARGS__; } break;  \
    case 8: { constexpr int HD = 8; __VA_ARGS__; } break;  \
    case 16: { constexpr int HD = 16; __VA_ARGS__; } break; \
    case 32: { constexpr int HD = 32; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;            \
  }

extern "C" {

int scgib_gt_fwd(const void* blocks, const void* col_off, int n_tiles, int TL,
                 int BW, const void* q, const void* k, const void* v, int H,
                 int hd, float scale, float clamp, float eps, void* out,
                 void* z, void* stream) {
  if (bad_geometry(BW, hd)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, H);
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(hd, gt_fwd_kernel<HD><<<grid, THREADS, 0, s>>>(
      (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
      (const float*)q, (const float*)k, (const float*)v, H, scale, clamp,
      eps, (float*)out, (float*)z));
  return (int)cudaGetLastError();
}

int scgib_gt_bwd_rows(const void* blocks, const void* col_off, int n_tiles,
                      int TL, int BW, const void* q, const void* k,
                      const void* v, const void* g, const void* z, int H,
                      int hd, float scale, float clamp, float eps, void* dq,
                      void* rho, void* stream) {
  if (bad_geometry(BW, hd)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, H);
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(hd, gt_bwd_rows_kernel<HD, false><<<grid, THREADS, 0, s>>>(
      (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)z, H, scale, clamp, eps, (float*)dq, (float*)rho,
      nullptr, nullptr));
  return (int)cudaGetLastError();
}

int scgib_gt_bwd_cols(const void* blocks, const void* col_off, int n_tiles,
                      int TL, int BW, const void* q, const void* k,
                      const void* v, const void* g, const void* z,
                      const void* rho, int H, int hd, float scale,
                      float clamp, float eps, void* dk, void* dv,
                      void* stream) {
  if (bad_geometry(BW, hd)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, H);
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(hd, gt_bwd_cols_kernel<HD><<<grid, THREADS, 0, s>>>(
      (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)z, (const float*)rho, H, scale, clamp, eps, (float*)dk,
      (float*)dv));
  return (int)cudaGetLastError();
}

// dk and dv must be zeroed by the caller (they are accumulated).
int scgib_gt_bwd_merged(const void* blocks, const void* col_off, int n_tiles,
                        int TL, int BW, const void* q, const void* k,
                        const void* v, const void* g, const void* z, int H,
                        int hd, float scale, float clamp, float eps,
                        void* dq, void* dk, void* dv, void* stream) {
  if (bad_geometry(BW, hd)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, H);
  cudaStream_t s = (cudaStream_t)stream;
  SCGIB_DISPATCH_HD(hd, gt_bwd_rows_kernel<HD, true><<<grid, THREADS, 0, s>>>(
      (const __nv_bfloat16*)blocks, (const long long*)col_off, TL, BW,
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)z, H, scale, clamp, eps, (float*)dq, nullptr,
      (float*)dk, (float*)dv));
  return (int)cudaGetLastError();
}

}  // extern "C"
