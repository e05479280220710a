// Weight gradient of a stride-1 "same" convolution from pre-padded input,
// with the halo double-buffered by asynchronous copies:
//
//   dW[u, v, ci, co] = sum_{b,h,w} xp[b, h+u, w+v, ci] * g[b, h, w, co]
//
// xp [B, H+k-1, W+k-1, Ci] and g [B, H, W, Co], NHWC, both bf16 or both f32;
// dW [k, k, Ci, Co] f32 (HWIO).  k is 1, 3 or 5.
//
// Replaces yolodl_tpu/kernels/wgrad_db.py:_wgrad_db_kernel (reached through
// wgrad_db and the custom-vjp conv conv2d_db).  What distinguished that
// kernel from _wgrad_kernel carries over: the halo of row block s+1 is copied
// while row block s is computed, and each tap keeps its own accumulator.
// The TPU kernel's padding of ci to 128 and of W to 8 served Mosaic's tiling
// only and is dropped.
//
// Bound on an H100: the bytes of xp and g read once plus dW written once,
// at 3.35 TB/s, against 2*B*H*W*k*k*Ci*Co flops at 989 TFLOP/s for bf16
// inputs (tensor cores) or 67 TFLOP/s for f32 (the same function as
// wgrad_lowch.cu, the same bounds: 42.6 us for 304^2 32->64 k3 at b8).
// The design answers the small output and the huge contraction the same
// way as wgrad_lowch.cu, and differs inside the block:
//
// * grid.x walks output tiles of ci_t input channels (64 at k=1, 16 at
//   k=3 and 5) by 64 output channels, all k*k taps; grid.y walks
//   contraction chunks, each a run of output rows of one image.
// * A block walks its sub-tiles of 2 output rows x 32 columns with a
//   two-stage pipeline: cp.async (__pipeline_memcpy_async, sm_80+) copies
//   the raw (2+k-1) x (32+k-1) x ci_t halo of xp and the g tile of
//   sub-tile s+1 into one half of a double buffer while the threads compute
//   sub-tile s from the other half.  Spans are copied 16 or 4 bytes at a
//   time where both addresses and the length allow it, else element by
//   element (the 3-channel stem in bf16).
// * Each of the 256 threads owns rci input channels x 4 output channels
//   for every tap: acc[k*k][rci][4] in registers (rci = 4 at k=1, else 1),
//   f32 FMA on CUDA cores, operands converted from the staged dtype as they
//   are read.
// * Determinism: per-block partials into a scratch tensor [chunks,
//   k*k*Ci, Co], then a second kernel adds the chunks in a fixed order.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int RC = 4;                 // output channels per thread
constexpr int CO_T = 64;              // output channels per tile
constexpr int QUADS = CO_T / RC;      // threads along output channels (16)
constexpr int GROUPS = THREADS / QUADS;  // threads along input channels (16)
constexpr int R = 2;                  // output rows per sub-tile
constexpr int TW = 32;                // output columns per sub-tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int rci_of(int k) { return k == 1 ? 4 : 1; }
__host__ __device__ constexpr int ci_tile_of(int k) { return GROUPS * rci_of(k); }

__host__ __device__ inline int round16(int bytes) { return (bytes + 15) / 16 * 16; }

template <typename T>
__host__ __device__ inline int xs_bytes(int k) {
  return round16((R + k - 1) * (TW + k - 1) * ci_tile_of(k) * static_cast<int>(sizeof(T)));
}
template <typename T>
__host__ __device__ inline int gs_bytes() {
  return round16(R * TW * CO_T * static_cast<int>(sizeof(T)));
}

// Block-cooperative copy of n_rows x n_cols spans of `len` elements:
// span (r, c) goes from src + r*src_rs + c*src_cs to dst + r*dst_rs + c*dst_cs.
// Asynchronous (cp.async) in 16- or 4-byte pieces where every address and
// the length are aligned to the piece, else synchronous per element.
template <typename T>
__device__ void stage_spans(T* dst, int dst_rs, int dst_cs, const T* src,
                            long long src_rs, long long src_cs, int n_rows,
                            int n_cols, int len, int tid) {
  const int es = static_cast<int>(sizeof(T));
  const unsigned long long align =
      reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
      static_cast<unsigned long long>(dst_rs * es) |
      static_cast<unsigned long long>(dst_cs * es) |
      static_cast<unsigned long long>(src_rs * es) |
      static_cast<unsigned long long>(src_cs * es) |
      static_cast<unsigned long long>(len * es);
  const int piece = (align & 15) == 0 ? 16 : (align & 3) == 0 ? 4 : 0;
  const int spans = n_rows * n_cols;
  if (piece != 0) {
    const int per_span = len * es / piece;
    const int n = spans * per_span;
    for (int e = tid; e < n; e += THREADS) {
      const int s = e / per_span;
      const int off = (e % per_span) * piece;
      const int r = s / n_cols;
      const int c = s % n_cols;
      char* d = reinterpret_cast<char*>(dst + r * dst_rs + c * dst_cs) + off;
      const char* p = reinterpret_cast<const char*>(src + r * src_rs + c * src_cs) + off;
      __pipeline_memcpy_async(d, p, piece);
    }
  } else {
    const int n = spans * len;
    for (int e = tid; e < n; e += THREADS) {
      const int s = e / len;
      const int i = e % len;
      const int r = s / n_cols;
      const int c = s % n_cols;
      dst[r * dst_rs + c * dst_cs + i] = src[r * src_rs + c * src_cs + i];
    }
  }
}

struct Geometry {
  int h, w, ci, co;
  int ci0, co0, ci_n, co_n;
  int b;
};

// Stage sub-tile (h0, rv rows; w0, wv columns) into one buffer.
template <typename T, int K>
__device__ void stage_subtile(const T* xp, const T* g, T* xs, T* gs, const Geometry& q,
                              int h0, int rv, int w0, int wv, int tid) {
  const int hp = q.h + K - 1;
  const int wp = q.w + K - 1;
  const int hw_cap = TW + K - 1;
  const int hrows = rv + K - 1;
  const int hpix = wv + K - 1;
  const T* xsrc = xp + ((static_cast<long long>(q.b) * hp + h0) * wp + w0) * q.ci + q.ci0;
  if (q.ci_n == q.ci) {  // whole pixels: one contiguous span per halo row
    stage_spans(xs, hw_cap * q.ci_n, 0, xsrc, static_cast<long long>(wp) * q.ci, 0, hrows, 1,
                hpix * q.ci, tid);
  } else {
    stage_spans(xs, hw_cap * q.ci_n, q.ci_n, xsrc, static_cast<long long>(wp) * q.ci, q.ci,
                hrows, hpix, q.ci_n, tid);
  }
  const T* gsrc = g + ((static_cast<long long>(q.b) * q.h + h0) * q.w + w0) * q.co + q.co0;
  if (q.co_n == q.co) {  // whole positions: one contiguous span per row
    stage_spans(gs, TW * q.co_n, 0, gsrc, static_cast<long long>(q.w) * q.co, 0, rv, 1,
                wv * q.co, tid);
  } else {
    stage_spans(gs, TW * q.co_n, q.co_n, gsrc, static_cast<long long>(q.w) * q.co, q.co, rv,
                wv, q.co_n, tid);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
wgrad_db_kernel(const T* __restrict__ xp, const T* __restrict__ g,
                float* __restrict__ partial, int h, int w, int ci, int co,
                int rows_per_chunk, int chunks_per_image) {
  constexpr int KK = K * K;
  constexpr int RCI = rci_of(K);
  constexpr int CI_T = ci_tile_of(K);
  extern __shared__ __align__(16) unsigned char smem[];
  const int xsb = xs_bytes<T>(K);
  const int gsb = gs_bytes<T>();
  T* xs_buf[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem + xsb + gsb)};
  T* gs_buf[2] = {reinterpret_cast<T*>(smem + xsb),
                  reinterpret_cast<T*>(smem + 2 * xsb + gsb)};

  const int ci_tiles = (ci + CI_T - 1) / CI_T;
  Geometry q;
  q.h = h;
  q.w = w;
  q.ci = ci;
  q.co = co;
  q.ci0 = (blockIdx.x % ci_tiles) * CI_T;
  q.co0 = (blockIdx.x / ci_tiles) * CO_T;
  q.ci_n = min(CI_T, ci - q.ci0);
  q.co_n = min(CO_T, co - q.co0);
  const int chunk = blockIdx.y;
  q.b = chunk / chunks_per_image;
  const int h_begin = (chunk % chunks_per_image) * rows_per_chunk;
  const int h_end = min(h_begin + rows_per_chunk, h);
  const int tid = threadIdx.x;
  const int quad = tid % QUADS;
  const int grp = tid / QUADS;
  const int hw_cap = TW + K - 1;

  // staged operand index of each owned channel, clamped into the tile
  // (the clamped lanes compute values that are never written)
  int cidx[RCI];
#pragma unroll
  for (int i = 0; i < RCI; ++i) cidx[i] = min(grp * RCI + i, q.ci_n - 1);
  int gidx[RC];
#pragma unroll
  for (int j = 0; j < RC; ++j) gidx[j] = min(quad * RC + j, q.co_n - 1);

  float acc[KK][RCI][RC];
#pragma unroll
  for (int t = 0; t < KK; ++t)
#pragma unroll
    for (int i = 0; i < RCI; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[t][i][j] = 0.0f;

  const int col_tiles = (w + TW - 1) / TW;
  const int row_tiles = (h_end - h_begin + R - 1) / R;
  const int n_sub = row_tiles * col_tiles;

  if (n_sub > 0) {
    stage_subtile<T, K>(xp, g, xs_buf[0], gs_buf[0], q, h_begin, min(R, h_end - h_begin), 0,
                        min(TW, w), tid);
  }
  __pipeline_commit();
  for (int s = 0; s < n_sub; ++s) {
    const int h0 = h_begin + (s / col_tiles) * R;
    const int w0 = (s % col_tiles) * TW;
    const int rv = min(R, h_end - h0);
    const int wv = min(TW, w - w0);
    if (s + 1 < n_sub) {  // prefetch sub-tile s+1 into the other half
      const int h1 = h_begin + ((s + 1) / col_tiles) * R;
      const int w1 = ((s + 1) % col_tiles) * TW;
      stage_subtile<T, K>(xp, g, xs_buf[(s + 1) & 1], gs_buf[(s + 1) & 1], q, h1,
                          min(R, h_end - h1), w1, min(TW, w - w1), tid);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of sub-tile s have landed
    __syncthreads();           // and every other thread's

    const T* xs = xs_buf[s & 1];
    const T* gs = gs_buf[s & 1];
    for (int r = 0; r < rv; ++r) {
      for (int c = 0; c < wv; ++c) {
        const T* gp = gs + (r * TW + c) * q.co_n;
        float gv[RC];
#pragma unroll
        for (int j = 0; j < RC; ++j) gv[j] = to_f32(gp[gidx[j]]);
#pragma unroll
        for (int u = 0; u < K; ++u) {
#pragma unroll
          for (int v = 0; v < K; ++v) {
            const T* px = xs + ((r + u) * hw_cap + c + v) * q.ci_n;
#pragma unroll
            for (int i = 0; i < RCI; ++i) {
              const float xv = to_f32(px[cidx[i]]);
#pragma unroll
              for (int j = 0; j < RC; ++j)
                acc[u * K + v][i][j] = __fmaf_rn(xv, gv[j], acc[u * K + v][i][j]);
            }
          }
        }
      }
    }
    __syncthreads();  // sub-tile s is read before its buffer takes s+2
  }

  float* out = partial + static_cast<long long>(chunk) * KK * ci * co;
#pragma unroll
  for (int t = 0; t < KK; ++t) {
#pragma unroll
    for (int i = 0; i < RCI; ++i) {
      const int c = grp * RCI + i;
      if (c >= q.ci_n) continue;
      const long long row = static_cast<long long>(t) * ci + q.ci0 + c;
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const int cc = quad * RC + j;
        if (cc < q.co_n) out[row * co + q.co0 + cc] = acc[t][i][j];
      }
    }
  }
}

// out[i] = sum over chunks of partial[chunk][i], chunks in order
__global__ void reduce_chunks_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int chunks, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s = __fadd_rn(s, partial[c * n + i]);
  out[i] = s;
}

template <typename T, int K>
int launch(const void* xp, const void* g, float* partial, float* out, int b, int h, int w,
           int ci, int co, int rows_per_chunk, cudaStream_t stream) {
  constexpr int CI_T = ci_tile_of(K);
  const int tiles = ((ci + CI_T - 1) / CI_T) * ((co + CO_T - 1) / CO_T);
  const int chunks_per_image = (h + rows_per_chunk - 1) / rows_per_chunk;
  const long long chunks = static_cast<long long>(b) * chunks_per_image;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = 2 * (xs_bytes<T>(K) + gs_bytes<T>());
  cudaError_t err = cudaFuncSetAttribute(wgrad_db_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_db_kernel<T, K><<<dim3(tiles, static_cast<unsigned>(chunks)), THREADS, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(g), partial, h, w, ci, co,
      rows_per_chunk, chunks_per_image);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(K) * K * ci * co;
  reduce_chunks_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      partial, out, static_cast<int>(chunks), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k(const void* xp, const void* g, float* partial, float* out, int b, int h, int w,
             int ci, int co, int k, int rows_per_chunk, cudaStream_t s) {
  switch (k) {
    case 1: return launch<T, 1>(xp, g, partial, out, b, h, w, ci, co, rows_per_chunk, s);
    case 3: return launch<T, 3>(xp, g, partial, out, b, h, w, ci, co, rows_per_chunk, s);
    case 5: return launch<T, 5>(xp, g, partial, out, b, h, w, ci, co, rows_per_chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Output tiles of one launch (grid.x); the wrapper sizes its chunks by it.
extern "C" int yolodl_wgrad_db_tiles(int ci, int co, int k) {
  if (ci <= 0 || co <= 0 || (k != 1 && k != 3 && k != 5)) return -1;
  const int ci_t = ci_tile_of(k);
  return ((ci + ci_t - 1) / ci_t) * ((co + CO_T - 1) / CO_T);
}

// xp [b, h+k-1, w+k-1, ci] and g [b, h, w, co], contiguous NHWC, f32 (dtype 0)
// or bf16 (dtype 1); partial: f32 scratch of b*ceil(h/rows_per_chunk)*k*k*ci*co
// elements; out: [k, k, ci, co] f32.  Launches both kernels on `stream` and
// returns cudaGetLastError() (0 when both launches were accepted).  Does not
// synchronise and allocates nothing.
extern "C" int yolodl_wgrad_db(const void* xp, const void* g, float* partial, float* out,
                               int dtype, int b, int h, int w, int ci, int co, int k,
                               int rows_per_chunk, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || ci <= 0 || co <= 0 || rows_per_chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_k<float>(xp, g, partial, out, b, h, w, ci, co, k, rows_per_chunk, s);
  if (dtype == 1)
    return launch_k<__nv_bfloat16>(xp, g, partial, out, b, h, w, ci, co, k, rows_per_chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
