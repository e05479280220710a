// Weight gradient of a stride-1 "same" convolution from pre-padded input:
//
//   dW[u, v, ci, co] = sum_{b,h,w} xp[b, h+u, w+v, ci] * g[b, h, w, co]
//
// xp [B, H+k-1, W+k-1, Ci] and g [B, H, W, Co], NHWC, both bf16 or both f32;
// dW [k, k, Ci, Co] f32 (HWIO).
//
// Replaces yolodl_tpu/kernels/wgrad_pallas.py:_wgrad_kernel (reached through
// wgrad_lowch and the custom-vjp conv conv2d_lowch).  Like the TPU kernel it
// packs all k*k taps into one contraction: packed row j = (u*k + v)*Ci + ci,
// so dW is a [k*k*Ci] x [Co] product whose contraction runs over the
// B*H*W output positions, and the im2col operand is formed on the fly from a
// halo staged in on-chip memory.
//
// Bound on an H100: the bytes of xp and g read once plus dW written once,
// at 3.35 TB/s, against 2*B*H*W*k*k*Ci*Co flops at 989 TFLOP/s for bf16
// inputs (tensor cores) or 67 TFLOP/s for f32.  At b8: 304^2 32->64 k3 is
// 42.6 us (bytes: 143 MB), 608^2 3->32 k3 61.8 us (bytes: 207 MB), 152^2
// 64->64 k3 14.3 us (balanced: 48 MB, 13.6 GFLOP).  The output is small
// (288 x 64 for 32->64 k3) and the contraction huge (739,328 at 304^2 b8),
// so the design splits the contraction across blocks to fill the SMs:
//
// * grid.x walks output tiles of up to 64 packed rows (all k*k taps of
//   ci_t = 64/(k*k) input channels) by 64 output channels; grid.y walks
//   contraction chunks, each a run of output rows of one image.
// * A block stages sub-tiles of 2 output rows x 32 columns: the
//   (2+k-1) x (32+k-1) x ci_t halo of xp and the 64-position x 64-channel
//   tile of g, both converted to f32 in shared memory.  Loads are
//   synchronous (the double-buffered variant is wgrad_db.cu).
// * Each of the 256 threads owns 4 packed rows x 4 output channels in
//   registers and accumulates with f32 FMA on CUDA cores; per position it
//   reads 4 halo values and one float4 of g from shared memory.
// * Determinism: every block writes its partial sums to its own slice of a
//   scratch tensor [chunks, k*k*Ci, Co]; a second kernel adds the chunks in
//   a fixed order.  No atomics, so two runs give the same bits.
//
// Nothing but the partials is written to device memory.  The f32 sums take
// another order than the plain version (yolodl_torch/kernels/wgrad_lowch.py
// wgrad_lowch_reference), so the two agree to a relative tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 16;              // threads along output channels
constexpr int TY = 16;              // threads along packed rows
constexpr int THREADS = TX * TY;
constexpr int RK = 4;               // packed rows per thread
constexpr int RC = 4;               // output channels per thread
constexpr int J_T = TY * RK;        // packed rows per tile (64)
constexpr int CO_T = TX * RC;       // output channels per tile (64)
constexpr int R = 2;                // output rows per sub-tile
constexpr int TW = 32;              // output columns per sub-tile
constexpr int MAX_K = 7;
// halo capacity: (R+k-1)*(TW+k-1)*ci_t with ci_t = J_T/(k*k); largest at k=1
constexpr int XS_CAP = R * TW * J_T;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ inline int ci_per_tile(int ci, int k) {
  int t = J_T / (k * k);
  if (t < 1) t = 1;
  return t < ci ? t : ci;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_lowch_kernel(const T* __restrict__ xp, const T* __restrict__ g,
                   float* __restrict__ partial, int h, int w, int ci, int co,
                   int k, int ci_t, int rows_per_chunk, int chunks_per_image) {
  __shared__ float xs[XS_CAP];
  __shared__ __align__(16) float gs[R * TW * CO_T];

  const int hp = h + k - 1;
  const int wp = w + k - 1;
  const int hw_cap = TW + k - 1;  // halo pixels per staged row
  const int kk = k * k;
  const int ci_tiles = (ci + ci_t - 1) / ci_t;
  const int ci0 = (blockIdx.x % ci_tiles) * ci_t;
  const int co0 = (blockIdx.x / ci_tiles) * CO_T;
  const int ci_n = min(ci_t, ci - ci0);
  const int co_n = min(CO_T, co - co0);
  const int chunk = blockIdx.y;
  const int b = chunk / chunks_per_image;
  const int h_begin = (chunk % chunks_per_image) * rows_per_chunk;
  const int h_end = min(h_begin + rows_per_chunk, h);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;

  // packed row j = tap*ci_t + c of this tile -> its operand's offset in xs
  // relative to the position's own pixel
  int xoff[RK];
  bool jvalid[RK];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int j = ty * RK + i;
    const int t = j / ci_t;
    const int c = j % ci_t;
    jvalid[i] = t < kk && c < ci_n;
    xoff[i] = jvalid[i] ? ((t / k) * hw_cap + (t % k)) * ci_t + c : 0;
  }
  float acc[RK][RC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int q = 0; q < RC; ++q) acc[i][q] = 0.0f;

  for (int h0 = h_begin; h0 < h_end; h0 += R) {
    const int rv = min(R, h_end - h0);
    for (int w0 = 0; w0 < w; w0 += TW) {
      const int wv = min(TW, w - w0);
      __syncthreads();  // the previous sub-tile has been read
      const int hrows = rv + k - 1;
      const int hpix = wv + k - 1;
      const int n_x = hrows * hpix * ci_n;
      for (int e = tid; e < n_x; e += THREADS) {
        const int c = e % ci_n;
        const int p = (e / ci_n) % hpix;
        const int r = e / (ci_n * hpix);
        const long long src =
            ((static_cast<long long>(b) * hp + h0 + r) * wp + w0 + p) * ci + ci0 + c;
        xs[(r * hw_cap + p) * ci_t + c] = to_f32(xp[src]);
      }
      const int n_g = rv * wv * CO_T;
      for (int e = tid; e < n_g; e += THREADS) {
        const int cc = e % CO_T;
        const int pos = e / CO_T;
        const int r = pos / wv;
        const int c = pos % wv;
        float v = 0.0f;
        if (cc < co_n) {
          const long long src =
              ((static_cast<long long>(b) * h + h0 + r) * w + w0 + c) * co + co0 + cc;
          v = to_f32(g[src]);
        }
        gs[(r * TW + c) * CO_T + cc] = v;
      }
      __syncthreads();

      for (int r = 0; r < rv; ++r) {
        for (int c = 0; c < wv; ++c) {
          const float4 gv =
              *reinterpret_cast<const float4*>(&gs[(r * TW + c) * CO_T + tx * RC]);
          const float* xb = &xs[(r * hw_cap + c) * ci_t];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            const float xv = xb[xoff[i]];
            acc[i][0] = __fmaf_rn(xv, gv.x, acc[i][0]);
            acc[i][1] = __fmaf_rn(xv, gv.y, acc[i][1]);
            acc[i][2] = __fmaf_rn(xv, gv.z, acc[i][2]);
            acc[i][3] = __fmaf_rn(xv, gv.w, acc[i][3]);
          }
        }
      }
    }
  }

  // this block's slice of partial[chunk][j = tap*Ci + ci][co]
  float* out = partial + static_cast<long long>(chunk) * kk * ci * co;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    if (!jvalid[i]) continue;
    const int j = ty * RK + i;
    const int row = (j / ci_t) * ci + ci0 + j % ci_t;
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      const int cc = tx * RC + q;
      if (cc < co_n) out[static_cast<long long>(row) * co + co0 + cc] = acc[i][q];
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

template <typename T>
int launch(const void* xp, const void* g, float* partial, float* out, int b, int h,
           int w, int ci, int co, int k, int rows_per_chunk, cudaStream_t stream) {
  const int ci_t = ci_per_tile(ci, k);
  const int tiles = ((ci + ci_t - 1) / ci_t) * ((co + CO_T - 1) / CO_T);
  const int chunks_per_image = (h + rows_per_chunk - 1) / rows_per_chunk;
  const long long chunks = static_cast<long long>(b) * chunks_per_image;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  wgrad_lowch_kernel<T><<<dim3(tiles, static_cast<unsigned>(chunks)), dim3(TX, TY), 0,
                          stream>>>(static_cast<const T*>(xp), static_cast<const T*>(g),
                                    partial, h, w, ci, co, k, ci_t, rows_per_chunk,
                                    chunks_per_image);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(k) * k * ci * co;
  reduce_chunks_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      partial, out, static_cast<int>(chunks), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Output tiles of one launch (grid.x); the wrapper sizes its chunks by it.
extern "C" int yolodl_wgrad_lowch_tiles(int ci, int co, int k) {
  if (ci <= 0 || co <= 0 || k <= 0 || k > MAX_K) return -1;
  const int ci_t = ci_per_tile(ci, k);
  return ((ci + ci_t - 1) / ci_t) * ((co + CO_T - 1) / CO_T);
}

// xp [b, h+k-1, w+k-1, ci] and g [b, h, w, co], contiguous NHWC, f32 (dtype 0)
// or bf16 (dtype 1); partial: f32 scratch of b*ceil(h/rows_per_chunk)*k*k*ci*co
// elements; out: [k, k, ci, co] f32.  Launches both kernels on `stream` and
// returns cudaGetLastError() (0 when both launches were accepted).  Does not
// synchronise and allocates nothing.
extern "C" int yolodl_wgrad_lowch(const void* xp, const void* g, float* partial,
                                  float* out, int dtype, int b, int h, int w, int ci,
                                  int co, int k, int rows_per_chunk, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || ci <= 0 || co <= 0 || rows_per_chunk <= 0 ||
      k <= 0 || k > MAX_K || k % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xp, g, partial, out, b, h, w, ci, co, k, rows_per_chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xp, g, partial, out, b, h, w, ci, co, k, rows_per_chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
