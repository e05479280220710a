// Weight gradient of a stride-1 "same" convolution from pre-padded input,
// staged through an asynchronous ring and accumulated tap by tap:
//
//   dW[u, v, ci, co] = sum_{b,h,w} xp[b, h+u, w+v, ci] * g[b, h, w, co]
//
// xp [B, H+k-1, W+k-1, Ci] and g [B, H, W, Co], NHWC, both bf16 or both f32;
// dW [k, k, Ci, Co] f32 (HWIO).  k is 1, 3 or 5.
//
// Replaces yolodl_tpu/kernels/wgrad_db.py:_wgrad_db_kernel (reached through
// wgrad_db and the custom-vjp conv conv2d_db).  What distinguished that
// kernel from _wgrad_kernel carries over: the next rows are copied while the
// present ones are multiplied, and each tap keeps its own accumulator.
//
// Bound on an H100: the bytes of xp and g read once plus dW written once,
// at 3.35 TB/s, against 2*B*H*W*k*k*Ci*Co flops at 989 TFLOP/s for bf16
// inputs (tensor cores) or 67 TFLOP/s for f32: 42.6 us for 304^2 32->64 k3
// at b8 in bf16, by bytes.  The design for bf16 (wgrad_common.cuh holds the
// ring, the fragment loads and the epilogue):
//
// * One block owns the whole [k*k*Ci, Co] output where its accumulators fit
//   72 (16 warps) or 144 (8 warps) registers a thread, so xp and g are read
//   from device memory once;
//   the contraction is cut into at most one chunk per SM, each a run of
//   output rows of one column strip of one image.
// * A producer thread keeps whole row strips in flight (TMA boxes or one
//   bulk copy per row, reporting to mbarriers) in a ring of k + 2 to 8
//   stages; each new output row brings one new xp row and one g row.
// * The warps tile the output; a warp holds one accumulator per tap (up to
//   9 taps of a 16 x 16 tile: 72 registers; where ldmatrix reads both
//   operands and k > 1, 8 warps of 255 registers hold 16 x 32 tiles, so a
//   fragment read from shared memory serves twice the MMAs) and multiplies
//   with mma.sync.m16n8k16.  A tap's operand is the staged xp row u at a column
//   shifted by v: ldmatrix.trans reads it where it lies, nothing is packed.
//   A channel count that is no multiple of 8 (the stem's 3) cannot be read
//   by ldmatrix: those fragments are gathered by 16-bit shared loads.
// * Partials [chunks, k*k*Ci, Co] and a second kernel that adds them in a
//   fixed order: no atomics, two launches give the same bits.
//
// f32 inputs keep f32 FMA on CUDA cores (one TF32 pass over 739,328 terms
// would err by about 3e-4 of max|dW|): the cp.async double-buffered kernel
// below, unchanged in its arithmetic.

#include <cuda_pipeline.h>

#include "wgrad_common.cuh"

namespace {

using namespace wgrad;

// ------------------------------------------------------------------ bf16

template <int MT, int NT, int TAPS, bool A_TMA_, bool B_TMA_, int WARPS_ = MAX_WARPS>
struct DbRow {
  static constexpr int WARPS = WARPS_;
  static constexpr int NACC = TAPS * MT * NT * 4;
  static constexpr bool A_TMA = A_TMA_;
  static constexpr bool B_TMA = B_TMA_;
  static constexpr bool HOLDS_ROWS = true;  // taps read the staged xp rows where they lie

  int wm_i, wn_i, tg, wk_i;
  bool active;
  GFragments<NT, B_TMA_> gf;
  uint32_t abox[MT], ain_row[MT];  // boxed xp: the lane's channel part per m16 tile

  __device__ __forceinline__ void init(const Plan& P, const Block& q, int warp, int lane) {
    const int* v = P.v;
    const int group = v[P_WM] * v[P_WN] * v[P_WTAP];
    wk_i = warp / group;
    const int r = warp % group;
    tg = r / (v[P_WM] * v[P_WN]);
    wm_i = (r % (v[P_WM] * v[P_WN])) / v[P_WN];
    wn_i = r % v[P_WN];
    active = wk_i < v[P_WK];
    gf.init(P, q, wn_i * NT * 8, lane);
    if (A_TMA_) {
      const Boxed xb(v[P_CBOX], v[P_XBOX_STRIDE]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        int c = (wm_i * MT + i) * 16 + a_lane_ch(lane);
        if (c >= q.cin) c = 0;  // rows that are never stored
        abox[i] = xb.box_of(c);
        ain_row[i] = xb.in_row(c);
      }
    }
  }

  // stage t holds the g row; stages t-k+1 .. t the xp rows u = 0 .. k-1
  __device__ __forceinline__ void row(float* acc, const Plan& P, const Block& q, int t, int warp,
                                      int lane) {
    const int* v = P.v;
    const int k = v[P_K], kk = k * k, S = v[P_STAGES];
    if (!active || t < k - 1) return;
    const int first = t - (k - 1);
    const uint32_t gs = g_slot(P, q, t % S);
    const uint32_t goff = B_TMA_ ? 0u : g_span_offset(P, q, q.h_begin + first);
    gf.begin_row(P, gs, lane);
    const Boxed xb(A_TMA_ ? v[P_CBOX] : 8, v[P_XBOX_STRIDE]);
    const int x_valid = min(v[P_WT] + k - 1, v[P_W] + k - 1 - q.w0);
    // Per tap.  Boxed: the lane's address for positions v..v+15 of xp row u,
    // per m16 tile (a step of 16 positions adds 16 rows of the box and leaves
    // the swizzle as it is).  Span: slot address | v << 20 | (offset / 2) << 24.
    uint32_t a0[TAPS * MT];
    uint32_t code[TAPS];
    const int s_first = first % S;
#pragma unroll
    for (int tp = 0; tp < TAPS; ++tp) {
      const int tap = min(tg * TAPS + tp, kk - 1);
      const int u = tap / k, vv = tap % k;
      const int s_u = s_first + u < S ? s_first + u : s_first + u - S;
      const uint32_t slot = x_slot(q, s_u);
      if (A_TMA_) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
          a0[tp * MT + i] = xb.at(slot + abox[i], ain_row[i], vv + a_lane_pos(lane));
      } else {
        code[tp] = slot | (vv << 20) |
                   ((xp_span_offset(P, q, q.h_begin + first + u) >> 1) << 24);
      }
    }
    // the A fragment of (tap, m16 tile) number `idx` at positions p0..p0+15
    auto load_a = [&](uint32_t* a, int idx, int p0) {
      if (A_TMA_) {
        ldmatrix_x4_trans(a[0], a[1], a[2], a[3], a0[idx] + p0 * xb.row_bytes);
      } else {
        const int tp = idx / MT, i = idx % MT;
        gather_a(a, (code[tp] & 0xFFFFFu) + ((code[tp] >> 24) << 1), v[P_CI], q.ci0, q.cin,
                 (wm_i * MT + i) * 16, p0 + ((code[tp] >> 20) & 7), x_valid, lane);
      }
    };
    // a tap beyond k*k (the last group of k = 5) repeats the last tap into
    // accumulators that are never stored
    for (int ks = wk_i; ks < q.nks; ks += v[P_WK]) {
      const int p0 = ks * 16;
      uint32_t bfr[NT][2];
      uint32_t a[2][4];
      gf.load(bfr, P, q, gs, goff, p0, lane);
      load_a(a[0], 0, p0);
#pragma unroll
      for (int idx = 0; idx < TAPS * MT; ++idx) {
        if (idx + 1 < TAPS * MT) load_a(a[(idx + 1) & 1], idx + 1, p0);  // ahead of the MMAs
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(&acc[(idx * NT + j) * 4], a[idx & 1], bfr[j][0], bfr[j][1]);
      }
    }
  }

  __device__ __forceinline__ void store(const float* acc, float* out, const Plan& P,
                                        const Block& q, int warp, int lane) const {
    if (!active || wk_i != 0) return;
    const int ci = P.v[P_CI], co = P.v[P_CO], kk = P.v[P_K] * P.v[P_K];
#pragma unroll
    for (int tp = 0; tp < TAPS; ++tp) {
      const int tap = tg * TAPS + tp;
      if (tap >= kk) continue;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          store_tile(&acc[((tp * MT + i) * NT + j) * 4], out, q, co, (wm_i * MT + i) * 16,
                     (wn_i * NT + j) * 8, lane, [&](int m) -> long long {
                       return m < q.cin ? static_cast<long long>(tap) * ci + q.ci0 + m : -1;
                     });
        }
      }
    }
  }
};

template <int MT, int NT, int TAPS, bool A, bool B, int WARPS = MAX_WARPS>
int launch_tile(const void* xp, const void* g, float* partial, float* out, const Plan& P,
                cudaStream_t s) {
  if (P.v[P_WARPS] != WARPS) return static_cast<int>(cudaErrorInvalidValue);
  return launch_ring(wgrad_ring_kernel<DbRow<MT, NT, TAPS, A, B, WARPS>>, xp, g, partial, out, P,
                     s);
}

template <bool A, bool B>
int launch_small(const void* xp, const void* g, float* partial, float* out, const Plan& P,
                 cudaStream_t s) {
  if (P.v[P_MT] != 1 || P.v[P_NT] != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (P.v[P_TAPS] == 1) return launch_tile<1, 2, 1, A, B>(xp, g, partial, out, P, s);
  if (P.v[P_TAPS] == 9) return launch_tile<1, 2, 9, A, B>(xp, g, partial, out, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_bf16(const void* xp, const void* g, float* partial, float* out, const Plan& P,
                cudaStream_t s) {
  const int* v = P.v;
  const bool a = v[P_A_TMA] != 0, b = v[P_B_TMA] != 0;
  if (a && b && v[P_TAPS] == 1) {
    if (v[P_MT] == 4 && v[P_NT] == 4) return launch_tile<4, 4, 1, true, true>(xp, g, partial, out, P, s);
    if (v[P_MT] == 2 && v[P_NT] == 4) return launch_tile<2, 4, 1, true, true>(xp, g, partial, out, P, s);
    if (v[P_MT] == 2 && v[P_NT] == 2) return launch_tile<2, 2, 1, true, true>(xp, g, partial, out, P, s);
  }
  if (a && b && v[P_TAPS] == 9 && v[P_MT] == 1 && v[P_NT] == 4)  // 8 warps, 144 accumulators
    return launch_tile<1, 4, 9, true, true, 8>(xp, g, partial, out, P, s);
  if (a && b) return launch_small<true, true>(xp, g, partial, out, P, s);
  if (a) return launch_small<true, false>(xp, g, partial, out, P, s);
  if (b) return launch_small<false, true>(xp, g, partial, out, P, s);
  return launch_small<false, false>(xp, g, partial, out, P, s);
}

// ------------------------------------------------------------------- f32
//
// grid.x walks output tiles of ci_t input channels (64 at k=1, 16 at k=3 and
// 5) by 64 output channels, all k*k taps; grid.y walks contraction chunks,
// each a run of output rows of one image.  A block walks its sub-tiles of 2
// output rows x 32 columns with a two-stage pipeline: cp.async copies the
// halo of xp and the g tile of sub-tile s+1 into one half of a double buffer
// while the threads compute sub-tile s from the other half.  Each of the 256
// threads owns rci input channels x 4 output channels for every tap.

constexpr int F_THREADS = 256;
constexpr int RC = 4;                 // output channels per thread
constexpr int CO_T = 64;              // output channels per tile
constexpr int QUADS = CO_T / RC;      // threads along output channels (16)
constexpr int GROUPS = F_THREADS / QUADS;  // threads along input channels (16)
constexpr int R = 2;                  // output rows per sub-tile
constexpr int TW = 32;                // output columns per sub-tile

__host__ __device__ constexpr int rci_of(int k) { return k == 1 ? 4 : 1; }
__host__ __device__ constexpr int ci_tile_of(int k) { return GROUPS * rci_of(k); }

__host__ __device__ inline int xs_floats(int k) {
  return (R + k - 1) * (TW + k - 1) * ci_tile_of(k);
}
constexpr int GS_FLOATS = R * TW * CO_T;

// Block-cooperative asynchronous copy of n_rows x n_cols spans of `len`
// floats: span (r, c) goes from src + r*src_rs + c*src_cs to
// dst + r*dst_rs + c*dst_cs, 16 bytes at a time where every address and the
// length allow it, else 4.
__device__ void stage_spans(float* dst, int dst_rs, int dst_cs, const float* src,
                            long long src_rs, long long src_cs, int n_rows, int n_cols, int len,
                            int tid) {
  const unsigned long long align =
      reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
      static_cast<unsigned long long>(dst_rs * 4) | static_cast<unsigned long long>(dst_cs * 4) |
      static_cast<unsigned long long>(src_rs * 4) | static_cast<unsigned long long>(src_cs * 4) |
      static_cast<unsigned long long>(len * 4);
  const int piece = (align & 15) == 0 ? 16 : 4;
  const int per_span = len * 4 / piece;
  const int n = n_rows * n_cols * per_span;
  for (int e = tid; e < n; e += F_THREADS) {
    const int s = e / per_span;
    const int off = (e % per_span) * piece;
    const int r = s / n_cols;
    const int c = s % n_cols;
    char* d = reinterpret_cast<char*>(dst + r * dst_rs + c * dst_cs) + off;
    const char* p = reinterpret_cast<const char*>(src + r * src_rs + c * src_cs) + off;
    if (piece == 16) {
      __pipeline_memcpy_async(d, p, 16);
    } else {
      __pipeline_memcpy_async(d, p, 4);
    }
  }
}

struct Geometry {
  int h, w, ci, co;
  int ci0, co0, ci_n, co_n;
  int b;
};

// Stage sub-tile (h0, rv rows; w0, wv columns) into one buffer.
template <int K>
__device__ void stage_subtile(const float* xp, const float* g, float* xs, float* gs,
                              const Geometry& q, int h0, int rv, int w0, int wv, int tid) {
  const int hp = q.h + K - 1;
  const int wp = q.w + K - 1;
  const int hw_cap = TW + K - 1;
  const int hrows = rv + K - 1;
  const int hpix = wv + K - 1;
  const float* xsrc = xp + ((static_cast<long long>(q.b) * hp + h0) * wp + w0) * q.ci + q.ci0;
  if (q.ci_n == q.ci) {  // whole pixels: one contiguous span per halo row
    stage_spans(xs, hw_cap * q.ci_n, 0, xsrc, static_cast<long long>(wp) * q.ci, 0, hrows, 1,
                hpix * q.ci, tid);
  } else {
    stage_spans(xs, hw_cap * q.ci_n, q.ci_n, xsrc, static_cast<long long>(wp) * q.ci, q.ci,
                hrows, hpix, q.ci_n, tid);
  }
  const float* gsrc = g + ((static_cast<long long>(q.b) * q.h + h0) * q.w + w0) * q.co + q.co0;
  if (q.co_n == q.co) {  // whole positions: one contiguous span per row
    stage_spans(gs, TW * q.co_n, 0, gsrc, static_cast<long long>(q.w) * q.co, 0, rv, 1,
                wv * q.co, tid);
  } else {
    stage_spans(gs, TW * q.co_n, q.co_n, gsrc, static_cast<long long>(q.w) * q.co, q.co, rv, wv,
                q.co_n, tid);
  }
}

template <int K>
__global__ void __launch_bounds__(F_THREADS)
wgrad_db_f32_kernel(const float* __restrict__ xp, const float* __restrict__ g,
                    float* __restrict__ partial, int h, int w, int ci, int co,
                    int rows_per_chunk, int chunks_per_image) {
  constexpr int KK = K * K;
  constexpr int RCI = rci_of(K);
  constexpr int CI_T = ci_tile_of(K);
  extern __shared__ __align__(16) unsigned char smem[];
  float* fs = reinterpret_cast<float*>(smem);
  const int xsf = xs_floats(K);
  float* xs_buf[2] = {fs, fs + xsf + GS_FLOATS};
  float* gs_buf[2] = {fs + xsf, fs + 2 * xsf + GS_FLOATS};

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
    stage_subtile<K>(xp, g, xs_buf[0], gs_buf[0], q, h_begin, min(R, h_end - h_begin), 0,
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
      stage_subtile<K>(xp, g, xs_buf[(s + 1) & 1], gs_buf[(s + 1) & 1], q, h1,
                       min(R, h_end - h1), w1, min(TW, w - w1), tid);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of sub-tile s have landed
    __syncthreads();           // and every other thread's

    const float* xs = xs_buf[s & 1];
    const float* gs = gs_buf[s & 1];
    for (int r = 0; r < rv; ++r) {
      for (int c = 0; c < wv; ++c) {
        const float* gp = gs + (r * TW + c) * q.co_n;
        float gv[RC];
#pragma unroll
        for (int j = 0; j < RC; ++j) gv[j] = gp[gidx[j]];
#pragma unroll
        for (int u = 0; u < K; ++u) {
#pragma unroll
          for (int v = 0; v < K; ++v) {
            const float* px = xs + ((r + u) * hw_cap + c + v) * q.ci_n;
#pragma unroll
            for (int i = 0; i < RCI; ++i) {
              const float xv = px[cidx[i]];
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

template <int K>
int launch_f32(const float* xp, const float* g, float* partial, float* out, int b, int h, int w,
               int ci, int co, int rows_per_chunk, cudaStream_t stream) {
  constexpr int CI_T = ci_tile_of(K);
  const int tiles = ((ci + CI_T - 1) / CI_T) * ((co + CO_T - 1) / CO_T);
  const int chunks_per_image = (h + rows_per_chunk - 1) / rows_per_chunk;
  const long long chunks = static_cast<long long>(b) * chunks_per_image;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = 2 * (xs_floats(K) + GS_FLOATS) * 4;
  cudaError_t err = cudaFuncSetAttribute(wgrad_db_f32_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_db_f32_kernel<K><<<dim3(tiles, static_cast<unsigned>(chunks)), F_THREADS, smem, stream>>>(
      xp, g, partial, h, w, ci, co, rows_per_chunk, chunks_per_image);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(K) * K * ci * co;
  reduce_slices_kernel<<<static_cast<unsigned>((n + 31) / 32), dim3(32, 32), 0, stream>>>(
      partial, out, static_cast<int>(chunks), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: xp [b, h+k-1, w+k-1, ci] and g [b, h, w, co], contiguous NHWC, both
// pointers 16-byte aligned and readable up to the next multiple of 16 bytes
// past their end; plan: the n_plan integers of wgrad_plan("db", ...) in the
// order of wgrad::PlanField (b, h, w may be a view of the positions when
// k = 1); partial: f32 scratch of plan[slices]*k*k*ci*co elements; out:
// [k, k, ci, co] f32.  Launches both kernels on `stream` and returns
// cudaGetLastError() (0 when both launches were accepted).  Does not
// synchronise and allocates nothing.
extern "C" int yolodl_wgrad_db_bf16(const void* xp, const void* g, float* partial, float* out,
                                    const int* plan, int n_plan, void* stream) {
  if (n_plan != wgrad::P_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  wgrad::Plan P;
  for (int i = 0; i < wgrad::P_COUNT; ++i) P.v[i] = plan[i];
  const int k = P.v[wgrad::P_K];
  if (!wgrad::plan_is_sane(P) || (k != 1 && k != 3 && k != 5) ||
      P.v[wgrad::P_STAGES] < k + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16(xp, g, partial, out, P, static_cast<cudaStream_t>(stream));
}

// f32: the same operands in f32; partial: b*ceil(h/rows_per_chunk)*k*k*ci*co
// f32 elements.
extern "C" int yolodl_wgrad_db_f32(const void* xp, const void* g, float* partial, float* out,
                                   int b, int h, int w, int ci, int co, int k,
                                   int rows_per_chunk, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || ci <= 0 || co <= 0 || rows_per_chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xp);
  const float* gg = static_cast<const float*>(g);
  switch (k) {
    case 1: return launch_f32<1>(x, gg, partial, out, b, h, w, ci, co, rows_per_chunk, s);
    case 3: return launch_f32<3>(x, gg, partial, out, b, h, w, ci, co, rows_per_chunk, s);
    case 5: return launch_f32<5>(x, gg, partial, out, b, h, w, ci, co, rows_per_chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
