// Weight gradient of a stride-1 "same" convolution from pre-padded input,
// all taps packed into one contraction operand:
//
//   dW[u, v, ci, co] = sum_{b,h,w} xp[b, h+u, w+v, ci] * g[b, h, w, co]
//
// xp [B, H+k-1, W+k-1, Ci] and g [B, H, W, Co], NHWC, both bf16 or both f32;
// dW [k, k, Ci, Co] f32 (HWIO).  k is odd, at most 7.
//
// Replaces yolodl_tpu/kernels/wgrad_pallas.py:_wgrad_kernel (reached through
// wgrad_lowch and the custom-vjp conv conv2d_lowch).  Like the TPU kernel it
// packs all k*k taps into one contraction: packed row j = (u*k + v)*Ci + ci,
// so dW is one [k*k*Ci] x [Co] product whose contraction runs over the
// B*H*W output positions.  That is what serves a low channel count: the
// stem's 27 packed rows fill two 16-row MMA tiles, where one tile per tap
// would be nine, mostly padding.
//
// Bound on an H100: the bytes of xp and g read once plus dW written once,
// at 3.35 TB/s, against 2*B*H*W*k*k*Ci*Co flops at 989 TFLOP/s for bf16
// inputs (tensor cores) or 67 TFLOP/s for f32.  At b8 in bf16: 304^2 32->64
// k3 is 42.6 us and 608^2 3->32 k3 61.8 us, both by bytes.  The design for
// bf16 (wgrad_common.cuh holds the ring, the fragment loads and the
// epilogue):
//
// * One block owns the whole [k*k*Ci, Co] output where its accumulators fit
//   72 (16 warps) or 144 (8 warps) registers a thread (up to 576 x 64 or
//   256 x 128), so xp and g are
//   read from device memory once; the contraction is cut into at most one
//   chunk per SM, each a run of output rows of one column strip of one image.
// * Whole row strips arrive through the ring of wgrad_common.cuh; each new
//   output row brings one new xp row and one g row.
// * The packed im2col operand is formed in shared memory, once per xp row:
//   when row r of the halo arrives, the threads expand it into
//   expanded[position][v*Ci + ci] = xp[r][position + v][ci] (16 bytes at a
//   time where Ci is a multiple of 8, else by element), one of a ring of
//   k + 1 expanded rows.  The packed operand of an output row is then the k
//   expanded rows u = 0..k-1 side by side: packed row u*(k*Ci) + v*Ci + ci,
//   each row's k*Ci padded to a multiple of 8 so that an 8-row fragment
//   never straddles two of them (the stem: 3 x 16 rows for its 27).  Rows
//   are padded to an odd number of 16-byte pieces so that ldmatrix meets no
//   bank conflict.  One barrier a row.  With one tap (k = 1) and Ci a
//   multiple of 8 the packed operand is the staged strip itself, and is read
//   where it lies.
// * The warps tile the output with mma.sync.m16n8k16 (16 warps; 8 warps of
//   144 x 32 tiles where ldmatrix reads both operands), A fragments
//   from the expanded rows and B fragments from the staged g row, both by
//   ldmatrix.trans.
// * Partials [chunks, k*k*Ci, Co] and a second kernel that adds them in a
//   fixed order: no atomics, two launches give the same bits.
//
// f32 inputs keep f32 FMA on CUDA cores (one TF32 pass over 739,328 terms
// would err by about 3e-4 of max|dW|): the synchronous kernel below.

#include "wgrad_common.cuh"

namespace {

using namespace wgrad;

// ------------------------------------------------------------------ bf16

template <int MT, int NT, bool A_TMA_, bool B_TMA_, int WARPS_ = MAX_WARPS>
struct LowchRow {
  static constexpr int WARPS = WARPS_;
  static constexpr int THREADS = WARPS_ * 32;
  static constexpr int NACC = MT * NT * 4;
  static constexpr bool A_TMA = A_TMA_;
  static constexpr bool B_TMA = B_TMA_;
  static constexpr bool HOLDS_ROWS = false;  // a stage is done once its row is expanded
  static constexpr int UNIT = A_TMA_ ? 8 : 1;  // channels moved by one copy

  int wm_i, wn_i, wk_i;
  bool active;
  bool in_place;  // one tap of boxed channels: the staged strip is the packed operand
  GFragments<NT, B_TMA_> gf;
  int kc_pad;                      // packed rows of one kernel row u, a multiple of 8
  int au[MT];                      // the kernel row u of the lane's 8 packed rows per m16 tile
  uint32_t acol[MT];               // and their byte column in the expanded row
  uint32_t abox[MT], ain_row[MT];  // in place: the lane's channel part per m16 tile
  // expanding: this thread's (v, channel unit) when all of them fit the
  // block once (n_item <= 512), and the positions it then walks
  int n_item, p_first, p_step;
  int my_v, my_ch;
  uint32_t my_dst;
  uint32_t ebuf0;

  __device__ __forceinline__ void init(const Plan& P, const Block& q, int warp, int lane) {
    const int* v = P.v;
    const int k = v[P_K];
    const int group = v[P_WM] * v[P_WN];
    wk_i = warp / group;
    wm_i = (warp % group) / v[P_WN];
    wn_i = warp % v[P_WN];
    active = wk_i < v[P_WK];
    in_place = A_TMA_ && k == 1;
    gf.init(P, q, wn_i * NT * 8, lane);
    kc_pad = (k * q.cin + 7) / 8 * 8;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      int j = (wm_i * MT + i) * 16 + a_lane_ch(lane);  // the lane's first packed row
      if (j >= k * kc_pad) j = 0;                      // rows that are never stored
      au[i] = j / kc_pad;
      acol[i] = (j % kc_pad) * 2;
      if (A_TMA_) {
        const Boxed xb(v[P_CBOX], v[P_XBOX_STRIDE]);
        const int c = j < q.cin ? j : 0;
        abox[i] = xb.box_of(c);
        ain_row[i] = xb.in_row(c);
      }
    }
    const int tid = warp * 32 + lane;
    const int units = q.cin / UNIT;
    n_item = k * units;
    p_step = n_item <= THREADS ? THREADS / n_item : 0;
    p_first = p_step > 0 ? tid / n_item : 0;
    decode(p_step > 0 ? tid % n_item : 0, units, q.cin);
    ebuf0 = x_slot(q, v[P_STAGES]);
  }

  // item = v * units + unit
  __device__ __forceinline__ void decode(int item, int units, int cin) {
    my_v = item / units;
    my_ch = (item % units) * UNIT;
    my_dst = (my_v * cin + my_ch) * 2;
  }

  // expanded[pos][v * cin + c] = staged xp row [pos + v][c] for this
  // thread's (v, unit)
  __device__ __forceinline__ void expand_one(const Plan& P, const Block& q, uint32_t ebuf,
                                             uint32_t slot, uint32_t off, int pos) const {
    const uint32_t dst = ebuf + pos * P.v[P_EROW] + my_dst;
    if (A_TMA_) {
      const Boxed xb(P.v[P_CBOX], P.v[P_XBOX_STRIDE]);
      sts_u128(dst, lds_u128(xb.at(slot + xb.box_of(my_ch), xb.in_row(my_ch), pos + my_v)));
    } else {
      sts_u16(dst, lds_u16(slot + off + ((pos + my_v) * P.v[P_CI] + q.ci0 + my_ch) * 2));
    }
  }

  __device__ __forceinline__ void mma_step(float* acc, const uint32_t (*bfr)[2],
                                           const uint32_t* a0, uint32_t step) const {
    uint32_t a[2][4];
    ldmatrix_x4_trans(a[0][0], a[0][1], a[0][2], a[0][3], a0[0] + step);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i + 1 < MT)  // ahead of the MMAs
        ldmatrix_x4_trans(a[(i + 1) & 1][0], a[(i + 1) & 1][1], a[(i + 1) & 1][2],
                          a[(i + 1) & 1][3], a0[(i + 1) % MT] + step);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_bf16(&acc[(i * NT + j) * 4], a[i & 1], bfr[j][0], bfr[j][1]);
    }
  }

  // Stage t brings xp row t of the chunk and, from t = k - 1 on, the g row of
  // output row t - (k - 1).  The xp row is expanded once, into slot
  // t % (k + 1) of a ring of k + 1 expanded rows: one barrier a stage.
  __device__ __forceinline__ void row(float* acc, const Plan& P, const Block& q, int t, int warp,
                                      int lane) {
    const int* v = P.v;
    const int k = v[P_K], S = v[P_STAGES];
    const uint32_t gs = g_slot(P, q, t % S);
    uint32_t a0[MT];
    if (in_place) {
      if (!active) return;
      const Boxed xb(v[P_CBOX], v[P_XBOX_STRIDE]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
        a0[i] = xb.at(x_slot(q, t % S) + abox[i], ain_row[i], a_lane_pos(lane));
      gf.begin_row(P, gs, lane);
      for (int ks = wk_i; ks < q.nks; ks += v[P_WK]) {
        uint32_t bfr[NT][2];
        gf.load(bfr, P, q, gs, 0u, ks * 16, lane);
        mma_step(acc, bfr, a0, ks * 16 * xb.row_bytes);
      }
      return;
    }
    const int n_pos = q.nks * 16;
    {
      const uint32_t ebuf = ebuf0 + (t % (k + 1)) * v[P_EBUF_BYTES];
      const uint32_t slot = x_slot(q, t % S);
      const uint32_t off = A_TMA_ ? 0u : xp_span_offset(P, q, q.h_begin + t);
      if (p_step > 0) {
        if (p_first < p_step)
          for (int p = p_first; p < n_pos; p += p_step) expand_one(P, q, ebuf, slot, off, p);
      } else {
        for (int e = warp * 32 + lane; e < n_item * n_pos; e += THREADS) {
          decode(e % n_item, q.cin / UNIT, q.cin);
          expand_one(P, q, ebuf, slot, off, e / n_item);
        }
      }
    }
    consumer_sync(THREADS);  // row t is expanded; every warp is done with the MMAs of stage t - 1
    if (t < k - 1 || !active) return;
    const int first = t - (k - 1);
    const uint32_t goff = B_TMA_ ? 0u : g_span_offset(P, q, q.h_begin + first);
    gf.begin_row(P, gs, lane);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      a0[i] = ebuf0 + ((first + au[i]) % (k + 1)) * v[P_EBUF_BYTES] +
              a_lane_pos(lane) * v[P_EROW] + acol[i];
    for (int ks = wk_i; ks < q.nks; ks += v[P_WK]) {
      uint32_t bfr[NT][2];
      gf.load(bfr, P, q, gs, goff, ks * 16, lane);
      mma_step(acc, bfr, a0, ks * 16 * v[P_EROW]);
    }
  }

  __device__ __forceinline__ void store(const float* acc, float* out, const Plan& P,
                                        const Block& q, int warp, int lane) const {
    if (!active || wk_i != 0) return;
    const int ci = P.v[P_CI], co = P.v[P_CO], k = P.v[P_K];
    const int kc = k * q.cin;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // packed row m = u * kc_pad + v * cin + c  ->  dW row (u * k + v) * Ci + ci0 + c
        store_tile(&acc[(i * NT + j) * 4], out, q, co, (wm_i * MT + i) * 16, (wn_i * NT + j) * 8,
                   lane, [&](int m) -> long long {
                     const int u = m / kc_pad, r = m % kc_pad;
                     if (u >= k || r >= kc) return -1;
                     return static_cast<long long>(u * k + r / q.cin) * ci + q.ci0 + r % q.cin;
                   });
      }
    }
  }
};

template <int MT, int NT, bool A, bool B, int WARPS = MAX_WARPS>
int launch_tile(const void* xp, const void* g, float* partial, float* out, const Plan& P,
                cudaStream_t s) {
  if (P.v[P_WARPS] != WARPS) return static_cast<int>(cudaErrorInvalidValue);
  return launch_ring(wgrad_ring_kernel<LowchRow<MT, NT, A, B, WARPS>>, xp, g, partial, out, P, s);
}

template <bool A, bool B>
int launch_tiles(const void* xp, const void* g, float* partial, float* out, const Plan& P,
                 cudaStream_t s) {
  const int mt = P.v[P_MT], nt = P.v[P_NT];
  if (mt == 9 && nt == 2) return launch_tile<9, 2, A, B>(xp, g, partial, out, P, s);
  if (mt == 3 && nt == 4) return launch_tile<3, 4, A, B>(xp, g, partial, out, P, s);
  if (mt == 4 && nt == 4) return launch_tile<4, 4, A, B>(xp, g, partial, out, P, s);
  if (mt == 2 && nt == 4) return launch_tile<2, 4, A, B>(xp, g, partial, out, P, s);
  if (mt == 2 && nt == 2) return launch_tile<2, 2, A, B>(xp, g, partial, out, P, s);
  if (mt == 1 && nt == 2) return launch_tile<1, 2, A, B>(xp, g, partial, out, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_bf16(const void* xp, const void* g, float* partial, float* out, const Plan& P,
                cudaStream_t s) {
  const bool a = P.v[P_A_TMA] != 0, b = P.v[P_B_TMA] != 0;
  if (a && b && P.v[P_MT] == 9 && P.v[P_NT] == 4)  // 8 warps, 144 accumulators
    return launch_tile<9, 4, true, true, 8>(xp, g, partial, out, P, s);
  if (a && b) return launch_tiles<true, true>(xp, g, partial, out, P, s);
  if (a) return launch_tiles<true, false>(xp, g, partial, out, P, s);
  if (b) return launch_tiles<false, true>(xp, g, partial, out, P, s);
  return launch_tiles<false, false>(xp, g, partial, out, P, s);
}

// ------------------------------------------------------------------- f32
//
// grid.x walks output tiles of up to 64 packed rows (all k*k taps of
// ci_t = 64/(k*k) input channels) by 64 output channels; grid.y walks
// contraction chunks, each a run of output rows of one image.  A block
// stages sub-tiles of 2 output rows x 32 columns synchronously; each of the
// 256 threads owns 4 packed rows x 4 output channels in registers.

constexpr int TX = 16;              // threads along output channels
constexpr int TY = 16;              // threads along packed rows
constexpr int F_THREADS = TX * TY;
constexpr int RK = 4;               // packed rows per thread
constexpr int RC = 4;               // output channels per thread
constexpr int J_T = TY * RK;        // packed rows per tile (64)
constexpr int CO_T = TX * RC;       // output channels per tile (64)
constexpr int R = 2;                // output rows per sub-tile
constexpr int TW = 32;              // output columns per sub-tile
constexpr int MAX_K = 7;
// halo capacity: (R+k-1)*(TW+k-1)*ci_t with ci_t = J_T/(k*k); largest at k=1
constexpr int XS_CAP = R * TW * J_T;

__host__ __device__ inline int ci_per_tile(int ci, int k) {
  int t = J_T / (k * k);
  if (t < 1) t = 1;
  return t < ci ? t : ci;
}

__global__ void __launch_bounds__(F_THREADS)
wgrad_lowch_f32_kernel(const float* __restrict__ xp, const float* __restrict__ g,
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
      for (int e = tid; e < n_x; e += F_THREADS) {
        const int c = e % ci_n;
        const int p = (e / ci_n) % hpix;
        const int r = e / (ci_n * hpix);
        const long long src =
            ((static_cast<long long>(b) * hp + h0 + r) * wp + w0 + p) * ci + ci0 + c;
        xs[(r * hw_cap + p) * ci_t + c] = xp[src];
      }
      const int n_g = rv * wv * CO_T;
      for (int e = tid; e < n_g; e += F_THREADS) {
        const int cc = e % CO_T;
        const int pos = e / CO_T;
        const int r = pos / wv;
        const int c = pos % wv;
        float v = 0.0f;
        if (cc < co_n) {
          const long long src =
              ((static_cast<long long>(b) * h + h0 + r) * w + w0 + c) * co + co0 + cc;
          v = g[src];
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

int launch_f32(const float* xp, const float* g, float* partial, float* out, int b, int h, int w,
               int ci, int co, int k, int rows_per_chunk, cudaStream_t stream) {
  const int ci_t = ci_per_tile(ci, k);
  const int tiles = ((ci + ci_t - 1) / ci_t) * ((co + CO_T - 1) / CO_T);
  const int chunks_per_image = (h + rows_per_chunk - 1) / rows_per_chunk;
  const long long chunks = static_cast<long long>(b) * chunks_per_image;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  wgrad_lowch_f32_kernel<<<dim3(tiles, static_cast<unsigned>(chunks)), dim3(TX, TY), 0, stream>>>(
      xp, g, partial, h, w, ci, co, k, ci_t, rows_per_chunk, chunks_per_image);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(k) * k * ci * co;
  reduce_slices_kernel<<<static_cast<unsigned>((n + 31) / 32), dim3(32, 32), 0, stream>>>(
      partial, out, static_cast<int>(chunks), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: xp [b, h+k-1, w+k-1, ci] and g [b, h, w, co], contiguous NHWC, both
// pointers 16-byte aligned and readable up to the next multiple of 16 bytes
// past their end; plan: the n_plan integers of wgrad_plan("lowch", ...) in
// the order of wgrad::PlanField (b, h, w may be a view of the positions when
// k = 1); partial: f32 scratch of plan[slices]*k*k*ci*co elements; out:
// [k, k, ci, co] f32.  Launches both kernels on `stream` and returns
// cudaGetLastError() (0 when both launches were accepted).  Does not
// synchronise and allocates nothing.
extern "C" int yolodl_wgrad_lowch_bf16(const void* xp, const void* g, float* partial, float* out,
                                       const int* plan, int n_plan, void* stream) {
  if (n_plan != wgrad::P_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  wgrad::Plan P;
  for (int i = 0; i < wgrad::P_COUNT; ++i) P.v[i] = plan[i];
  const int k = P.v[wgrad::P_K];
  if (!wgrad::plan_is_sane(P) || k < 1 || k > MAX_K || k % 2 == 0 || P.v[wgrad::P_WTAP] != 1 ||
      P.v[wgrad::P_EROW] % 16 != 0 ||
      (P.v[wgrad::P_EROW] < 16 && !(k == 1 && P.v[wgrad::P_A_TMA])))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16(xp, g, partial, out, P, static_cast<cudaStream_t>(stream));
}

// f32: the same operands in f32; partial: b*ceil(h/rows_per_chunk)*k*k*ci*co
// f32 elements.
extern "C" int yolodl_wgrad_lowch_f32(const void* xp, const void* g, float* partial, float* out,
                                      int b, int h, int w, int ci, int co, int k,
                                      int rows_per_chunk, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || ci <= 0 || co <= 0 || rows_per_chunk <= 0 || k <= 0 ||
      k > MAX_K || k % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32(static_cast<const float*>(xp), static_cast<const float*>(g), partial, out, b,
                    h, w, ci, co, k, rows_per_chunk, static_cast<cudaStream_t>(stream));
}
