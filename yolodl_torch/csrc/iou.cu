// Kernel B1 for Hopper: the IoU tile of NMS, and the greedy resolution that
// follows it.  Three kernels share the tile code:
//
// conflict_bits_kernel (the main path).  [B,K,4] TLBR boxes (f32 or bf16)
//   and [B,K] groups -> [B,K,W] 32-bit words, W = ceil(K/32).  Bit t of word
//   w in row j is conflict[b, j, 32w+t]:
//       iou'(j, i) > thr  &  group[j] == group[i]  &  j < i,
//   where iou' is the IoU, minus the DIoU penalty (d^2/c^2)^beta for kind
//   diou.  Every bit on or under the diagonal and past K is zero.  Replaces
//   the tile of yolodl_tpu/kernels/iou_pallas.py:32 (_iou_tile_kernel)
//   together with the conflict formula around it,
//   yolodl_tpu/loss/nms.py:86-101.
// keep_from_bits_kernel (the main path).  bits and valid [B,K] -> keep
//   [B,K], the unique solution of
//       keep[i] = valid[i] & for all j < i: !(keep[j] & conflict[j, i]).
//   Replaces the scan of yolodl_tpu/loss/nms.py:113-147 (a fori_loop over
//   blocks of 64 candidates with a while_loop fixed point inside each): an
//   XLA loop, not a Pallas kernel.
// iou_pairwise_kernel (kept off the main path).  [B,K,4] f32 -> the dense
//   [B,K,K] f32 IoU matrix of yolodl_tpu/kernels/iou_pallas.py:32.
//
// Why bits.  One bit per pair is 32x fewer bytes than one f32: at B=8,
// K=512 the conflict kernel writes 256 KB where the IoU matrix is 8.4 MB,
// and the K*W words of one image (32 KB at K=512, 128 KB at K=1000) fit in
// one SM's shared memory, so the resolution reads them there.  The
// threshold, the group test and the rank mask are applied where the IoU is
// computed, so no [B,K,K] tensor is ever written, and suppression is two
// launches with no host sync, whatever the depth of a suppression chain.
//
// What bounds each kernel on an H100.
// - conflict bits: instruction issue, and then launch latency.  At [8,512]
//   with diou it reads 64 KB of boxes and 32 KB of groups and writes 256 KB
//   (0.1 us at 3.35 TB/s), against ~32 f32 operations of the formula for
//   each of the K(K-1)/2 pairs of an image (0.5 us at 67 TFLOP/s) -- but an
//   IEEE division is ~15 instructions, and powf with the bf16 roundings
//   ~150.  A block owns a 32x32 tile of one image, and only the
//   words(words+1)/2 tiles on or above the diagonal are launched; each
//   writes the zeros of its mirror tile under the diagonal.  It stages its
//   32 row and 32 column boxes (and their areas, centres and groups) in
//   shared memory, each warp takes 4 rows with one lane per column, and
//   __ballot_sync turns the 32 lanes' decisions into the row's word, which
//   one lane stores.  Three exact shortcuts skip most instructions: a pair
//   that does not intersect has an IoU of 0 and passes no threshold >= 0;
//   a pair whose intersection is below 0.999 x threshold x union has an
//   IoU that rounds below a positive threshold (no division); and the DIoU
//   penalty is >= 0, so it is computed only where the IoU alone passes (no
//   powf).
// - keep from bits: a serial chain of K dependent decisions, which no
//   roofline describes; its bytes (K*W words in, K flags in and out) take
//   0.1 us at [8,512].  One block per image copies the image's K*W words
//   into shared memory with all its threads, then one warp walks the words
//   in rank order.  The 32 candidates of word w settle by Jacobi passes in
//   registers: lane t holds row 32w+t's diagonal word, and one pass is one
//   warp-wide OR (__reduce_or_sync) of the words of the candidates still
//   kept; after p passes the first p candidates are final, and a fixed
//   point is the exact answer, so a pass count of the longest chain in the
//   word (plus one) does, never more than 33.  Then the rows of the kept
//   candidates are ORed into the `removed` words after w, a lane per word.
//   No atomics: every launch gives the same bits.  Where the rows do not
//   fit in shared memory (K above ~1,340) they are read from device memory.
// - pairwise IoU f32: bytes, the [B,K,K] f32 write (2.5 us at [8,512]),
//   and about as much for the 2 M IEEE divisions.  A block owns a 64x64
//   tile; each thread computes 4 rows x 4 columns and writes each row's 4
//   columns as one 16-byte store (scalar stores where K is no multiple of 4
//   and at the ragged edge).  A zero intersection over a positive union is
//   returned as it is: the division's slow path for a zero numerator cost
//   a fifth of the kernel's time.
//
// Numbers.  Every operation rounds as the plain PyTorch versions
// (yolodl_torch/kernels/iou.py) round, so keep masks cannot flip at the
// threshold between the two routes.  Products and sums use the _rn
// intrinsics, which nvcc never contracts into FMA, the division is IEEE
// (__fdiv_rn), and the library is built with -fmad=false and without
// --use_fast_math.  The IoU is computed in f32 from the boxes' exact f32
// values.  For bf16 boxes the DIoU penalty rounds as eager PyTorch does on
// bf16 tensors: each op runs in f32 and its result is rounded to bf16
// (__float2bfloat16_rn) -- the centres' sums and halvings, the
// differences, each square, each sum, the + 1e-16 and the division; the
// power is powf on the f32 values with the exponent rounded to the boxes'
// dtype (as a Python float exponent is on a bf16 tensor), rounded to bf16;
// iou - penalty and the comparison are taken in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;            // conflict tile: 32 rows x 32 columns
constexpr int ROWS_PER_WARP = 4;    // conflict block = 32 x 8 threads
constexpr int F32_THREADS = 256;    // pairwise IoU block
constexpr int F32_TILE_COLS = 64;   // pairwise IoU tile: 16 * F32_ROWS rows x 64 columns
constexpr int F32_ROWS = 4;         // rows per thread
constexpr int F32_COLS = 4;         // columns per thread: one 16-byte store
constexpr int KEEP_THREADS = 512;
constexpr float EPSILON = 1e-16f;   // geometry/boxes.py EPSILON and the diag's 1e-16
constexpr unsigned FULL = 0xffffffffu;

// shared words before the staged rows of keep_from_bits_kernel: removed and
// the valid bits, [words] each, rounded up to 16 bytes
__host__ __device__ __forceinline__ int keep_head_words(int words) {
  return (2 * words + 3) & ~3;
}

// The boxes' dtype's rounding of an f32 result: none for f32,
// round-to-nearest-even for bf16.
template <typename T>
__device__ __forceinline__ float rnd(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float box_area(const float4& p) {
  return __fmul_rn(__fsub_rn(p.z, p.x), __fsub_rn(p.w, p.y));
}

// Intersection area of a row box and a column box (x, y, z, w = t, l, b, r).
__device__ __forceinline__ float pair_inter(const float4& r, const float4& c) {
  const float inner_h = fmaxf(__fsub_rn(fminf(r.z, c.z), fmaxf(r.x, c.x)), 0.0f);
  const float inner_w = fmaxf(__fsub_rn(fminf(r.w, c.w), fmaxf(r.y, c.y)), 0.0f);
  return __fmul_rn(inner_h, inner_w);
}

// The union in the plain version's order: ((area_r + area_c) - inter) + eps.
__device__ __forceinline__ float union_of(float inter, float area_r, float area_c) {
  return __fadd_rn(__fsub_rn(__fadd_rn(area_r, area_c), inter), EPSILON);
}

// IoU from the intersection.  A zero intersection over a positive union is
// that zero, without the division's slow path for a zero numerator.
__device__ __forceinline__ float iou_of(float inter, float area_r, float area_c) {
  const float uni = union_of(inter, area_r, area_c);
  return inter == 0.0f && uni > 0.0f ? inter : __fdiv_rn(inter, uni);
}

// (d^2 / c^2)^beta of darknet's DIoU-NMS, rounded as the plain version
// rounds in the boxes' dtype T; cy, cx are the boxes' centres, already
// rounded.
template <typename T>
__device__ __forceinline__ float diou_penalty(const float4& r, float r_cy, float r_cx,
                                              const float4& c, float c_cy, float c_cx,
                                              float beta) {
  const float dy = rnd<T>(__fsub_rn(r_cy, c_cy));
  const float dx = rnd<T>(__fsub_rn(r_cx, c_cx));
  const float dist = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(dy, dy)), rnd<T>(__fmul_rn(dx, dx))));
  const float eh = rnd<T>(__fsub_rn(fmaxf(r.z, c.z), fminf(r.x, c.x)));
  const float ew = rnd<T>(__fsub_rn(fmaxf(r.w, c.w), fminf(r.y, c.y)));
  const float sq = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(eh, eh)), rnd<T>(__fmul_rn(ew, ew))));
  const float diag = rnd<T>(__fadd_rn(sq, EPSILON));
  const float ratio = rnd<T>(__fdiv_rn(dist, diag));
  return rnd<T>(powf(ratio, beta));
}

template <typename T>
__global__ void __launch_bounds__(TILE * TILE / ROWS_PER_WARP)
conflict_bits_kernel(const T* __restrict__ tlbr, const long long* __restrict__ group,
                     uint32_t* __restrict__ bits, int k, int words, float thr, int diou,
                     float beta) {
  __shared__ float4 s_box[2][TILE];   // [0]: the tile's rows, [1]: its columns
  __shared__ float s_area[2][TILE];
  __shared__ float s_cy[2][TILE];
  __shared__ float s_cx[2][TILE];
  __shared__ long long s_group[2][TILE];

  // blockIdx.x numbers the words * (words + 1) / 2 tiles on or above the
  // diagonal row by row: row tile y holds the tiles y .. words - 1
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const auto first = [words](int yy) { return yy * words - yy * (yy - 1) / 2; };
  const float h = words + 0.5f;
  int y = static_cast<int>(h - sqrtf(h * h - 2.0f * t));
  while (y > 0 && first(y) > t) --y;
  while (y + 1 < words && first(y + 1) <= t) ++y;
  const int w = y + (t - first(y));
  const int row0 = y * TILE;
  const int col0 = w * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  uint32_t* bits_b = bits + static_cast<long long>(b) * k * words;
  uint32_t* out = bits_b + w;  // row r: out[r * words]

  // the mirror tile (row tile w, word y) lies under the diagonal: all zero
  if (w > y && tid < TILE && col0 + tid < k)
    bits_b[static_cast<long long>(col0 + tid) * words + y] = 0u;

  if (tid < 2 * TILE) {
    const int which = tid / TILE;
    const int slot = tid % TILE;
    const int idx = (which == 0 ? row0 : col0) + slot;
    float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    long long g = 0;
    if (idx < k) {
      const T* q = tlbr + (static_cast<long long>(b) * k + idx) * 4;
      p = make_float4(to_f32(q[0]), to_f32(q[1]), to_f32(q[2]), to_f32(q[3]));
      g = group[static_cast<long long>(b) * k + idx];
    }
    s_box[which][slot] = p;
    s_area[which][slot] = box_area(p);
    s_cy[which][slot] = rnd<T>(__fmul_rn(rnd<T>(__fadd_rn(p.x, p.z)), 0.5f));
    s_cx[which][slot] = rnd<T>(__fmul_rn(rnd<T>(__fadd_rn(p.y, p.w)), 0.5f));
    s_group[which][slot] = g;
  }
  __syncthreads();

  const int lane = threadIdx.x;
  const int c = col0 + lane;
  const float4 cbox = s_box[1][lane];
  const float c_area = s_area[1][lane];
  const float c_cy = s_cy[1][lane];
  const float c_cx = s_cx[1][lane];
  const long long c_group = s_group[1][lane];
#pragma unroll
  for (int m = 0; m < ROWS_PER_WARP; ++m) {
    const int lr = threadIdx.y + m * (TILE / ROWS_PER_WARP);
    const int r = row0 + lr;
    if (r >= k) break;  // the same r on every lane: the ballot stays whole
    bool hit = false;
    if (c < k && c > r && s_group[0][lr] == c_group) {
      const float4 rbox = s_box[0][lr];
      const float inter = pair_inter(rbox, cbox);
      // no intersection: an IoU of 0, -0 or NaN, above no threshold >= 0
      if (inter > 0.0f || thr < 0.0f) {
        const float uni = union_of(inter, s_area[0][lr], c_area);
        // inter < 0.999 thr uni (both products rounded): the quotient lies
        // 1e-3 below a positive threshold, and so does its rounding
        const float far = __fmul_rn(__fmul_rn(thr, uni), 0.999f);
        if (!(thr > 0.0f && uni > 0.0f && far <= FLT_MAX && inter < far)) {
          float v = __fdiv_rn(inter, uni);
          // the penalty is >= 0 or NaN: it only matters where the IoU passes
          if (diou && v > thr)
            v = __fsub_rn(v, diou_penalty<T>(rbox, s_cy[0][lr], s_cx[0][lr], cbox, c_cy, c_cx,
                                             beta));
          hit = v > thr;
        }
      }
    }
    const uint32_t word = __ballot_sync(FULL, hit);
    if (lane == 0) out[static_cast<long long>(r) * words] = word;
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(KEEP_THREADS)
keep_from_bits_kernel(const uint32_t* __restrict__ bits, const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ keep, int k, int words) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int b = blockIdx.x;
  const long long n = static_cast<long long>(k) * words;
  const uint32_t* g_rows = bits + b * n;
  const uint8_t* valid_b = valid + static_cast<long long>(b) * k;
  uint8_t* keep_b = keep + static_cast<long long>(b) * k;
  uint32_t* removed = smem;          // [words]
  uint32_t* vwords = smem + words;   // [words], the valid flags as bits
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  const uint32_t* rows = g_rows;
  if constexpr (STAGED) {
    uint32_t* s_rows = smem + keep_head_words(words);
    if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(g_rows) & 15) == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(g_rows);
      uint4* dst = reinterpret_cast<uint4*>(s_rows);
#pragma unroll 4
      for (long long i = tid; i < n / 4; i += KEEP_THREADS) dst[i] = src[i];
    } else {
#pragma unroll 4
      for (long long i = tid; i < n; i += KEEP_THREADS) s_rows[i] = g_rows[i];
    }
    rows = s_rows;
  }
  for (int w = tid / 32; w < words; w += KEEP_THREADS / 32) {
    const int i = 32 * w + lane;
    const uint32_t v = __ballot_sync(FULL, i < k && valid_b[i] != 0);
    if (lane == 0) {
      vwords[w] = v;
      removed[w] = 0u;
    }
  }
  __syncthreads();
  if (tid >= 32) return;

  for (int w = 0; w < words; ++w) {
    const int i = 32 * w + lane;
    // lane t holds the word of row 32w+t that lies on the diagonal
    const uint32_t diag = i < k ? rows[static_cast<long long>(i) * words + w] : 0u;
    const uint32_t standing = vwords[w] & ~removed[w];
    // The word's own recurrence by Jacobi passes: after p passes its first
    // p candidates are final, so at most 33 passes end on a fixed point,
    // which is the recurrence's unique solution; chains are short, so a
    // few passes of one warp-wide OR each usually do.
    uint32_t kept = standing;
    for (;;) {
      const uint32_t next =
          standing & ~__reduce_or_sync(FULL, ((kept >> lane) & 1u) ? diag : 0u);
      if (next == kept) break;
      kept = next;
    }
    if (i < k) keep_b[i] = static_cast<uint8_t>((kept >> lane) & 1u);
    // the kept candidates of word w suppress in every later word; all 32
    // rows exist below the last word, and loading them all before the ORs
    // keeps the 32 loads in flight together
    for (int w2 = w + 1 + lane; w2 < words; w2 += 32) {
      const uint32_t* col = rows + static_cast<long long>(32 * w) * words + w2;
      uint32_t row_word[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) row_word[t] = col[static_cast<long long>(t) * words];
      uint32_t acc = removed[w2];
#pragma unroll
      for (int t = 0; t < 32; ++t) acc |= row_word[t] & (0u - ((kept >> t) & 1u));
      removed[w2] = acc;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(F32_THREADS)
iou_pairwise_kernel(const float* __restrict__ tlbr, float* __restrict__ out, int k) {
  constexpr int LANES_PER_ROW = F32_TILE_COLS / F32_COLS;        // 16
  constexpr int ROW_GROUPS = F32_THREADS / LANES_PER_ROW;         // 16
  constexpr int TILE_ROWS = ROW_GROUPS * F32_ROWS;
  __shared__ float4 s_rows[TILE_ROWS];
  __shared__ float4 s_cols[F32_TILE_COLS];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TILE_ROWS;
  const int col0 = blockIdx.x * F32_TILE_COLS;
  const float* boxes = tlbr + static_cast<long long>(b) * k * 4;
  const int tid = threadIdx.x;

  // stage the tile's row and column boxes, one float per thread and step
  for (int e = tid; e < (TILE_ROWS + F32_TILE_COLS) * 4; e += F32_THREADS) {
    const bool is_row = e < TILE_ROWS * 4;
    const int slot = (is_row ? e : e - TILE_ROWS * 4) / 4;
    const int idx = (is_row ? row0 : col0) + slot;
    float* dst = reinterpret_cast<float*>(is_row ? &s_rows[slot] : &s_cols[slot]);
    dst[e % 4] = idx < k ? boxes[static_cast<long long>(idx) * 4 + e % 4] : 0.0f;
  }
  __syncthreads();

  const int tx = tid % LANES_PER_ROW;
  const int ty = tid / LANES_PER_ROW;
  const int c0 = col0 + tx * F32_COLS;
  if (c0 >= k) return;
  float4 cbox[F32_COLS];
  float c_area[F32_COLS];
#pragma unroll
  for (int j = 0; j < F32_COLS; ++j) {
    cbox[j] = s_cols[tx * F32_COLS + j];
    c_area[j] = box_area(cbox[j]);
  }
  const bool vec = (k % 4 == 0) && c0 + F32_COLS <= k;
  float* out_b = out + static_cast<long long>(b) * k * k;
#pragma unroll
  for (int m = 0; m < F32_ROWS; ++m) {  // rows past K compute on zeros, store nothing
    const int lr = ty + m * ROW_GROUPS;
    const int r = row0 + lr;
    const float4 rbox = s_rows[lr];
    const float r_area = box_area(rbox);
    float v[F32_COLS];
#pragma unroll
    for (int j = 0; j < F32_COLS; ++j) v[j] = iou_of(pair_inter(rbox, cbox[j]), r_area, c_area[j]);
    if (r >= k) continue;
    float* dst = out_b + static_cast<long long>(r) * k + c0;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < F32_COLS; ++j)
        if (c0 + j < k) dst[j] = v[j];
    }
  }
}

// powf exactly as the kernels above call it, for a check of the toolchain
__global__ void powf_kernel(const float* __restrict__ x, float* __restrict__ y, int n, float e) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = powf(x[i], e);
}

int words_of(int k) { return (k + 31) / 32; }

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0
// when the launch was accepted).  None synchronises or allocates.

// tlbr: [B, K, 4] f32 contiguous on the device; out: [B, K, K] f32.
extern "C" int yolodl_iou_pairwise_f32(const float* tlbr, float* out, int batch, int k,
                                       void* stream) {
  if (batch <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int tile_rows = F32_THREADS / (F32_TILE_COLS / F32_COLS) * F32_ROWS;
  const dim3 grid((k + F32_TILE_COLS - 1) / F32_TILE_COLS, (k + tile_rows - 1) / tile_rows, batch);
  iou_pairwise_kernel<<<grid, F32_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(tlbr, out, k);
  return static_cast<int>(cudaGetLastError());
}

// tlbr: [B, K, 4] contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// group: [B, K] int64; bits: [B, K, ceil(K/32)] 32-bit words.  diou = 0
// for greedy NMS, 1 for DIoU-NMS with exponent beta.
extern "C" int yolodl_nms_conflict_bits(const void* tlbr, int is_bf16, const long long* group,
                                        uint32_t* bits, int batch, int k, float thr, int diou,
                                        float beta, void* stream) {
  if (batch <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int words = words_of(k);
  const dim3 grid(words * (words + 1) / 2, batch);
  const dim3 block(TILE, TILE / ROWS_PER_WARP);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    conflict_bits_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(tlbr), group, bits, k, words, thr, diou, beta);
  else
    conflict_bits_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(tlbr), group,
                                                       bits, k, words, thr, diou, beta);
  return static_cast<int>(cudaGetLastError());
}

// bits: [B, K, ceil(K/32)] words from yolodl_nms_conflict_bits; valid,
// keep: [B, K] bytes of 0 or 1.  One block per image; the image's words are
// staged in shared memory when they fit in what a block may opt in to.
extern "C" int yolodl_nms_keep_from_bits(const uint32_t* bits, const uint8_t* valid,
                                         uint8_t* keep, int batch, int k, void* stream) {
  if (batch <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int words = words_of(k);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t head = static_cast<size_t>(keep_head_words(words)) * 4;
  const size_t all = head + static_cast<size_t>(k) * words * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (all <= static_cast<size_t>(optin)) {
    if (all > 48 * 1024) {
      err = cudaFuncSetAttribute(keep_from_bits_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(all));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    keep_from_bits_kernel<true><<<batch, KEEP_THREADS, all, s>>>(bits, valid, keep, k, words);
  } else {  // the rows stay in device memory
    keep_from_bits_kernel<false><<<batch, KEEP_THREADS, head, s>>>(bits, valid, keep, k, words);
  }
  return static_cast<int>(cudaGetLastError());
}

// y[i] = powf(x[i], e) with the library's own powf: lets a caller confirm
// that the DIoU penalty's power gives the bits of torch.pow on the card.
extern "C" int yolodl_powf_probe(const float* x, float* y, int n, float e, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  powf_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, y, n, e);
  return static_cast<int>(cudaGetLastError());
}
