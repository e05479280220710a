// Machinery shared by wgrad_db.cu and wgrad_lowch.cu (bf16 inputs):
//
//   dW[u, v, ci, co] = sum_{b,h,w} xp[b, h+u, w+v, ci] * g[b, h, w, co]
//
// is a [k*k*Ci] x [Co] product whose contraction runs over the B*H*W output
// positions.  Both operands lie in memory with the contraction as the slow
// axis and the channels contiguous, so both are "transposed" for the tensor
// cores: ldmatrix.trans reads them from shared memory as the fragments of
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) without a transposing copy.
//
// What is here:
// * the plan (enum PlanField): how a launch is cut, computed on the host by
//   yolodl_torch/kernels/_util.py wgrad_plan and handed over as integers;
// * the ring: one producer thread keeps row strips of xp and g in flight
//   into `stages` slots of dynamic shared memory and reports to mbarriers;
//   the block's 16 (or 8) consumer warps wait for a slot, run their MMAs and
//   hand the oldest slot back.  The producer is thread 0 of the consumers,
//   not a warp of its own: a 17th warp would cut every thread from 128
//   registers to 96.  A strip whose channel count is a multiple of 8 is copied by
//   TMA through a tensor map (cp.async.bulk.tensor, 128/64/32-byte swizzle
//   so that ldmatrix meets no bank conflict, zero fill outside the image);
//   any other strip (the 3-channel stem) is one contiguous span, copied by
//   cp.async.bulk as its 16-byte-aligned superset and read element-wise
//   from shared memory with the byte offset;
// * fragment loads, the MMA wrapper, the K-split reduction inside a block,
//   the epilogue into the partials [chunks, k*k*Ci, Co], and the second
//   kernel that adds the chunks in a fixed order (no float atomics: two
//   launches give the same bits).
//
// A kernel is wgrad_ring_kernel<Row>, where Row (in the .cu file) says what
// the consumer warps do with one staged output row.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstring>

namespace wgrad {

// the order of yolodl_torch/kernels/_util.py PLAN_FIELDS
enum PlanField {
  P_B, P_H, P_W, P_CI, P_CO, P_K,
  P_WT, P_STRIPS, P_ROWS_PER_CHUNK, P_CHUNKS_PER_COL, P_CHUNKS,
  P_CI_BLK, P_CO_BLK, P_CI_SPLITS, P_CO_SPLITS,
  P_A_TMA, P_B_TMA, P_CBOX, P_NBOX,
  P_STAGES, P_WARPS, P_MT, P_NT, P_TAPS, P_WM, P_WN, P_WTAP, P_WK,
  P_X_BYTES, P_G_BYTES, P_XBOX_STRIDE, P_GBOX_STRIDE,
  P_EROW, P_EBUF_BYTES, P_SMEM_BYTES, P_SLICES,
  P_COUNT
};

struct Plan {
  int v[P_COUNT];
};

// A block has Row::WARPS warps, all of them consumers (thread 0 is also the
// producer): 16 with up to 128 registers a thread, or 8 with up to 255, whose
// larger warp tiles read each fragment from shared memory for more MMAs.
constexpr int MAX_WARPS = 16;
constexpr int STAGES_MAX = 8;
constexpr int BAR_BYTES = 1024;  // the mbarriers, in front of the stages
constexpr unsigned WAIT_LIMIT = 1u << 24;  // failed waits before a trap

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.  A wait
// that never ends would hang the card, so it traps after WAIT_LIMIT tries.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (unsigned tries = 0; !done; ++tries) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && tries > WAIT_LIMIT) __trap();
  }
}

// one contiguous span, 16-byte aligned at both ends, global -> shared
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one box of a 4-d tensor map (channel, column, row, image), global -> shared
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d[16x8] += a[16x16] * b[16x8], bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds_u128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts_u128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void sts_u16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(addr), "h"(static_cast<uint16_t>(v)) : "memory");
}

// ---------------------------------------------------------------- geometry

// What one block works on, the same in every thread.
struct Block {
  int img, w0, wv, nks;      // image, first column, valid columns, MMA steps per row
  int h_begin, rows;         // output rows of the chunk
  int ci0, cin, co0, con;    // the block's input and output channels
  uint32_t base;             // shared memory, 1024-aligned
  uint32_t stage_bytes;
};

__device__ __forceinline__ Block make_block(const Plan& P, uint32_t base) {
  const int* v = P.v;
  Block q;
  const int chunk = blockIdx.x;
  const int col = chunk / v[P_CHUNKS_PER_COL];
  const int part = chunk % v[P_CHUNKS_PER_COL];
  q.img = col / v[P_STRIPS];
  q.w0 = (col % v[P_STRIPS]) * v[P_WT];
  q.wv = min(v[P_WT], v[P_W] - q.w0);
  q.nks = (q.wv + 15) / 16;
  q.h_begin = part * v[P_ROWS_PER_CHUNK];
  q.rows = min(v[P_ROWS_PER_CHUNK], v[P_H] - q.h_begin);
  const int cs = blockIdx.y / v[P_CO_SPLITS];
  const int ns = blockIdx.y % v[P_CO_SPLITS];
  q.ci0 = cs * v[P_CI_BLK];
  q.cin = min(v[P_CI_BLK], v[P_CI] - q.ci0);
  q.co0 = ns * v[P_CO_BLK];
  q.con = min(v[P_CO_BLK], v[P_CO] - q.co0);
  q.base = base;
  q.stage_bytes = static_cast<uint32_t>(v[P_X_BYTES] + v[P_G_BYTES]);
  return q;
}

__device__ __forceinline__ uint32_t full_bar(const Block& q, int s) { return q.base + 8 * s; }
__device__ __forceinline__ uint32_t empty_bar(const Block& q, int s) {
  return q.base + 8 * (STAGES_MAX + s);
}
__device__ __forceinline__ uint32_t x_slot(const Block& q, int s) {
  return q.base + BAR_BYTES + s * q.stage_bytes;
}
__device__ __forceinline__ uint32_t g_slot(const Plan& P, const Block& q, int s) {
  return x_slot(q, s) + P.v[P_X_BYTES];
}

// byte offset of the first element of a span inside its aligned superset
// (only the low 4 bits matter, so 32-bit wrap-around is harmless)
__device__ __forceinline__ uint32_t xp_span_offset(const Plan& P, const Block& q, int row) {
  const uint32_t hp = P.v[P_H] + P.v[P_K] - 1, wp = P.v[P_W] + P.v[P_K] - 1;
  return (2u * (((q.img * hp + row) * wp + q.w0) * static_cast<uint32_t>(P.v[P_CI]))) & 15u;
}
__device__ __forceinline__ uint32_t g_span_offset(const Plan& P, const Block& q, int row) {
  const uint32_t h = P.v[P_H], w = P.v[P_W];
  return (2u * (((q.img * h + row) * w + q.w0) * static_cast<uint32_t>(P.v[P_CO]))) & 15u;
}

// ---------------------------------------------------------------- producer

// Start the copies of stage t of a chunk into its slot: xp row h_begin + t
// and, from t = k - 1 on, g row h_begin + t - (k - 1), columns of the block's
// strip.  The slot must be free.  One thread calls this.
template <bool A_TMA, bool B_TMA>
__device__ void copy_stage(const Plan& P, const Block& q, const __nv_bfloat16* xp,
                            const __nv_bfloat16* g, const CUtensorMap* xmap,
                            const CUtensorMap* gmap, int t) {
  const int* v = P.v;
  const int k = v[P_K], S = v[P_STAGES];
  const int hp = v[P_H] + k - 1, wp = v[P_W] + k - 1;
  const int xpos = v[P_WT] + k - 1;
  const int s = t % S;
  const uint32_t bar = full_bar(q, s);
  const int xrow = q.h_begin + t;
  const int grow = q.h_begin + t - (k - 1);
  const bool has_g = t >= k - 1;
  // bytes of this stage
  uint32_t bytes = 0;
  const char* xsrc = nullptr;
  const char* gsrc = nullptr;
  uint32_t xlen = 0, glen = 0;
  if (A_TMA) {
    bytes += static_cast<uint32_t>(q.cin / v[P_CBOX]) * xpos * v[P_CBOX] * 2;
  } else {
    const long long start =
        2ll * (((static_cast<long long>(q.img) * hp + xrow) * wp + q.w0) * v[P_CI]);
    const long long end = start + 2ll * min(xpos, wp - q.w0) * v[P_CI];
    const long long s0 = start & ~15ll;
    xsrc = reinterpret_cast<const char*>(xp) + s0;
    xlen = static_cast<uint32_t>(((end + 15) & ~15ll) - s0);
    bytes += xlen;
  }
  if (has_g) {
    if (B_TMA) {
      bytes += static_cast<uint32_t>(q.con / v[P_NBOX]) * v[P_WT] * v[P_NBOX] * 2;
    } else {
      const long long start =
          2ll * (((static_cast<long long>(q.img) * v[P_H] + grow) * v[P_W] + q.w0) * v[P_CO]);
      const long long end = start + 2ll * q.wv * v[P_CO];
      const long long s0 = start & ~15ll;
      gsrc = reinterpret_cast<const char*>(g) + s0;
      glen = static_cast<uint32_t>(((end + 15) & ~15ll) - s0);
      bytes += glen;
    }
  }
  mbar_expect_tx(bar, bytes);
  const uint32_t xs = x_slot(q, s);
  if (A_TMA) {
    for (int i = 0; i < q.cin / v[P_CBOX]; ++i)
      tma_load_4d(xs + i * v[P_XBOX_STRIDE], xmap, q.ci0 + i * v[P_CBOX], q.w0, xrow, q.img, bar);
  } else {
    bulk_copy(xs, xsrc, xlen, bar);
  }
  if (has_g) {
    const uint32_t gs = g_slot(P, q, s);
    if (B_TMA) {
      for (int i = 0; i < q.con / v[P_NBOX]; ++i)
        tma_load_4d(gs + i * v[P_GBOX_STRIDE], gmap, q.co0 + i * v[P_NBOX], q.w0, grow, q.img,
                    bar);
    } else {
      bulk_copy(gs, gsrc, glen, bar);
    }
  }
}

// ---------------------------------------------------------------- operands

// A staged operand as the consumers address it.  Boxed (TMA): channel c of
// position p lies at box c / box_ch, row p, swizzled by the box's span.
// Span (bulk): pixel-major, all `pixel_ch` channels, from byte `off`.
struct Boxed {
  uint32_t row_bytes, box_shift, box_stride, mask;
  __device__ __forceinline__ Boxed(int box_ch, int stride)
      : row_bytes(box_ch * 2), box_shift(box_ch == 64 ? 6 : box_ch == 32 ? 5 : box_ch == 16 ? 4 : 3), box_stride(stride),
        mask(box_ch / 8 - 1) {}
  // channel part of an address: the box and the bytes inside a row
  __device__ __forceinline__ uint32_t box_of(int c) const { return (c >> box_shift) * box_stride; }
  __device__ __forceinline__ uint32_t in_row(int c) const {
    return (c & ((1 << box_shift) - 1)) * 2;
  }
  __device__ __forceinline__ uint32_t at(uint32_t slot_box, uint32_t in_row_bytes, int p) const {
    const uint32_t lin = p * row_bytes + in_row_bytes;
    return slot_box + (lin ^ (((lin >> 7) & mask) << 4));
  }
};

// the lane's part of an ldmatrix.x4.trans address: A fragment (16 channels x
// 16 positions): matrices (k0-7, m0-7), (k0-7, m8-15), (k8-15, m0-7),
// (k8-15, m8-15); B fragments of two n8 tiles: (k0-7, n0-7), (k8-15, n0-7),
// (k0-7, n8-15), (k8-15, n8-15)
__device__ __forceinline__ int a_lane_pos(int lane) { return (lane & 7) + ((lane >> 4) & 1) * 8; }
__device__ __forceinline__ int a_lane_ch(int lane) { return ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int b_lane_pos(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int b_lane_ch(int lane) { return ((lane >> 4) & 1) * 8; }

// A fragment of a span operand: a[0] = (m g, k 2t..2t+1), a[1] = m + 8,
// a[2] = k + 8, a[3] = both; channels >= c_n and positions >= p_n read as 0
__device__ __forceinline__ void gather_a(uint32_t* a, uint32_t span, int pixel_ch, int c0, int c_n,
                                         int m0, int p0, int p_n, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + gq + (r & 1) * 8;
    const int p = p0 + 2 * tq + (r >> 1) * 8;
    uint32_t lo = 0, hi = 0;
    if (m < c_n) {
      if (p < p_n) lo = lds_u16(span + (p * pixel_ch + c0 + m) * 2);
      if (p + 1 < p_n) hi = lds_u16(span + ((p + 1) * pixel_ch + c0 + m) * 2);
    }
    a[r] = lo | (hi << 16);
  }
}

// B fragments of one n8 tile from a span operand: b[0] = (k 2t..2t+1, n g),
// b[1] = k + 8
__device__ __forceinline__ void gather_b(uint32_t* b, uint32_t span, int pixel_ch, int c0, int c_n,
                                         int n0, int p0, int p_n, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const int n = n0 + gq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = p0 + 2 * tq + r * 8;
    uint32_t lo = 0, hi = 0;
    if (n < c_n) {
      if (p < p_n) lo = lds_u16(span + (p * pixel_ch + c0 + n) * 2);
      if (p + 1 < p_n) hi = lds_u16(span + ((p + 1) * pixel_ch + c0 + n) * 2);
    }
    b[r] = lo | (hi << 16);
  }
}

// The B fragments (g) of a warp's NT n8 tiles at positions p0..p0+15.
template <int NT, bool B_TMA>
struct GFragments {
  uint32_t box[NT / 2], in_row[NT / 2];  // boxed: the lane's channel part per tile pair
  uint32_t base[NT / 2];                 // and its addresses in the present row
  int n0;
  __device__ __forceinline__ void init(const Plan& P, const Block& q, int n_first, int lane) {
    n0 = n_first;
    if (B_TMA) {
      const Boxed gb(P.v[P_NBOX], P.v[P_GBOX_STRIDE]);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        int n = n_first + j * 16 + b_lane_ch(lane);
        if (n >= q.con) n = 0;  // columns that are never stored
        box[j] = gb.box_of(n);
        in_row[j] = gb.in_row(n);
      }
    }
  }
  // Boxed: the lane's addresses for positions 0..15 of the g row in slot gs.
  // A step of 16 positions adds 16 rows of the box and leaves the swizzle
  // as it is (it reads address bits 7-9, below 16 rows of any box).
  __device__ __forceinline__ void begin_row(const Plan& P, uint32_t gs, int lane) {
    if (B_TMA) {
      const Boxed gb(P.v[P_NBOX], P.v[P_GBOX_STRIDE]);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) base[j] = gb.at(gs + box[j], in_row[j], b_lane_pos(lane));
    }
  }
  __device__ __forceinline__ void load(uint32_t (*b)[2], const Plan& P, const Block& q,
                                       uint32_t gs, uint32_t span_off, int p0, int lane) const {
    if (B_TMA) {
      const uint32_t step = p0 * P.v[P_NBOX] * 2;
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        ldmatrix_x4_trans(b[2 * j][0], b[2 * j][1], b[2 * j + 1][0], b[2 * j + 1][1],
                          base[j] + step);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        gather_b(b[j], gs + span_off, P.v[P_CO], q.co0, q.con, n0 + j * 8, p0, q.wv, lane);
    }
  }
};

// ---------------------------------------------------------------- epilogue

// Add the accumulators of the warps that split the MMA steps (wk > 0) onto
// their wk = 0 partner, in the order of wk, through shared memory.
template <int NACC, int THREADS>
__device__ __forceinline__ void reduce_k_split(float* acc, const Plan& P, const Block& q, int warp,
                                               int lane) {
  const int wk = P.v[P_WK];
  if (wk == 1) return;
  const int group = P.v[P_WM] * P.v[P_WN] * P.v[P_WTAP];
  float* red = static_cast<float*>(__cvta_shared_to_generic(q.base + BAR_BYTES));
  consumer_sync(THREADS);  // every warp is done with the stages
  if (warp >= group && warp < group * wk) {
#pragma unroll
    for (int r = 0; r < NACC; ++r) red[(warp * NACC + r) * 32 + lane] = acc[r];
  }
  consumer_sync(THREADS);
  if (warp < group) {
    for (int s = 1; s < wk; ++s) {
#pragma unroll
      for (int r = 0; r < NACC; ++r)
        acc[r] = __fadd_rn(acc[r], red[((warp + s * group) * NACC + r) * 32 + lane]);
    }
  }
}

// One m16n8 accumulator tile into the chunk's partial: rows m0 + g and
// m0 + g + 8 map through row_of (-1: not stored), columns n0 + 2t, 2t + 1.
template <typename RowOf>
__device__ __forceinline__ void store_tile(const float* d, float* out, const Block& q, int co,
                                           int m0, int n0, int lane, RowOf row_of) {
  const int gq = lane >> 2, tq = lane & 3;
  const int n = n0 + 2 * tq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = row_of(m0 + gq + half * 8);
    if (row < 0) continue;
    float* dst = out + row * co + q.co0 + n;
    if ((co & 1) == 0 && n + 1 < q.con) {  // an even width keeps the pair 8-byte aligned
      *reinterpret_cast<float2*>(dst) = make_float2(d[half * 2], d[half * 2 + 1]);
    } else {
      if (n < q.con) dst[0] = d[half * 2];
      if (n + 1 < q.con) dst[1] = d[half * 2 + 1];
    }
  }
}

// out[i] = sum over slices of partial[slice][i], slices in a fixed order:
// thread (x, y) adds slices y, y + 32, ... for element x of the block, then
// the 32 sums are added in the order of y.
__global__ void __launch_bounds__(1024)
reduce_slices_kernel(const float* __restrict__ partial, float* __restrict__ out, int slices,
                     long long n) {
  __shared__ float part[32][33];
  const long long i = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  float s = 0.0f;
  if (i < n) {
#pragma unroll 4
    for (int c = threadIdx.y; c < slices; c += 32) s = __fadd_rn(s, partial[c * n + i]);
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float t = part[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < 32; ++y) t = __fadd_rn(t, part[y][threadIdx.x]);
    out[i] = t;
  }
}

// ---------------------------------------------------------------- kernel


// Row::NACC accumulators per thread; Row::init once, Row::row per stage
// (stage t holds xp row t of the chunk and the g row of output row t-k+1),
// Row::store into the chunk's partial.
template <typename Row>
__global__ void __launch_bounds__(Row::WARPS * 32, 1)
wgrad_ring_kernel(const __nv_bfloat16* __restrict__ xp, const __nv_bfloat16* __restrict__ g,
                  float* __restrict__ partial, const __grid_constant__ Plan P,
                  const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap gmap) {
  constexpr int THREADS = Row::WARPS * 32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Block q = make_block(P, base);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int k = P.v[P_K], S = P.v[P_STAGES];

  // A span's slot is zeroed once: what its copies never write (the strip's
  // tail) must read as finite values.  A box needs none of it: TMA writes
  // all of it, zeros outside the image.
  if (!Row::A_TMA || !Row::B_TMA) {
    const uint32_t words = (P.v[P_SMEM_BYTES] - 1024) / 16;
    for (uint32_t i = tid; i < words; i += THREADS)
      sts_u128(base + 16 * i, make_uint4(0u, 0u, 0u, 0u));
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_bar(q, s), 1);
      mbar_init(empty_bar(q, s), Row::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the zeros (generic proxy) before the copies (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // Thread 0 is the producer: it fills every slot once, and after each row
  // refills the slot that the row before handed back (by then every warp has
  // arrived on its barrier, or soon will), so copies stay ahead of the MMAs
  // by the stages that no row holds, less one, without a warp of their own.
  const int T = q.rows + k - 1;
  if (tid == 0) {
    for (int t = 0; t < min(S, T); ++t)
      copy_stage<Row::A_TMA, Row::B_TMA>(P, q, xp, g, &xmap, &gmap, t);
  }

  float acc[Row::NACC];
#pragma unroll
  for (int r = 0; r < Row::NACC; ++r) acc[r] = 0.0f;
  Row row;
  row.init(P, q, warp, lane);
  // a Row that multiplies from the staged xp rows holds a stage for k rows
  const int lag = Row::HOLDS_ROWS ? k - 1 : 0;
  for (int t = 0; t < T; ++t) {
    mbar_wait(full_bar(q, t % S), (t / S) & 1);
    row.row(acc, P, q, t, warp, lane);
    __syncwarp();
    if (t >= lag && lane == 0) mbar_arrive(empty_bar(q, (t - lag) % S));
    const int freed = t - lag - 1;  // the stage handed back after the row before
    if (tid == 0 && freed >= 0 && freed + S < T) {
      mbar_wait(empty_bar(q, freed % S), (freed / S) & 1);
      copy_stage<Row::A_TMA, Row::B_TMA>(P, q, xp, g, &xmap, &gmap, freed + S);
    }
  }
  reduce_k_split<Row::NACC, THREADS>(acc, P, q, warp, lane);
  const long long n = static_cast<long long>(k) * k * P.v[P_CI] * P.v[P_CO];
  row.store(acc, partial + blockIdx.x * n, P, q, warp, lane);
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib == nullptr) lib = dlopen("libcuda.so", RTLD_NOW | RTLD_GLOBAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Tensor map of a contiguous NHWC bf16 tensor [b, rows, cols, ch] with boxes
// of box_ch channels x box_cols columns of one row; outside the tensor a box
// is filled with zeros.  Returns 0 or a cudaError.
inline int make_map(CUtensorMap* map, const void* ptr, int b, int rows, int cols, int ch,
                    int box_ch, int box_cols) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(ch), static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {2ull * ch, 2ull * ch * cols, 2ull * ch * cols * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_ch), static_cast<cuuint32_t>(box_cols),
                             1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_ch == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_ch == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : box_ch == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                    : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

inline bool plan_is_sane(const Plan& P) {
  const int* v = P.v;
  for (int i = 0; i < P_COUNT; ++i)
    if (v[i] < 0) return false;
  return v[P_STAGES] >= 3 && v[P_STAGES] <= STAGES_MAX &&
         v[P_WT] % 16 == 0 && v[P_WT] > 0 && v[P_SMEM_BYTES] <= 232448 &&
         (v[P_WARPS] == 8 || v[P_WARPS] == MAX_WARPS) &&
         v[P_WM] * v[P_WN] * v[P_WTAP] * v[P_WK] <= v[P_WARPS] && v[P_WK] >= 1 &&
         v[P_CHUNKS] == v[P_SLICES] && v[P_CHUNKS] >= 1 && v[P_CHUNKS] <= 2147483647 / 2 &&
         v[P_CI_SPLITS] * v[P_CO_SPLITS] <= 65535;
}

// Launch kernel `kern` (an instantiation of wgrad_ring_kernel) and the
// reduction on `stream`.  Returns cudaGetLastError().
template <typename Kernel>
int launch_ring(Kernel kern, const void* xp, const void* g, float* partial, float* out,
                const Plan& P, cudaStream_t stream) {
  const int* v = P.v;
  CUtensorMap xmap, gmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&gmap, 0, sizeof(gmap));
  const int k = v[P_K];
  if (v[P_A_TMA]) {
    const int err = make_map(&xmap, xp, v[P_B], v[P_H] + k - 1, v[P_W] + k - 1, v[P_CI],
                             v[P_CBOX], v[P_WT] + k - 1);
    if (err != 0) return err;
  }
  if (v[P_B_TMA]) {
    const int err = make_map(&gmap, g, v[P_B], v[P_H], v[P_W], v[P_CO], v[P_NBOX], v[P_WT]);
    if (err != 0) return err;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, v[P_SMEM_BYTES]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(v[P_CHUNKS], v[P_CI_SPLITS] * v[P_CO_SPLITS]);
  kern<<<grid, v[P_WARPS] * 32, v[P_SMEM_BYTES], stream>>>(static_cast<const __nv_bfloat16*>(xp),
                                                   static_cast<const __nv_bfloat16*>(g), partial,
                                                   P, xmap, gmap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(k) * k * v[P_CI] * v[P_CO];
  reduce_slices_kernel<<<static_cast<unsigned>((n + 31) / 32), dim3(32, 32), 0, stream>>>(
      partial, out, v[P_SLICES], n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgrad
