// Batched pairwise IoU of TLBR boxes: [B, K, 4] f32 -> [B, K, K] f32.
//
// Replaces yolodl_tpu/kernels/iou_pallas.py:_iou_tile_kernel (reached through
// pairwise_iou_pallas), the IoU matrix at the core of NMS
// (yolodl_tpu/loss/nms.py _suppress).  One launch covers the whole batch.
//
// Bound on an H100: memory.  At B=8, K=512 the kernel writes
// 8*512*512*4 B = 8.4 MB and reads 64 KB; per output it does ~12 flops, far
// below the card's ratio of operations to bytes.  So the least time is the
// write, ~2.5 us at 3.35 TB/s (5 us at B=16).  The design answers that with
// one pass over the output and coalesced stores: a block owns a 32x32 output
// tile of one image, stages its 32 row boxes and 32 column boxes in shared
// memory, and each warp writes 32 consecutive floats of one output row.  K
// is not padded; the ragged edge is masked.
//
// Numbers: every operation rounds as the plain PyTorch version
// (yolodl_torch/kernels/iou.py pairwise_iou_reference) rounds, so the keep
// masks of NMS cannot flip at the threshold between the two.  The products
// and sums use the _rn intrinsics, which nvcc never contracts into FMA, and
// the division is IEEE (__fdiv_rn); build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS_PER_THREAD = 4;  // block = 32 x 8 threads
constexpr float EPSILON = 1e-16f;   // geometry/boxes.py EPSILON

__global__ void iou_pairwise_kernel(const float* __restrict__ tlbr,
                                    float* __restrict__ out, int k) {
  __shared__ float rows[TILE][4];
  __shared__ float cols[TILE][4];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const float* boxes = tlbr + static_cast<long long>(b) * k * 4;
  const int tid = threadIdx.y * TILE + threadIdx.x;

  // 256 threads stage 2 x 32 boxes x 4 coords (one float each)
  {
    const int which = tid / (TILE * 4);  // 0: rows, 1: cols
    const int box = (tid / 4) % TILE;
    const int coord = tid % 4;
    const int idx = (which == 0 ? row0 : col0) + box;
    const float v = idx < k ? boxes[idx * 4 + coord] : 0.0f;
    if (which == 0) rows[box][coord] = v; else cols[box][coord] = v;
  }
  __syncthreads();

  const int c = col0 + threadIdx.x;
  if (c >= k) return;
  const float ct = cols[threadIdx.x][0];
  const float cl = cols[threadIdx.x][1];
  const float cb = cols[threadIdx.x][2];
  const float cr = cols[threadIdx.x][3];
  const float area_c = __fmul_rn(__fsub_rn(cb, ct), __fsub_rn(cr, cl));
  float* out_b = out + static_cast<long long>(b) * k * k;

#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int lr = threadIdx.y + i * (TILE / ROWS_PER_THREAD);
    const int r = row0 + lr;
    if (r >= k) break;
    const float rt = rows[lr][0];
    const float rl = rows[lr][1];
    const float rb = rows[lr][2];
    const float rr = rows[lr][3];
    const float inner_h = fmaxf(__fsub_rn(fminf(rb, cb), fmaxf(rt, ct)), 0.0f);
    const float inner_w = fmaxf(__fsub_rn(fminf(rr, cr), fmaxf(rl, cl)), 0.0f);
    const float inter = __fmul_rn(inner_h, inner_w);
    const float area_r = __fmul_rn(__fsub_rn(rb, rt), __fsub_rn(rr, rl));
    // ((area_r + area_c) - inter) + eps, in the plain version's order
    const float uni =
        __fadd_rn(__fsub_rn(__fadd_rn(area_r, area_c), inter), EPSILON);
    out_b[static_cast<long long>(r) * k + c] = __fdiv_rn(inter, uni);
  }
}

}  // namespace

// tlbr: [B, K, 4] f32 contiguous on the device; out: [B, K, K] f32.
// Launches on `stream` and returns cudaGetLastError() (0 when the launch
// was accepted).  Does not synchronise and allocates nothing.
extern "C" int yolodl_iou_pairwise_f32(const float* tlbr, float* out, int batch,
                                       int k, void* stream) {
  if (batch <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(TILE, TILE / ROWS_PER_THREAD);
  const dim3 grid((k + TILE - 1) / TILE, (k + TILE - 1) / TILE, batch);
  iou_pairwise_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      tlbr, out, k);
  return static_cast<int>(cudaGetLastError());
}
