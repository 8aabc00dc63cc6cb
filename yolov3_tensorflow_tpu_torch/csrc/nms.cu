// Per-group greedy NMS keep masks over score-sorted candidates, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel yolov3_tensorflow_tpu/ops/nms_pallas.py:
// _nms_kernel (driven by nms_keep_mask_pallas). Same result: rows arrive in
// score-descending order, the rank is the row index, and for each group g
// keep[g, j] = 1 when valid[g, j] holds and no kept i < j has
// IoU(i, j) > iou_t. `valid` need not be a prefix of the row. Its plain
// PyTorch version is ops/nms.py:suppression_mask (through
// ops/nms_cuda.py:nms_keep_mask_reference); ops/nms_cuda.py:
// keep_mask_by_blocks models this kernel's decision order in PyTorch.
//
// What bounds it on this card: the IoU tests, fp32 operations with an IEEE
// division each; the bytes are small (K * 18 per group). A greedy needs one
// test per (kept i, valid j > i) pair, far fewer than the K^2/2 pairs of a
// full mask when most candidates are suppressed, and most pairs do not
// overlap at all. What keeps it from that bound is latency: the greedy is
// sequential within a group, so the card is filled by running many groups
// (image x class: 640 at the eval batch of 8 x 80 classes) side by side.
// The design:
//   - lazy, block by block: the candidates are taken 32 at a time. For
//     block w, the IoU>t bits among the block's own not-yet-removed rows
//     (the diagonal word of each row) are built by all warps, one ballot per
//     row; one warp then decides the 32 rows in registers (a kept row ORs
//     its diagonal word into the block's `removed` word); then all warps OR
//     the kept rows' bits into every later word t > w, each warp owning
//     whole words and testing two kept rows a step. Rows that were not
//     kept are never tested against later blocks, a column already
//     removed is not tested again, and a word whose columns are all
//     removed is left;
//   - no mask is stored: the group's state is its boxes, areas and one
//     `removed` and one keep word per block, ~20 KB at K = 1024, so three
//     16-warp CTAs share an SM (registers capped at 40 a thread). The
//     whole K x K bit mask in shared memory (128 KiB at K = 1024) would
//     leave one CTA per SM and build every valid row's words whether or
//     not the greedy reads them. 16 warps with 3 CTAs an SM measured
//     faster than 16 with 2, 8 with 4 or 5 and 4 with 8 (PERF.md);
//   - no division where the intersection is 0: inter / x for inter == 0 is
//     +-0 or NaN, never > t when t >= 0, so that bit is 0 without the
//     division. A NaN intersection takes the full path;
//   - NaN-propagating min and max as one instruction each (max.NaN.f32),
//     not a compare-and-select chain: the IoU test's instruction count was
//     what the build spent its time on.
// The Pallas kernel's matrix fixpoint (keep <- valid & !(keep @ M > 0),
// iterated on the MXU) is a TPU mechanism and is not carried over.
//
// Arithmetic: the IoU is inter / (area_i + area_j - inter + 1e-10f) in the
// order ops/boxes.py:iou_xyxy evaluates it, built with --fmad=false (no FMA
// contraction) and IEEE division, and min/max propagate NaN as torch's do,
// so every IoU>t bit equals the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 1024;
constexpr int kMaxT = kMaxK / 32;
constexpr unsigned kFull = 0xffffffffu;

// one instruction each: NaN if either input is NaN, as torch.maximum /
// torch.minimum / clamp give (a zero's sign may differ, which no IoU>t
// decision sees: a zero width or height makes the intersection 0)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ bool iou_over(const float4 a, float area_a,
                                         const float4 b, float area_b,
                                         float iou_t) {
  float iw = max_nan(min_nan(a.z, b.z) - max_nan(a.x, b.x), 0.0f);
  float ih = max_nan(min_nan(a.w, b.w) - max_nan(a.y, b.y), 0.0f);
  float inter = iw * ih;
  if (inter == 0.0f && iou_t >= 0.0f) return false;   // 0 / x is not > t
  return inter / (area_a + area_b - inter + 1e-10f) > iou_t;
}

__global__ void __launch_bounds__(kThreads, 3)
nms_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
           uint8_t* __restrict__ keep, int K, float iou_t) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t removed[kMaxT];  // bit l of word t: 32t + l is out
  __shared__ uint32_t kept[kMaxT];     // bit l of word t: 32t + l is kept
  __shared__ uint32_t diag[32];        // the current block's diagonal words
  const int T = (K + 31) / 32;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(smem + 4 * K);
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float4* gbox = reinterpret_cast<const float4*>(boxes) + (size_t)g * K;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float4 b = gbox[i];
    sbox[i] = b;
    sarea[i] = (b.z - b.x) * (b.w - b.y);
  }
  const uint8_t* gval = valid + (size_t)g * K;
  for (int t = warp; t < T; t += kWarps) {
    const int j = t * 32 + lane;
    const uint32_t bits = __ballot_sync(kFull, j < K && gval[j] != 0);
    if (lane == 0) removed[t] = ~bits;      // invalid and past-K bits set
  }
  __syncthreads();

  for (int w = 0; w < T; ++w) {
    const int i0 = w * 32;
    const uint32_t r = removed[w];
    // diagonal words: row i0 + b against the later rows of its block
    for (int b = warp; b < 32; b += kWarps) {
      uint32_t bits = 0;
      if (!((r >> b) & 1u)) {
        const int i = i0 + b;
        const int j = i0 + lane;
        const bool over = lane > b && !((r >> lane) & 1u) &&
                          iou_over(sbox[i], sarea[i], sbox[j], sarea[j],
                                   iou_t);
        bits = __ballot_sync(kFull, over);
      }
      if (lane == 0) diag[b] = bits;
    }
    __syncthreads();
    // decide the block's rows in order, in registers
    if (warp == 0) {
      const uint32_t d = diag[lane];
      uint32_t rr = r, kw = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const uint32_t db = __shfl_sync(kFull, d, b);
        if (!((rr >> b) & 1u)) {
          kw |= 1u << b;
          rr |= db;
        }
      }
      if (lane == 0) kept[w] = kw;
    }
    __syncthreads();
    // the kept rows remove from every later word; a warp owns its words
    const uint32_t kw = kept[w];
    for (int t = w + 1 + warp; t < T && kw; t += kWarps) {
      const uint32_t rt = removed[t];
      const int j = t * 32 + lane;
      bool alive = !((rt >> lane) & 1u);
      const float4 bj = alive ? sbox[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float aj = alive ? sarea[j] : 0.f;
      uint32_t acc = rt;
      // two kept rows a step: their tests are independent (the bits are
      // ORed), which gives the scheduler two chains to interleave
      for (uint32_t bits = kw; bits && __any_sync(kFull, alive);) {
        const int i = i0 + __ffs(bits) - 1;
        bits &= bits - 1;
        const int i2 = bits ? i0 + __ffs(bits) - 1 : i;
        bits &= bits - 1;
        bool over = false;
        if (alive) {
          const bool o1 = iou_over(sbox[i], sarea[i], bj, aj, iou_t);
          const bool o2 = iou_over(sbox[i2], sarea[i2], bj, aj, iou_t);
          over = o1 | o2;
        }
        acc |= __ballot_sync(kFull, over);
        alive = alive && !over;
      }
      if (lane == 0) removed[t] = acc;
    }
    __syncthreads();
  }

  uint8_t* out = keep + (size_t)g * K;
  for (int j = threadIdx.x; j < K; j += kThreads)
    out[j] = (kept[j >> 5] >> (j & 31)) & 1u;
}

}  // namespace

// boxes [G, K, 4] f32, valid [G, K] uint8/bool, keep [G, K] uint8/bool, all
// contiguous on one device, boxes 16-byte aligned; 1 <= K <= 1024. Launches
// on `stream` and does not synchronize. Returns the launch's cudaError_t
// (0 on success).
extern "C" int nms_launch(const void* boxes, const void* valid, void* keep,
                          int G, int K, float iou_t, void* stream) {
  if (G <= 0 || K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 5 * K;   // boxes and areas
  nms_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K, iou_t);
  return (int)cudaGetLastError();
}
