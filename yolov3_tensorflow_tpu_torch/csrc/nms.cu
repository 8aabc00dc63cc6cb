// Per-group greedy NMS keep masks over score-sorted candidates, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel yolov3_tensorflow_tpu/ops/nms_pallas.py:
// _nms_kernel (driven by nms_keep_mask_pallas). Same result: rows arrive in
// score-descending order, the rank is the row index, and for each group g
// keep[g, j] = 1 when valid[g, j] holds and no kept i < j has
// IoU(i, j) > iou_t. `valid` need not be a prefix of the row. Its plain
// PyTorch version is ops/nms.py:suppression_mask (through
// ops/nms_cuda.py:nms_keep_mask_reference).
//
// What bounds it: building the IoU>t bits. A group of K candidates needs up
// to K^2/2 IoUs (512 K at K = 1024), each with an IEEE division and
// NaN-propagating min/max; the bytes are small (K * 17 in, K out). The
// greedy itself is sequential within a group; the parallelism comes from
// the groups (image x class: 640 at the eval batch of 8 x 80 classes).
// Measured on an H100 (PERF.md), the build is bound by latency, not by
// instruction throughput: at K = 1024 one CTA fills an SM's shared memory,
// and its 16 warps hide the division's latency poorly.
// The design:
//   - one CTA per group; its IoU>t bits live in shared memory as K rows of
//     T = ceil(K/32) 32-bit words, 128 KiB at K = 1024. That is over the
//     48 KiB default, so the launch opts in to up to 227 KiB of dynamic
//     shared memory. Keeping the mask on chip needs no global scratch
//     (the alternative, masks in device memory, is G*K*K/8 bytes, 84 MB at
//     the eval shape, written and read back once) and no second launch;
//   - the CTA builds only the words a greedy can read: rows of valid
//     candidates, words t >= i/32 (the upper triangle), one __ballot_sync
//     per word;
//   - one warp runs the greedy. Lane l holds `removed` word l (K <= 1024
//     means at most 32 words, one per lane), initialised to the invalid
//     and out-of-range bits. For each 32-row block w, lane w's word decides
//     the block's rows one after the other in registers (a kept row ORs its
//     diagonal word into it), then every later lane ORs the kept rows' words
//     into its own. A block costs 32 register steps plus one shared-memory
//     load per kept row per lane, not one warp round trip per row.
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
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ bool iou_over(const float4 a, float area_a,
                                         const float4 b, float area_b,
                                         float iou_t) {
  float iw = max_nan(min_nan(a.z, b.z) - max_nan(a.x, b.x), 0.0f);
  float ih = max_nan(min_nan(a.w, b.w) - max_nan(a.y, b.y), 0.0f);
  float inter = iw * ih;
  return inter / (area_a + area_b - inter + 1e-10f) > iou_t;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
           uint8_t* __restrict__ keep, int K, float iou_t) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = (K + 31) / 32;                 // mask words per row
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(smem + 4 * K);
  uint32_t* svalid = smem + 5 * K;             // [T]
  uint32_t* mask = svalid + 32;                // [K][T]
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
    if (lane == 0) svalid[t] = bits;
  }
  __syncthreads();

  // IoU>t words: word (i, t) holds bit l for candidate j = 32t + l; only
  // rows of valid candidates and words t >= i/32 are built
  for (int w = warp; w < K * T; w += kWarps) {
    const int i = w / T;
    const int t = w % T;
    if (t < (i >> 5) || !((svalid[i >> 5] >> (i & 31)) & 1u)) continue;
    const int j = t * 32 + lane;
    const bool over = j < K && iou_over(sbox[i], sarea[i], sbox[j],
                                        sarea[j], iou_t);
    const uint32_t bits = __ballot_sync(kFull, over);
    if (lane == 0) mask[w] = bits;
  }
  __syncthreads();
  if (warp != 0) return;

  // the greedy: bit b of `removed` in lane l is candidate 32l + b, set when
  // it is invalid, past K, or suppressed by a kept candidate before it
  uint32_t removed = lane < T ? ~svalid[lane] : kFull;
  uint32_t kept_word = 0;                      // lane w: block w's keep bits
  for (int w = 0; w < T; ++w) {
    const int i0 = w * 32;
    uint32_t r = __shfl_sync(kFull, removed, w);
    // diagonal word of row i0 + lane (only read when that row is kept)
    const uint32_t diag = ((~r >> lane) & 1u) ? mask[(i0 + lane) * T + w] : 0u;
    uint32_t kw = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t d = __shfl_sync(kFull, diag, b);
      if (!((r >> b) & 1u)) {                  // row i0 + b survives: keep
        kw |= 1u << b;
        r |= d;
      }
    }
    if (lane == w) kept_word = kw;
    if (lane > w && lane < T) {
      for (uint32_t bits = kw; bits; bits &= bits - 1) {
        const int b = __ffs(bits) - 1;
        removed |= mask[(i0 + b) * T + lane];
      }
    }
  }

  uint8_t* out = keep + (size_t)g * K;
  for (int w = 0; w < T; ++w) {
    const uint32_t kw = __shfl_sync(kFull, kept_word, w);
    const int j = w * 32 + lane;
    if (j < K) out[j] = (kw >> lane) & 1u;
  }
}

}  // namespace

// boxes [G, K, 4] f32, valid [G, K] uint8/bool, keep [G, K] uint8/bool, all
// contiguous on one device, boxes 16-byte aligned; 1 <= K <= 1024. Launches
// on `stream` and does not synchronize. Returns the launch's cudaError_t
// (0 on success).
extern "C" int nms_launch(const void* boxes, const void* valid, void* keep,
                          int G, int K, float iou_t, void* stream) {
  if (G <= 0 || K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const int T = (K + 31) / 32;
  const size_t smem = sizeof(float) * 5 * K + sizeof(uint32_t) * 32 +
                      sizeof(uint32_t) * (size_t)K * T;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K, iou_t);
  return (int)cudaGetLastError();
}
