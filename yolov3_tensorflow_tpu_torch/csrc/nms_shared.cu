// Shared-candidate per-class greedy NMS keep masks, for Hopper (sm_90a).
//
// Replaces the TPU kernel yolov3_tensorflow_tpu/ops/nms_pallas.py:
// _nms_shared_kernel (driven by nms_keep_mask_shared_pallas). Same result:
// for each image b and class c, keep[b, c, j] = 1 when candidate j is valid
// (scores[b, j, c] >= score_t) and no kept candidate ranked before it
// (score descending, ties to the lower index) has IoU > iou_t with it.
// Its plain PyTorch version is ops/nms_cuda.py:nms_keep_mask_shared_reference.
//
// What bounds it: not bytes (an image reads K*(4+C)*4 bytes, 21 KB at the
// serving shape K=64, C=80) but the latency of the greedy, which is
// sequential within a class. The design keeps every step of that chain on
// chip and short:
//   - one CTA per image; the CTA builds the image's IoU>t mask once into
//     shared memory as K rows of ceil(K/32) 32-bit words, one __ballot_sync
//     per word, and all classes of the image reuse it;
//   - one warp per class (classes stride over the CTA's warps); lane l owns
//     candidates l, l+32, ... and holds their scores and alive/kept bits in
//     registers;
//   - the greedy is an argmax loop, not a sort: pick the best alive
//     candidate (a 5-step shuffle reduction on (score, index)), keep it,
//     clear every alive candidate whose mask bit with it is set (one
//     broadcast shared-memory word per lane), repeat while any lane has an
//     alive candidate. The loop runs once per kept box, so a class with no
//     valid candidate costs one warp vote.
// The Pallas kernel's class chunks, SMEM activity table and image blocks
// are TPU mechanics and are not carried over.
//
// Arithmetic: the IoU is inter / (area_i + area_j - inter + 1e-10f) in the
// order ops/boxes.py:iou_xyxy evaluates it, built with --fmad=false (no FMA
// contraction) and IEEE division, and min/max propagate NaN as torch's do,
// so every IoU>t bit equals the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ bool iou_over(const float4 a, const float4 b,
                                         float iou_t) {
  float iw = max_nan(min_nan(a.z, b.z) - max_nan(a.x, b.x), 0.0f);
  float ih = max_nan(min_nan(a.w, b.w) - max_nan(a.y, b.y), 0.0f);
  float inter = iw * ih;
  float area_a = (a.z - a.x) * (a.w - a.y);
  float area_b = (b.z - b.x) * (b.w - b.y);
  return inter / (area_a + area_b - inter + 1e-10f) > iou_t;
}

// MAXT: compile-time bound on the candidates a lane owns (ceil(K/32)), so
// the per-lane arrays stay in registers.
template <int MAXT>
__global__ void __launch_bounds__(kThreads)
nms_shared_kernel(const float* __restrict__ boxes,
                  const float* __restrict__ scores,
                  uint8_t* __restrict__ keep, int K, int C, float iou_t,
                  float score_t) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = (K + 31) / 32;                 // mask words per row
  float4* sbox = reinterpret_cast<float4*>(smem);
  uint32_t* mask = smem + 4 * K;               // [K][T]
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float4* gbox = reinterpret_cast<const float4*>(boxes) + (size_t)b * K;
  for (int i = threadIdx.x; i < K; i += kThreads) sbox[i] = gbox[i];
  __syncthreads();

  // IoU>t mask: word (i, t) holds bit l for candidate j = 32t + l
  for (int w = warp; w < K * T; w += kWarps) {
    const int i = w / T;
    const int j = (w % T) * 32 + lane;
    const bool over = j < K && iou_over(sbox[i], sbox[j], iou_t);
    const uint32_t bits = __ballot_sync(kFull, over);
    if (lane == 0) mask[w] = bits;
  }
  __syncthreads();

  const float* gsc = scores + (size_t)b * K * C;
  for (int c = warp; c < C; c += kWarps) {
    float s[MAXT];
    uint32_t alive = 0, kept = 0;              // bit t: candidate lane + 32t
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      const int j = t * 32 + lane;
      s[t] = (t < T && j < K) ? __ldg(gsc + (size_t)j * C + c) : 0.0f;
      if (t < T && j < K && s[t] >= score_t) alive |= 1u << t;
    }
    while (__any_sync(kFull, alive != 0)) {
      // best alive candidate: highest score, ties to the lower index
      float bs = 0.0f;
      int bi = 0x7fffffff;
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        if ((alive >> t) & 1u) {
          if (bi == 0x7fffffff || s[t] > bs) {  // t ascending: index ascending
            bs = s[t];
            bi = t * 32 + lane;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(kFull, bs, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (oi != 0x7fffffff &&
            (bi == 0x7fffffff || os > bs || (os == bs && oi < bi))) {
          bs = os;
          bi = oi;
        }
      }
      const int bt = bi >> 5;
      if ((bi & 31) == lane) {
        kept |= 1u << bt;
        alive &= ~(1u << bt);
      }
      const uint32_t* row = mask + bi * T;
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        if (t < T && ((row[t] >> lane) & 1u)) alive &= ~(1u << t);
      }
    }
    uint8_t* out = keep + ((size_t)b * C + c) * K;
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      const int j = t * 32 + lane;
      if (t < T && j < K) out[j] = (kept >> t) & 1u;
    }
  }
}

template <int MAXT>
cudaError_t launch(const float* boxes, const float* scores, uint8_t* keep,
                   int B, int K, int C, float iou_t, float score_t,
                   cudaStream_t stream) {
  const int T = (K + 31) / 32;
  const size_t smem = sizeof(float4) * K + sizeof(uint32_t) * K * T;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_shared_kernel<MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  nms_shared_kernel<MAXT><<<B, kThreads, smem, stream>>>(
      boxes, scores, keep, K, C, iou_t, score_t);
  return cudaGetLastError();
}

}  // namespace

// boxes [B, K, 4] f32, scores [B, K, C] f32, keep [B, C, K] uint8/bool, all
// contiguous on one device; 1 <= K <= 1024. Launches on `stream` and does
// not synchronize. Returns the launch's cudaError_t (0 on success).
extern "C" int nms_shared_launch(const void* boxes, const void* scores,
                                 void* keep, int B, int K, int C, float iou_t,
                                 float score_t, void* stream) {
  if (B <= 0 || C <= 0 || K <= 0 || K > 1024)
    return (int)cudaErrorInvalidValue;
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  uint8_t* kp = static_cast<uint8_t*>(keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = (K + 31) / 32;
  cudaError_t e;
  if (T <= 2)
    e = launch<2>(bx, sc, kp, B, K, C, iou_t, score_t, st);
  else if (T <= 8)
    e = launch<8>(bx, sc, kp, B, K, C, iou_t, score_t, st);
  else
    e = launch<32>(bx, sc, kp, B, K, C, iou_t, score_t, st);
  return (int)e;
}
