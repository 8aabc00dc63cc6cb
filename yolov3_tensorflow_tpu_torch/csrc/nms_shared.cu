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
// serving shape K=64, C=80) and not operations, but latency: the greedy is
// sequential within a class, and a request holds few images (8 at the small
// request). The design spreads the work and keeps every chain short
// (choices measured on an H100 with scripts/compare_revisions.py and
// scripts/k1_phases.py, PERF.md):
//   - S CTAs per image (ops/nms_cuda.py:shared_plan: S = 8 at a batch of
//     8, 1 at 128), CTA r owning a slice of ceil(C / S) classes, one warp
//     per class at a time; 32 warps a CTA up to K = 256 (16 above);
//   - the image's IoU>t mask (K rows of ceil(K/32) 32-bit words, one warp
//     ballot per word, a warp a row at a time) is built by every CTA up to
//     K = 64 (2,016 IoU tests); above, the S CTAs form a cluster, CTA r
//     builds rows [r*R, (r+1)*R) and reads the others from its peers'
//     shared memory after a cluster barrier;
//   - the CTA's slice of scores is staged into shared memory with 4-byte
//     cp.async copies issued first thing, so they land while the boxes
//     load and the mask is built; it lands as [K][P] with an odd row pitch P,
//     so a warp reading one class column (lane l: candidate l + 32t)
//     touches 32 banks. Where the slice does not fit beside the mask
//     (K = 1024 and many classes) it is staged a chunk of classes at a time;
//   - the greedy is an argmax loop, once per kept box: the best alive
//     candidate by two warp reductions (redux.sync: the largest
//     order-preserving score key, then the lowest index holding it), then
//     its mask row clears the candidates it suppresses. At the serving
//     candidates a class keeps 1.3 boxes on average, so the loop is short;
//     a rank-mask fixpoint (the Pallas kernel's form) measured 4% slower;
//   - a class with no valid candidate costs one vote; keep bytes are
//     written four to a 32-bit store.
// The Pallas kernel's class chunks of 16, SMEM activity table and image
// blocks are TPU mechanics and are not carried over.
//
// Arithmetic: the IoU is inter / (area_i + area_j - inter + 1e-10f) in the
// order ops/boxes.py:iou_xyxy evaluates it, built with --fmad=false (no FMA
// contraction) and IEEE division, and min/max propagate NaN as torch's do,
// so every IoU>t bit equals the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef K1_PHASES
// Phase stamps, for scripts/k1_phases.py only (a build with -DK1_PHASES):
// thread 0 of CTA n writes %globaltimer at entry and exit (slots 0, 7) and
// clock64 at entry, at each phase's end and at exit (slots 1-6). A phase
// that ends in K1_PHASE ends with a CTA barrier, so its stamp is the
// CTA's, not thread 0's; the barriers make this build slower.
constexpr int kStampCtas = 16384;
__device__ unsigned long long k1_stamps[kStampCtas][8];
#define K1_STAMP(k, v)                                                \
  do {                                                                \
    if (threadIdx.x == 0 && blockIdx.x < kStampCtas)                  \
      k1_stamps[blockIdx.x][k] = (v);                                 \
  } while (0)
#define K1_GTIME(k)                                                   \
  do {                                                                \
    unsigned long long t_;                                            \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));            \
    K1_STAMP(k, t_);                                                  \
  } while (0)
#define K1_CLOCK(k) K1_STAMP(k, clock64())
#define K1_PHASE(k) \
  do {              \
    __syncthreads(); \
    K1_CLOCK(k);    \
  } while (0)
#else
#define K1_GTIME(k) do {} while (0)
#define K1_CLOCK(k) do {} while (0)
#define K1_PHASE(k) do {} while (0)
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
// warps per CTA: 32 where a lane holds at most 8 candidates (K <= 256), 16
// above, where the argmax's 32 keys a lane need more than 64 registers
constexpr int max_threads(int tmax) { return tmax <= 8 ? 1024 : 512; }
constexpr size_t kSmemLimit = 232448;     // 227 KB, a CTA's opt-in maximum

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

// an unsigned key in the order of the scores (both zeros equal); a NaN
// score is never valid, so no key of a valid score is 0
__device__ __forceinline__ uint32_t score_key(float s) {
  const uint32_t u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the word at this CTA's shared address `local`, in cluster CTA `rank`
__device__ __forceinline__ uint32_t ld_cluster(const uint32_t* local,
                                               uint32_t rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// classes [c0, c0 + cn) of the image's scores [K][C] into ssc [K][P],
// asynchronously (cp.async, one committed group): a warp a row at a time,
// lanes along the row's classes
__device__ __forceinline__ void stage_scores(float* ssc, const float* gsc,
                                             int K, int C, int c0, int cn,
                                             int P) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < K; j += blockDim.x >> 5)
    for (int cl = lane; cl < cn; cl += 32)
      cp_async4(ssc + j * P + cl, gsc + (size_t)j * C + c0 + cl);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// keep bytes of one class from its kept words (kw[t]: candidates 32t..,
// the same in every lane): lane l writes candidates 4l'..4l'+3 of word
// t0 + l / 8 as one 32-bit store where K allows
template <int TMAX>
__device__ __forceinline__ void write_keep(uint8_t* out, const uint32_t* kw,
                                           int K, int T, int lane) {
#pragma unroll
  for (int t0 = 0; t0 < TMAX; t0 += 4) {
    const int u = lane >> 3;
    const int t = t0 + u;
    uint32_t w = 0;
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (v == u && t0 + v < TMAX) w = kw[t0 + v];
    const int j0 = t * 32 + 4 * (lane & 7);
    if (t < T && j0 < K) {
      const uint32_t nib = (w >> (4 * (lane & 7))) & 0xfu;
      if ((K & 3) == 0) {
        *reinterpret_cast<uint32_t*>(out + j0) =
            (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
            ((nib & 8u) << 21);
      } else {
        for (int q = 0; q < 4 && j0 + q < K; ++q)
          out[j0 + q] = (nib >> q) & 1u;
      }
    }
  }
}

// One class: the argmax loop, once per kept box. sc: the class's column
// of staged scores (stride P). Lane l holds the order keys of candidates
// l + 32t and a bit of each that is still alive.
template <int TMAX>
__device__ __forceinline__ void decide(const float* sc, int P,
                                       const uint32_t* mask, int K, int T,
                                       float score_t, int lane, uint8_t* out) {
  uint32_t key[TMAX];
  uint32_t alive = 0, kept = 0;             // bit t: candidate 32t + lane
#pragma unroll
  for (int t = 0; t < TMAX; ++t) {
    const int j = t * 32 + lane;
    const float s = (t < T && j < K) ? sc[j * P] : 0.0f;
    key[t] = score_key(s);
    if (t < T && j < K && s >= score_t) alive |= 1u << t;
  }
  if (!__any_sync(kFull, alive)) {          // no valid candidate: one vote
    const uint32_t none[TMAX] = {};
    write_keep<TMAX>(out, none, K, T, lane);
    return;
  }
  for (;;) {
    // my best alive candidate: t ascending, so a tie keeps my lower index
    uint32_t mine = 0, idx = ~0u;
#pragma unroll
    for (int t = 0; t < TMAX; ++t) {
      if (((alive >> t) & 1u) && key[t] > mine) {
        mine = key[t];
        idx = t * 32 + lane;
      }
    }
    const uint32_t best = __reduce_max_sync(kFull, mine);
    if (best == 0) break;                     // nothing alive
    const uint32_t win = __reduce_min_sync(kFull, mine == best ? idx : ~0u);
    if ((int)(win & 31) == lane) {
      kept |= 1u << (win >> 5);
      alive &= ~(1u << (win >> 5));           // a zero-area box overlaps
    }                                         // nothing, itself included
    const uint32_t* row = mask + win * T;
#pragma unroll
    for (int t = 0; t < TMAX; ++t)
      if (t < T && ((row[t] >> lane) & 1u)) alive &= ~(1u << t);
  }
  uint32_t kw[TMAX];
#pragma unroll
  for (int t = 0; t < TMAX; ++t)
    kw[t] = __ballot_sync(kFull, (kept >> t) & 1u);
  write_keep<TMAX>(out, kw, K, T, lane);
}

// TMAX: compile-time bound on ceil(K/32), the candidates a lane owns.
// Grid: B * S CTAs; CTA r = blockIdx.x % S of image b = blockIdx.x / S owns
// classes [r*Cs, min(C, (r+1)*Cs)), staged Cc at a time with row pitch P.
// With `shared` the S CTAs of an image are one cluster and share the mask
// (CTA r builds rows [r*R, (r+1)*R)); without, each CTA builds all of it.
template <int TMAX>
__global__ void __launch_bounds__(max_threads(TMAX))
nms_shared_kernel(const float* __restrict__ boxes,
                  const float* __restrict__ scores,
                  uint8_t* __restrict__ keep, int K, int C, float iou_t,
                  float score_t, int S, int shared, int Cs, int Cc, int P) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = (K + 31) >> 5;                // mask words per row
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(smem + 4 * K);
  uint32_t* mask = smem + 5 * K;              // [K][T]
  float* ssc = reinterpret_cast<float*>(mask + K * T);  // [K][P]
  const int rank = blockIdx.x % S;            // the CTA's slice (cluster rank)
  const int b = blockIdx.x / S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int c_begin = min(C, rank * Cs);
  const int c_end = min(C, c_begin + Cs);
  const float* gsc = scores + (size_t)b * K * C;
  K1_GTIME(0);
  K1_CLOCK(1);

  if (c_begin < c_end)
    stage_scores(ssc, gsc, K, C, c_begin, min(Cc, c_end - c_begin), P);
  const float4* gbox = reinterpret_cast<const float4*>(boxes) + (size_t)b * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float4 bx = gbox[i];
    sbox[i] = bx;
    sarea[i] = (bx.z - bx.x) * (bx.w - bx.y);
  }
  __syncthreads();
  K1_CLOCK(2);

  // this CTA's rows of the IoU>t mask, a warp a row at a time: word (i, t),
  // bit l: candidate j = 32t + l; the T tests of a row are independent
  const int rows = shared ? (K + S - 1) / S : K;
  const int r0 = shared ? min(K, rank * rows) : 0;
  const int r1 = min(K, r0 + rows);
  float4 cb[TMAX];                            // at K <= 64 a lane's columns
  float ca[TMAX];                             // stay in registers
  if constexpr (TMAX == 2) {
#pragma unroll
    for (int t = 0; t < TMAX; ++t) {
      const int j = t * 32 + lane;
      cb[t] = (t < T && j < K) ? sbox[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      ca[t] = (t < T && j < K) ? sarea[j] : 0.f;
    }
  }
#pragma unroll 2
  for (int i = r0 + warp; i < r1; i += warps) {
    const float4 a = sbox[i];
    const float aa = sarea[i];
#pragma unroll
    for (int t = 0; t < TMAX; ++t) {
      const int j = t * 32 + lane;
      if (t < T) {
        bool over = false;
        if (j < K) {
          if constexpr (TMAX == 2)
            over = iou_over(a, aa, cb[t], ca[t], iou_t);
          else
            over = iou_over(a, aa, sbox[j], sarea[j], iou_t);
        }
        const uint32_t bits = __ballot_sync(kFull, over);
        if (lane == 0) mask[i * T + t] = bits;
      }
    }
  }
  K1_PHASE(3);
  if (shared) {
    cluster_sync();                           // every CTA's rows are written
    for (int p = 0; p < S; ++p) {
      if (p == rank) continue;
      const int q1 = min(K, p * rows + rows) * T;
      for (int q = min(K, p * rows) * T + threadIdx.x; q < q1;
           q += blockDim.x)
        mask[q] = ld_cluster(mask + q, p);
    }
    cluster_arrive();                         // peers may exit after the wait
  }
  cp_async_wait_all();
  __syncthreads();
  K1_CLOCK(4);

  for (int c0 = c_begin; c0 < c_end; c0 += Cc) {
    const int cn = min(Cc, c_end - c0);
    if (c0 != c_begin) {                      // the next chunk of classes
      __syncthreads();
      stage_scores(ssc, gsc, K, C, c0, cn, P);
      cp_async_wait_all();
      __syncthreads();
    }
    for (int cl = warp; cl < cn; cl += warps) {
      uint8_t* out = keep + ((size_t)b * C + c0 + cl) * K;
      decide<TMAX>(ssc + cl, P, mask, K, T, score_t, lane, out);
    }
  }
  K1_PHASE(5);
  if (shared) cluster_wait();
  K1_CLOCK(6);
  K1_GTIME(7);
}

template <int TMAX>
cudaError_t launch(const float* boxes, const float* scores, uint8_t* keep,
                   int B, int K, int C, float iou_t, float score_t, int S,
                   int shared, int warps, int Cs, int Cc, int P, size_t smem,
                   cudaStream_t stream) {
  static size_t opted = 48 * 1024;            // dynamic bytes allowed so far
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_shared_kernel<TMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  if (!shared) {
    nms_shared_kernel<TMAX><<<B * S, warps * 32, smem, stream>>>(
        boxes, scores, keep, K, C, iou_t, score_t, S, 0, Cs, Cc, P);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * S);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, nms_shared_kernel<TMAX>, boxes,
                                     scores, keep, K, C, iou_t, score_t, S, 1,
                                     Cs, Cc, P);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// boxes [B, K, 4] f32, scores [B, K, C] f32, keep [B, C, K] uint8/bool, all
// contiguous on one device, boxes 16-byte and keep 4-byte aligned;
// 1 <= K <= 1024. The plan (S CTAs per image, sharing the mask as one
// cluster or not, warps per CTA, classes per CTA Cs, classes staged at a
// time Cc, score row pitch P) comes from ops/nms_cuda.py:shared_plan; it is
// checked here. Launches on `stream` and does not synchronize. Returns the
// launch's cudaError_t (0 on success).
extern "C" int nms_shared_launch(const void* boxes, const void* scores,
                                 void* keep, int B, int K, int C, float iou_t,
                                 float score_t, int S, int shared, int warps,
                                 int Cs, int Cc, int P, void* stream) {
  if (B <= 0 || C <= 0 || K <= 0 || K > 1024 || S < 1 ||
      (shared && S != 2 && S != 4 && S != 8) || warps < 1 ||
      warps * 32 > max_threads(K <= 256 ? 8 : 32) || Cs < 1 ||
      (long long)Cs * S < C ||
      Cc < 1 || Cc > Cs || P < Cc || (long long)B * S > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int T = (K + 31) / 32;
  const size_t smem = sizeof(float) * (5 * (size_t)K + (size_t)K * T +
                                       (size_t)K * P);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  uint8_t* kp = static_cast<uint8_t*>(keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (T <= 2)
    e = launch<2>(bx, sc, kp, B, K, C, iou_t, score_t, S, shared, warps, Cs,
                  Cc, P, smem, st);
  else if (T <= 8)
    e = launch<8>(bx, sc, kp, B, K, C, iou_t, score_t, S, shared, warps, Cs,
                  Cc, P, smem, st);
  else
    e = launch<32>(bx, sc, kp, B, K, C, iou_t, score_t, S, shared, warps, Cs,
                   Cc, P, smem, st);
  return (int)e;
}

#ifdef K1_PHASES
// copies the stamps of the first n CTAs of the last launch to dst (host,
// n x 8 uint64); returns the cudaError_t
extern "C" int nms_shared_phases(void* dst, int n) {
  if (n < 0 || n > kStampCtas) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(dst, k1_stamps, sizeof(k1_stamps[0]) * n);
}
#endif
