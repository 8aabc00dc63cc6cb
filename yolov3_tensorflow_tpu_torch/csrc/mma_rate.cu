// Tensor-core rate probe: a chain of dependent bf16 products with fp32
// accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/exp_mxu_shapes.py:_rate_kernel (driven by
// mxu_rate). Same result: o = sum over r < reps of a . b, a [M, K] and
// b [K, N] bf16, o [M, N] fp32. The Pallas kernel scales b by
// s_r = bf16(1 + acc[0, 0] * 1e-30) in every pass, which is exactly 1.0 for
// any finite acc below 1e27: it is there only to keep XLA from folding the
// chain. Here the chain is kept honest another way: every product is an
// `asm volatile` mma.sync whose accumulators are its own inputs, so no
// pass can be dropped, hoisted or merged, and the caller checks that
// doubling `reps` doubles the time. The plain PyTorch version
// (scripts/exp_mxu_shapes.py:mma_chain_reference) keeps the s_r scale.
//
// What bounds it: tensor-core issue and the shared-memory bandwidth that
// feeds it. The operands are read from device memory once per CTA; all
// `reps` passes then run out of shared memory and registers, so the
// product rate at these small contraction widths is what is measured, not
// HBM. Each m16n8k16 product takes its A fragment (512 B) and B fragment
// (256 B) from shared memory through ldmatrix, shared across the warp
// tile: a 32 x 32 warp tile reads 256 B of shared memory per product.
// The design:
//   - one CTA (8 warps) per 64 x BN output tile. It stages its whole A row
//     strip [64, K] and B column strip [K, BN] in shared memory once, K
//     zero-padded to a multiple of 16 (k = 108 becomes 112; the FLOP count
//     stays at the true K), rows padded by 16 bytes so that ldmatrix reads
//     hit 32 distinct banks. The TPU's 1024-row VMEM tiles do not fit in
//     227 KB, so BN is chosen per shape by the wrapper (128, 64 or 32: the
//     largest that divides N and fits), with the dynamic shared-memory
//     limit raised above 48 KB;
//   - warps tile the 64 x BN output 2 x 4 (BN 128 or 64) or 4 x 2 (BN 32);
//     each sums a pass's products in tensor-core accumulators, adds them to
//     a running total in registers (fp32, round to nearest, as the TPU
//     kernel's acc + dot), and writes the total once at the end;
//   - mma.sync m16n8k16 bf16 -> fp32, A from ldmatrix.x4, B (stored [K, N],
//     N contiguous) from ldmatrix.x4.trans. wgmma and TMA are not used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;          // output rows per CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;          // bf16 elements (16 bytes) of row padding

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned& r0,
                                              unsigned& r1, unsigned& r2,
                                              unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

size_t smem_bytes(int kp, int bn) {
  return (size_t(kBM) * (kp + kPad) + size_t(kp) * (bn + kPad)) * 2;
}

template <int BN, int WARPS_M>
__global__ void __launch_bounds__(kThreads)
    mma_chain_kernel(const uint16_t* __restrict__ a,
                     const uint16_t* __restrict__ b, float* __restrict__ o,
                     int K, int N, int Kp, int reps) {
  constexpr int WARPS_N = kWarps / WARPS_M;
  constexpr int WM = kBM / WARPS_M;          // warp tile rows: 32 or 16
  constexpr int WN = BN / WARPS_N;           // warp tile columns
  constexpr int MI = WM / 16;                // m16 tiles per warp
  constexpr int NI = WN / 8;                 // n8 tiles per warp
  static_assert(NI % 2 == 0, "B fragments are loaded two n8 tiles at a time");

  extern __shared__ __align__(16) uint16_t smem[];
  const int lda = Kp + kPad;
  const int ldb = BN + kPad;
  uint16_t* sa = smem;                       // [kBM][lda]
  uint16_t* sb = smem + kBM * lda;           // [Kp][ldb]
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // ---- stage the A row strip and the B column strip, zero past K ----
  // The A strip is one contiguous run of 64 * K elements (a multiple of 8),
  // read as 16-byte vectors; when K % 8 != 0 a vector may straddle two
  // rows and is stored in 8-byte halves (K % 4 == 0, as K = 108) or
  // element by element.
  const uint4* ga = reinterpret_cast<const uint4*>(a + size_t(m0) * K);
  if ((K & 7) == 0) {
    const int vpr = K / 8;
#pragma unroll 4
    for (int i = tid; i < kBM * vpr; i += kThreads) {
      const int r = i / vpr, v = i - r * vpr;
      *reinterpret_cast<uint4*>(sa + r * lda + v * 8) = ga[i];
    }
  } else if ((K & 3) == 0) {
#pragma unroll 4
    for (int i = tid; i < kBM * K / 8; i += kThreads) {
      const uint4 v = ga[i];
      int r = (i * 8) / K, c = i * 8 - r * K;
      *reinterpret_cast<uint2*>(sa + r * lda + c) = make_uint2(v.x, v.y);
      if ((c += 4) == K) c = 0, ++r;
      *reinterpret_cast<uint2*>(sa + r * lda + c) = make_uint2(v.z, v.w);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < kBM * K / 8; i += kThreads) {
      const uint4 v = ga[i];
      const uint16_t* h = reinterpret_cast<const uint16_t*>(&v);
      int r = (i * 8) / K, c = i * 8 - r * K;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sa[r * lda + c] = h[j];
        if (++c == K) c = 0, ++r;
      }
    }
  }
  for (int i = tid; i < kBM * (Kp - K); i += kThreads) {
    const int r = i / (Kp - K), c = K + i - r * (Kp - K);
    sa[r * lda + c] = 0;
  }
  constexpr int kVecB = BN / 8;
#pragma unroll 4
  for (int i = tid; i < Kp * kVecB; i += kThreads) {
    const int r = i / kVecB, v = i - r * kVecB;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < K)
      val = *reinterpret_cast<const uint4*>(b + size_t(r) * N + n0 + v * 8);
    *reinterpret_cast<uint4*>(sb + r * ldb + v * 8) = val;
  }
  __syncthreads();

  // ---- the chain: reps passes over K, accumulators in registers ----
  // Each pass sums its products in fresh registers and adds them to the
  // running total (round to nearest), as the TPU kernel's acc + dot(...)
  // does: 64 passes into one tensor-core accumulator would drift by up to
  // 1e-4 of the total at K = 1024 (tensor-core adds do not round to
  // nearest), close to the tolerance the card check holds the kernel to.
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int lrow = lane % 16, lcol = (lane / 16) * 8;
  const unsigned a_base = smem_addr(sa + (wm * WM + lrow) * lda + lcol);
  const unsigned b_base = smem_addr(sb + lrow * ldb + wn * WN + lcol);
  float acc[MI][NI][4];
  float part[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int ksteps = Kp / 16;
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
    for (int kk = 0; kk < ksteps; ++kk) {
      unsigned af[MI][4];
      unsigned bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(a_base + 2u * unsigned(mi * 16 * lda + kk * 16), af[mi]);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj)
        ldsm_x4_trans(b_base + 2u * unsigned(kk * 16 * ldb + nj * 16),
                      bf[2 * nj][0], bf[2 * nj][1], bf[2 * nj + 1][0],
                      bf[2 * nj + 1][1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16(part[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }

  // ---- write the tile once ----
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int row = m0 + wm * WM + mi * 16 + g;
      const int col = n0 + wn * WN + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(o + size_t(row) * N + col) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(o + size_t(row + 8) * N + col) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

template <int BN, int WARPS_M>
int launch(const void* a, const void* b, void* o, int M, int K, int N,
           int reps, cudaStream_t stream) {
  const int kp = (K + 15) / 16 * 16;
  const size_t smem = smem_bytes(kp, BN);
  cudaError_t e = cudaFuncSetAttribute(
      mma_chain_kernel<BN, WARPS_M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  dim3 grid(M / kBM, N / BN);
  mma_chain_kernel<BN, WARPS_M><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<float*>(o), K, N, kp, reps);
  return int(cudaGetLastError());
}

}  // namespace

// o[M, N] fp32 = reps * (a[M, K] . b[K, N]), a and b bf16, all row-major
// and 16-byte aligned. The caller picks bn (128, 64 or 32) such that
// M % 64 == 0, N % bn == 0 and the strips fit in shared memory.
extern "C" int mma_chain_launch(const void* a, const void* b, void* o, int M,
                                int K, int N, int reps, int bn,
                                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || reps < 0 || M % kBM != 0 ||
      N % bn != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 128: return launch<128, 2>(a, b, o, M, K, N, reps, s);
    case 64: return launch<64, 2>(a, b, o, M, K, N, reps, s);
    case 32: return launch<32, 4>(a, b, o, M, K, N, reps, s);
    default: return int(cudaErrorInvalidValue);
  }
}
