// Tensor-core rate probe: a chain of dependent bf16 products with fp32
// accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/exp_mxu_shapes.py:_rate_kernel (driven by
// mxu_rate). Same result: o = sum over r < reps of a . b, a [M, K] and
// b [K, N] bf16, o [M, N] fp32. The Pallas kernel scales b by
// s_r = bf16(1 + acc[0, 0] * 1e-30) in every pass, which is exactly 1.0 for
// any finite acc below 1e27: it is there only to keep XLA from folding the
// chain. Here the chain is kept honest another way: every product is an
// `asm volatile` wgmma whose accumulators are its own outputs, so no pass
// can be dropped, hoisted or merged, and the caller checks that doubling
// `reps` doubles the time. The plain PyTorch version
// (scripts/exp_mxu_shapes.py:mma_chain_reference) keeps the s_r scale.
//
// What bounds it on this card: the bf16 tensor-core rate (989 TF/s dense on
// an H100 SXM). The operands are read from device memory once per CTA; all
// `reps` passes then run out of shared memory and registers, so what is
// measured is the product rate at these small contraction widths, not HBM.
// Only wgmma reaches Hopper's full tensor-core rate: mma.sync fed through
// ldmatrix reads at most 436 TF/s at these shapes (PERF.md).
// The design:
//   - products: wgmma.mma_async m64n64k16 f32 += bf16 x bf16, both
//     operands read from shared memory through matrix descriptors in the
//     128-byte-swizzled canonical layouts: A K-major as it lies in memory,
//     B [K, N] N-major (MN-major, the transpose bit), so no copy transposes
//     it;
//   - tiles: a CTA of two warpgroups owns 128 rows x 64 columns (each
//     warpgroup 64 rows), and stages its A row strip and B column strip
//     once: 384 bytes per K element, so K <= 576 fits in 227 KB. Above
//     that a cluster of 2 or 4 CTAs splits K: each CTA runs every pass over
//     its share of K, and at the end the leader adds the others' totals,
//     read from their shared memory (DSMEM), in rank order.
//     scripts/exp_mxu_shapes.py:mma_tile chooses the split. Measured in
//     one call (PERF.md), 64 columns beat 128 with a split at every K >=
//     512 (by up to 26% at K = 1024) and tie with 128 below: the wider tile
//     reads A once for more columns, but no longer fits without a split;
//   - staging: TMA (cp.async.bulk.tensor, 64 x 128 boxes for A, 64 x 64 for
//     B, 128-byte swizzle, completion on one mbarrier), the tensor maps
//     encoded on the host by cuTensorMapEncodeTiled reached through
//     cudaGetDriverEntryPoint (no -lcuda link). TMA needs a row stride that
//     is a multiple of 16 bytes; A rows of K = 108 are 216 bytes, so such an
//     A is staged by thread copies into the same swizzled layout. K is
//     padded with zeros to the next multiple of 16 (TMA's out-of-bounds
//     fill, or the copies'); the FLOP count stays at the true K;
//   - accumulation: each pass sums its products in fresh accumulators (the
//     first k-step has scale-d = 0) and adds them to a running total in
//     registers with a round-to-nearest fp32 add, as the TPU kernel's
//     acc + dot does: tensor-core sums do not round to nearest, and one
//     accumulator over 64 passes drifted to 1e-4 of the total at K = 1024;
//   - overlap: while one warpgroup adds its pass into its total, the other
//     warpgroup's products keep the tensor cores busy, and at small K two
//     CTAs share an SM. Pass and total take 64 fp32 registers a thread.

#include <cuda.h>          // CUtensorMap and its enums: types only
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;             // output rows per CTA (2 warpgroups)
constexpr int kBN = 64;              // output columns per CTA
constexpr int kAcc = kBN / 2;        // fp32 accumulators a thread, a set
constexpr int kThreads = 256;
constexpr int kBK = 64;              // K elements in one 128-byte row
constexpr int kATile = kBM * 128;    // bytes of A per 64-wide K block
constexpr int kBTile = kBK * 128;    // bytes of B per 64 x 64 block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr >> 4) & 0x3FFF) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64]: A K-major, B N-major (trans-b 1);
// scale_d 0 drops d's old value
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of `x` above the wgmma wait
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// waits for the barrier's phase `parity` to complete; traps (a launch
// error, not a hung card) if the copies have not landed after ~10 s
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > 20000000000LL) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t local, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// Stages this CTA's A strip (rows m0.., K elements k0.. of nkb 64-wide
// blocks) by thread copies, in the layout TMA's 128-byte swizzle writes:
// 16-byte chunk c of row r of a block at chunk c ^ (r % 8). Elements at or
// past K are zero.
__device__ void stage_a_by_threads(uint8_t* sa, const uint16_t* __restrict__ a,
                                   int K, int m0, int k0, int nkb) {
  const int chunks = kBM * nkb * 8;
  for (int q = threadIdx.x; q < chunks; q += kThreads) {
    const int r = q / (nkb * 8), c = q - r * (nkb * 8);
    const int e = k0 + c * 8;
    const uint16_t* row = a + size_t(m0 + r) * K;
    uint16_t v[8];
    if ((K & 3) == 0) {                    // 8-byte aligned groups of 4
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint2 u = make_uint2(0, 0);
        if (e + 4 * h < K) u = *reinterpret_cast<const uint2*>(row + e + 4 * h);
        v[4 * h + 0] = u.x & 0xffff;
        v[4 * h + 1] = u.x >> 16;
        v[4 * h + 2] = u.y & 0xffff;
        v[4 * h + 3] = u.y >> 16;
      }
    } else {
#pragma unroll
      for (int h = 0; h < 8; ++h) v[h] = e + h < K ? row[e + h] : 0;
    }
    const int kb = c / 8, cc = c % 8;
    uint4 packed;
    packed.x = v[0] | (uint32_t(v[1]) << 16);
    packed.y = v[2] | (uint32_t(v[3]) << 16);
    packed.z = v[4] | (uint32_t(v[5]) << 16);
    packed.w = v[6] | (uint32_t(v[7]) << 16);
    *reinterpret_cast<uint4*>(sa + kb * kATile + r * 128 +
                              ((cc ^ (r & 7)) * 16)) = packed;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    mma_chain_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const uint16_t* __restrict__ a, float* __restrict__ o,
                     int K, int N, int kc, int reps, int a_by_tma) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_storage;
  // the swizzled layouts repeat every 1024 bytes: align the strips to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                        // [kc / 64][128 rows][128 B]
  uint8_t* sb = smem + (kc / kBK) * kATile;  // [kc lines][128 B]
  const uint32_t bar = smem_u32(&bar_storage);

  const int tid = threadIdx.x;
  const int splits = gridDim.x;
  const int rank = splits > 1 ? int(cluster_rank()) : 0;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.z * kBN;
  const int k0 = rank * kc;
  const int klen = min(kc, K - k0);
  const int nkb = (klen + kBK - 1) / kBK;
  const int ksteps = (klen + 15) / 16;

  // ---- stage the strips once ----
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, (a_by_tma ? nkb * kATile : 0) + nkb * kBTile);
    for (int kb = 0; kb < nkb; ++kb) {
      if (a_by_tma)
        tma_load_2d(smem_u32(sa + kb * kATile), &map_a, k0 + kb * kBK, m0,
                    bar);
      tma_load_2d(smem_u32(sb + kb * kBTile), &map_b, n0, k0 + kb * kBK,
                  bar);
    }
  }
  if (!a_by_tma) stage_a_by_threads(sa, a, K, m0, k0, nkb);
  __syncthreads();
  mbar_wait(bar, 0);

  // ---- the chain: reps passes over this CTA's K ----
  const int wg = tid / 128;
  const uint32_t a_base = smem_u32(sa) + wg * 64 * 128;
  const uint32_t b_base = smem_u32(sb);
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = part[j] = 0.f;
  for (int r = 0; r < reps; ++r) {
    wgmma_fence();
    for (int s = 0; s < ksteps; ++s) {
      // A: K-major, step 16 = 32 bytes inside a 128-byte row, next 64-wide
      // block a tile further; 8-row groups 1024 bytes apart
      const uint64_t da = desc_sw128(
          a_base + (s >> 2) * kATile + (s & 3) * 32, 16, 1024);
      // B: N-major, step 16 = 16 lines of 128 bytes (64 columns each),
      // 8-line groups 1024 bytes apart; one 64-column atom, so the leading
      // offset (between atoms) is never used
      const uint64_t db = desc_sw128(b_base + s * 2048, kc * 128, 1024);
      wgmma_n64(part, da, db, s > 0);
    }
    wgmma_commit_and_wait();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      fence_operand(part[j]);
      acc[j] += part[j];
    }
  }

  // ---- a K split: the leader adds the others' totals, in rank order ----
  if (splits > 1) {
    float* red = reinterpret_cast<float*>(smem);   // [kAcc][kThreads]
    __syncthreads();                               // strips no longer read
    if (rank != 0) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) red[j * kThreads + tid] = acc[j];
    }
    cluster_sync();
    if (rank == 0) {
      const uint32_t local = smem_u32(red);
      for (int p = 1; p < splits; ++p) {
#pragma unroll
        for (int j = 0; j < kAcc; ++j)
          acc[j] += ld_cluster(local + 4u * (j * kThreads + tid), p);
      }
    }
    cluster_sync();                                // peers may now exit
    if (rank != 0) return;
  }

  // ---- write the tile once ----
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j8 = 0; j8 < kBN / 8; ++j8) {
    const int col = n0 + j8 * 8 + 2 * (lane % 4);
    *reinterpret_cast<float2*>(o + size_t(row) * N + col) =
        make_float2(acc[4 * j8], acc[4 * j8 + 1]);
    *reinterpret_cast<float2*>(o + size_t(row + 8) * N + col) =
        make_float2(acc[4 * j8 + 2], acc[4 * j8 + 3]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [outer, inner] bf16 tensor, boxes of [box_outer, 64],
// 128-byte swizzle, zeros out of bounds
bool tensor_map(CUtensorMap* map, const void* ptr, int inner, int outer,
                int box_outer) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(inner), cuuint64_t(outer)};
  const cuuint64_t strides[1] = {cuuint64_t(inner) * 2};
  const cuuint32_t box[2] = {cuuint32_t(kBK), cuuint32_t(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const void* a, const void* b, void* o, int M, int K, int N,
           int reps, int splits, cudaStream_t stream) {
  const int kc = (K + kBK * splits - 1) / (kBK * splits) * kBK;
  if ((splits - 1) * kc >= K) return int(cudaErrorInvalidValue);
  size_t strips = size_t(kBM + kBN) * kc * 2;
  if (splits > 1 && strips < size_t(kAcc) * kThreads * 4)
    strips = size_t(kAcc) * kThreads * 4;
  const size_t smem = strips + 1024;          // + alignment slack
  CUtensorMap map_a, map_b;
  const int a_by_tma = (K * 2) % 16 == 0;
  if (a_by_tma) {
    if (!tensor_map(&map_a, a, K, M, kBM)) return int(cudaErrorInvalidValue);
  } else {
    map_a = CUtensorMap{};
  }
  if (!tensor_map(&map_b, b, N, K, kBK)) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      mma_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, M / kBM, N / kBN);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mma_chain_kernel, map_a, map_b,
                         static_cast<const uint16_t*>(a),
                         static_cast<float*>(o), K, N, kc, reps, a_by_tma);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

}  // namespace

// o[M, N] fp32 = reps * (a[M, K] . b[K, N]), a and b bf16, all row-major
// and 16-byte aligned, M % 128 == 0 and N % 64 == 0. The caller picks the K
// split (1, 2 or 4 CTAs of a cluster) with
// scripts/exp_mxu_shapes.py:mma_tile, such that the strips fit in shared
// memory.
extern "C" int mma_chain_launch(const void* a, const void* b, void* o, int M,
                                int K, int N, int reps, int splits,
                                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || reps < 0 || M % kBM != 0 ||
      N % kBN != 0 || (splits != 1 && splits != 2 && splits != 4))
    return int(cudaErrorInvalidValue);
  return launch(a, b, o, M, K, N, reps, splits,
                static_cast<cudaStream_t>(stream));
}
