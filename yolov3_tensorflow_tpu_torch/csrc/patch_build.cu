// im2col patch-build probe: taps row-shifted slices of each row block,
// concatenated along channels, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/exp_mxu_shapes.py:_concat_kernel (driven
// by concat_rate). Same result: x [M, c] bf16 is cut into blocks of mt rows;
// block i gives mt - 16 output rows, and output row r of block i is
//     concat(x[i*mt + r], x[i*mt + r + 1], ..., x[i*mt + r + taps - 1])
// ([M / mt * (mt - 16), taps * c] bf16). Its plain PyTorch version is
// scripts/exp_mxu_shapes.py:concat_patches_reference (torch.cat of the
// shifted slices). The result is a copy, so the two agree bit for bit.
//
// What bounds it: device-memory writes. Every input row is read once and
// written taps (9) times, so a c = 128 probe over M = 65536 rows reads
// 16.8 MB and writes 148.6 MB.
// The design:
//   - the rows are contiguous, so output row r is the contiguous run of
//     taps * c input elements that starts at row r: the whole patch matrix
//     of a strip is a sliding window over the strip's input;
//   - one CTA per strip of kStrip (112) output rows of one block (the TPU
//     kernel took a whole 1024-row block into VMEM; at c = 128 that is
//     256 KB of input, more than a CTA's 227 KB of shared memory). It
//     copies the strip's kStrip + taps - 1 input rows (the strip plus its
//     taps - 1 row halo, one contiguous range) into shared memory with
//     16-byte loads, then writes the strip's output rows, one contiguous
//     range too, with coalesced 16-byte stores, each read from shared
//     memory at its window offset. The last strip of a block may be short.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 112;      // output rows per CTA (1008 = 9 * 112)

__global__ void __launch_bounds__(kThreads)
    patch_build_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                       int c8, int taps, int mt, int strips) {
  extern __shared__ uint4 sx[];
  const int blk = blockIdx.x / strips;
  const int strip = blockIdx.x - blk * strips;
  const int mo = mt - 16;
  const int r0 = strip * kStrip;
  const int rows = min(kStrip, mo - r0);
  const int in_vecs = (rows + taps - 1) * c8;
  const uint4* src = x + (size_t(blk) * mt + r0) * c8;
  for (int i = threadIdx.x; i < in_vecs; i += kThreads) sx[i] = src[i];
  __syncthreads();

  const int w8 = taps * c8;                  // 16-byte vectors per out row
  uint4* dst = out + (size_t(blk) * mo + r0) * w8;
  for (int i = threadIdx.x; i < rows * w8; i += kThreads) {
    const int r = i / w8;
    dst[i] = sx[r * c8 + (i - r * w8)];
  }
}

}  // namespace

// out [M / mt * (mt - 16), taps * c] bf16 from x [M, c] bf16, both
// row-major and 16-byte aligned; c % 8 == 0, M % mt == 0,
// 1 <= taps <= 17 and mt >= 17 (every window stays inside its block).
extern "C" int patch_build_launch(const void* x, void* out, int M, int c,
                                  int taps, int mt, void* stream) {
  if (M <= 0 || c <= 0 || c % 8 != 0 || taps < 1 || taps > 17 || mt < 17 ||
      M % mt != 0)
    return int(cudaErrorInvalidValue);
  const int c8 = c / 8;
  const int strips = (mt - 16 + kStrip - 1) / kStrip;
  const size_t smem = size_t(kStrip + taps - 1) * c8 * sizeof(uint4);
  cudaError_t e = cudaFuncSetAttribute(
      patch_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  const long long ctas = (long long)(M / mt) * strips;
  if (ctas > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  patch_build_kernel<<<unsigned(ctas), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), c8, taps, mt,
      strips);
  return int(cudaGetLastError());
}
