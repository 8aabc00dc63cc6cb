// The folded conv's epilogue in one pass over the conv's output, for Hopper
// (sm_90a): the bias add, LeakyReLU(0.1) or Mish and the residual add of
// the serving forward, and the FPN junction's sum.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the same epilogue into the
// conv it follows (yolov3_tensorflow_tpu/models/layers.py: conv_folded,
// conv_folded_asym, neck_split_folded; ops/fast_postprocess.py: the packed
// output conv). On the card cuDNN writes the conv's output, and PyTorch then
// read and wrote it again for the bias add, again for the LeakyReLU and
// again for the residual add. Its plain PyTorch version is
// ops/conv_epilogue.py:conv_epilogue_reference, that chain unchanged.
//
// Six modes, each its own template instance; the wrapper picks one from
// the operands the call passes. y is the conv's output [N, H, W, C]
// (channels_last) of T = bf16 or fp32, b the bias [C] (fp32 or bf16):
//   kBias      out = rnd(y + rnd(b))                  the packed output conv
//   kLeaky     out = rnd(leaky(rnd(y + rnd(b))))      conv_folded
//   kResidual  out = rnd(rnd(leaky(rnd(y + rnd(b)))) + e)
//                                                     the block's last conv,
//                                                     e its shortcut
//   kJunction  out = rnd(leaky((e[n, h/2, w/2] + y) + b))
//                                                     neck_split_folded: e the
//                                                     lateral half at low
//                                                     resolution, y the route
//                                                     half, summed in fp32
//   kMish      out = rnd(mish(rnd(y + rnd(b))))       YOLOv4's backbone convs
//   kMishResidual out = rnd(rnd(mish(rnd(y + rnd(b)))) + e)
//                                                     their residual blocks'
//                                                     last conv
// rnd() rounds a float to T to nearest even (__float2bfloat16, the
// conversion PyTorch's own CUDA kernels use from sm_80 on), and
// leaky(x) = x > 0 ? x : x * slope, with the slope the wrapper passes: 0.1
// rounded to T, or to fp32 at the junction, whose chain applies it to the
// fp32 sum. mish(x) = x * tanhf(softplus(x)) in fp32, softplus(x) =
// x > 20 ? x : log1pf(expf(x)): PyTorch's softplus and tanh kernels, which
// call the same CUDA math functions in float. Every value is computed in
// float, as PyTorch computes bf16 elementwise (its opmath type), and
// rounded where the chain stores; --fmad=false keeps the product out of an
// FMA. So every output bit equals the chain's, NaN and subnormal values
// included. The Mish modes run under a kernel name of their own
// (conv_epilogue_mish_kernel), so that a device trace tells them apart.
//
// In bf16 the Mish input rnd(y + rnd(b)) is itself a bf16 value, so
// rnd(mish(.)) of it is one of 65,536: the bf16 Mish instances look it up
// (mish_by_table) in a table of the chain's own outputs, indexed by the
// input's 16 bits, which mish_table_build computes once per device with
// the mish() and rounding below. Each block stages the 128 KB table into
// shared memory, and an element's expf, log1pf and tanhf become one
// shared-memory load; every output bit stays the chain's. fp32 Mish keeps
// the chain: its input is not 16 bits. conv_epilogue_mish_reads_table
// says which route a dtype's Mish instances take.
//
// What bounds it: device-memory bytes. A value is read once (twice with e)
// and written once for a handful of float operations: at batch 128 and
// 416^2 the packed forward's 75 calls move 24.06 GB, 7.18 ms at 3.35 TB/s,
// where the chain moved ~52 GB. The design:
//   - each thread owns one group of 8 channels for the whole launch and
//     loads and rounds their bias once: its vectors are t, t + S, t + 2S,
//     ... with S, the threads that work, cut to a multiple of C / 8;
//   - 16-byte loads and stores along C (8 bf16, or 2 x 4 fp32), neighbouring
//     threads on neighbouring addresses; kUnroll vectors (and their e) are
//     loaded before any is computed, so a thread keeps 64-128 bytes in
//     flight; the grid holds the blocks the SMs can keep resident (the
//     occupancy the compiler leaves), no more, and loops over the rest;
//   - dense operands (the conv's own output, written in place) are walked
//     by the flat vector index. A strided window (conv_folded_asym's crop
//     of its conv's output, written out dense) and the junction's
//     low-resolution operand take each pixel's (n, h, w) and per-operand
//     strides: three 32-bit divisions a vector, in the 2 junction calls of
//     the 75 (and the window, with the space-to-depth stem).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// The table takes 128 KB of an SM's shared memory, so an SM holds one
// block of the bf16 Mish instances: a larger one, to keep the SM's bytes
// in flight (1,024 threads: 0.6% faster over YOLOv4's 72 Mish calls than
// 512 on an H100).
constexpr int kTableThreads = 1024;
constexpr int kTableBytes = 65536 * 2;
enum Mode {
  kBias = 0,
  kLeaky = 1,
  kResidual = 2,
  kJunction = 3,
  kMish = 4,
  kMishResidual = 5
};

__host__ __device__ constexpr bool is_mish(int mode) {
  return mode == kMish || mode == kMishResidual;
}

// Whether the instance looks Mish up in the table (bf16) or runs the chain.
template <typename T, int kMode>
constexpr bool kTable =
    is_mish(kMode) && std::is_same<T, __nv_bfloat16>::value;

template <typename T, int kMode>
constexpr int kBlock = kTable<T, kMode> ? kTableThreads : kThreads;

struct Strides {          // in elements; the channel stride is 1
  long long n, h, w;
};

struct Args {
  void* out;
  const void* y;
  const void* e;          // k(Mish)Residual: the shortcut; kJunction: the
                          // lateral
  const void* bias;
  int bias_bf16;
  int c8;                 // C / 8
  long long vectors;      // N * H * W * C / 8
  long long stride;       // S: a thread's step, in vectors (a multiple of c8)
  float slope;
  int h, w;               // the strided walk: out's H and W
  Strides so, sy, se;
  const void* table;      // bf16 Mish: mish_table_build's 65,536 codes
};

// A vector is 8 channels of one pixel: loaded as it lies in memory (Raw, 16
// bytes of bf16 or 32 of fp32), widened to floats only when computed, so a
// thread's kUnroll vectors in flight cost half the registers in bf16.
template <typename T>
struct IO;

template <>
struct IO<float> {
  struct Raw {
    float4 a, b;
  };
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ Raw load(const void* base, long long off) {
    const float4* p =
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
    return Raw{p[0], p[1]};
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
    f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
  }
  static __device__ __forceinline__ void store(void* base, long long off,
                                               const float (&f)[8]) {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(base) + off);
    p[0] = make_float4(f[0], f[1], f[2], f[3]);
    p[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <>
struct IO<__nv_bfloat16> {
  using Raw = uint4;
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ Raw load(const void* base, long long off) {
    return *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + off);
  }
  // a bf16 is the top half of the float it stands for; the lower address
  // of a pair is the lower half of its 32-bit word
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    return unsigned(__bfloat16_as_ushort(__float2bfloat16(lo))) |
           (unsigned(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
  }
  static __device__ __forceinline__ void store(void* base, long long off,
                                               const float (&f)[8]) {
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + off) =
        make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                   pack(f[6], f[7]));
  }
};

__device__ __forceinline__ long long at(const Strides& s, unsigned n,
                                        unsigned h, unsigned w) {
  return n * s.n + h * s.h + w * s.w;
}

__device__ __forceinline__ float mish(float x) {
  const float sp = x > 20.f ? x : log1pf(expf(x));
  return x * tanhf(sp);
}

// The body of every instance; the two __global__ names below wrap it.
template <typename T, int kMode, bool kStrided>
__device__ __forceinline__ void epilogue(const Args& g) {
  using Raw = typename IO<T>::Raw;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= g.stride) return;
  const int c = int(t % g.c8) * 8;           // the thread's first channel
  float b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v =
        g.bias_bf16
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(g.bias)[c + i])
            : static_cast<const float*>(g.bias)[c + i];
    b[i] = kMode == kJunction ? v : IO<T>::round(v);
  }
  constexpr bool kE =
      kMode == kResidual || kMode == kJunction || kMode == kMishResidual;
  const long long pstep = g.stride / g.c8;   // pixels between a thread's steps
  long long p0 = t / g.c8;
  for (long long v0 = t; v0 < g.vectors;
       v0 += kUnroll * g.stride, p0 += kUnroll * pstep) {
    Raw xr[kUnroll], er[kUnroll];
    long long oo[kUnroll];                   // the strided walk's out offsets
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * g.stride;
      if (v < g.vectors) {
        long long yo = v * 8, eo = v * 8;
        if (kStrided) {
          const unsigned p = unsigned(p0 + u * pstep);
          const unsigned pw = p % unsigned(g.w), q = p / unsigned(g.w);
          const unsigned ph = q % unsigned(g.h), pn = q / unsigned(g.h);
          oo[u] = at(g.so, pn, ph, pw) + c;
          yo = at(g.sy, pn, ph, pw) + c;
          eo = (kMode == kJunction ? at(g.se, pn, ph >> 1, pw >> 1)
                                   : at(g.se, pn, ph, pw)) + c;
        }
        xr[u] = IO<T>::load(g.y, yo);
        if (kE) er[u] = IO<T>::load(g.e, eo);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * g.stride;
      if (v < g.vectors) {
        float x[8], e[8];
        IO<T>::unpack(xr[u], x);
        if (kE) IO<T>::unpack(er[u], e);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float r;
          if (kMode == kJunction) {
            r = (e[i] + x[i]) + b[i];
            r = r > 0.f ? r : r * g.slope;
          } else {
            r = IO<T>::round(x[i] + b[i]);
            if (is_mish(kMode))
              r = IO<T>::round(mish(r));
            else if (kMode != kBias)
              r = IO<T>::round(r > 0.f ? r : r * g.slope);
            if (kMode == kResidual || kMode == kMishResidual) r = r + e[i];
          }
          x[i] = r;
        }
        IO<T>::store(g.out, kStrided ? oo[u] : v * 8, x);
      }
    }
  }
}

// The bf16 Mish instances' body: epilogue's walk, with rnd(mish(r)) read
// from the table at r's code. The thread's first kUnroll loads of y (and
// e) are issued before the block stages the table, so the two overlap;
// every thread of the block helps to stage it.
template <int kMode, bool kStrided>
__device__ __forceinline__ void mish_by_table(const Args& g) {
  using IOb = IO<__nv_bfloat16>;
  extern __shared__ uint4 staged[];
  const unsigned short* table = reinterpret_cast<const unsigned short*>(staged);
  constexpr bool kE = kMode == kMishResidual;
  const long long t = (long long)blockIdx.x * kTableThreads + threadIdx.x;
  const bool works = t < g.stride;
  const int c = int(t % g.c8) * 8;
  const long long pstep = g.stride / g.c8;
  long long v0 = t, p0 = t / g.c8;
  uint4 xr[kUnroll], er[kUnroll];
  long long oo[kUnroll];
  auto load = [&]() {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * g.stride;
      if (v < g.vectors) {
        long long yo = v * 8, eo = v * 8;
        if (kStrided) {
          const unsigned p = unsigned(p0 + u * pstep);
          const unsigned pw = p % unsigned(g.w), q = p / unsigned(g.w);
          const unsigned ph = q % unsigned(g.h), pn = q / unsigned(g.h);
          oo[u] = at(g.so, pn, ph, pw) + c;
          yo = at(g.sy, pn, ph, pw) + c;
          eo = at(g.se, pn, ph, pw) + c;
        }
        xr[u] = IOb::load(g.y, yo);
        if (kE) er[u] = IOb::load(g.e, eo);
      }
    }
  };
  float b[8];
  if (works) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      b[i] = IOb::round(
          g.bias_bf16
              ? __bfloat162float(static_cast<const __nv_bfloat16*>(g.bias)[c + i])
              : static_cast<const float*>(g.bias)[c + i]);
    load();
  }
  const uint4* src = static_cast<const uint4*>(g.table);
  for (int i = threadIdx.x; i < kTableBytes / 16; i += kTableThreads)
    staged[i] = src[i];
  __syncthreads();
  if (!works) return;
  for (;;) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * g.stride;
      if (v < g.vectors) {
        float x[8];
        IOb::unpack(xr[u], x);
        unsigned w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // the codes of r = rnd(x + b), channel 2i in the lower half
          const unsigned r = IOb::pack(x[2 * i] + b[2 * i],
                                       x[2 * i + 1] + b[2 * i + 1]);
          w[i] = unsigned(table[r & 0xffffu]) |
                 (unsigned(table[r >> 16]) << 16);
        }
        const uint4 m = make_uint4(w[0], w[1], w[2], w[3]);
        const long long off = kStrided ? oo[u] : v * 8;
        if (kE) {
          float e[8];
          IOb::unpack(m, x);
          IOb::unpack(er[u], e);
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] = x[i] + e[i];
          IOb::store(g.out, off, x);
        } else {
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(g.out) +
                                    off) = m;
        }
      }
    }
    v0 += kUnroll * g.stride;
    p0 += kUnroll * pstep;
    if (v0 >= g.vectors) return;
    load();
  }
}

template <typename T, int kMode, bool kStrided>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(const Args g) {
  epilogue<T, kMode, kStrided>(g);
}

template <typename T, int kMode, bool kStrided>
__global__ void __launch_bounds__((kBlock<T, kMode>))
    conv_epilogue_mish_kernel(const Args g) {
  if constexpr (kTable<T, kMode>)
    mish_by_table<kMode, kStrided>(g);
  else
    epilogue<T, kMode, kStrided>(g);
}

// mish_by_table's table: entry k is rnd(mish(x)) for the bf16 x whose code
// is k, by this file's own mish() and rounding, so each entry is the
// chain's bits (the host's log1pf and tanhf differ from CUDA's in the last
// ulp, so the table is never computed there).
__global__ void __launch_bounds__(kThreads)
    mish_table_build(unsigned short* table) {
  const unsigned k = blockIdx.x * kThreads + threadIdx.x;
  table[k] = __float_as_uint(
                 IO<__nv_bfloat16>::round(mish(__uint_as_float(k << 16)))) >>
             16;
}

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// The instance's __global__ name: only the one it launches is compiled.
template <typename T, int kMode, bool kStrided>
constexpr auto kernel_of() {
  if constexpr (is_mish(kMode))
    return conv_epilogue_mish_kernel<T, kMode, kStrided>;
  else
    return conv_epilogue_kernel<T, kMode, kStrided>;
}

template <typename T, int kMode, bool kStrided>
cudaError_t launch(Args g, cudaStream_t st) {
  constexpr auto kernel = kernel_of<T, kMode, kStrided>();
  constexpr int block = kBlock<T, kMode>;
  constexpr int smem = kTable<T, kMode> ? kTableBytes : 0;
  if (smem) {               // above 48 KB only by asking, once per device
    static bool asked[64] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
      return cudaErrorInvalidDevice;
    if (!asked[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      asked[dev] = true;
    }
  }
  static int per_sm = 0;    // resident blocks an SM, once per instance
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, block, smem);
    if (e != cudaSuccess) return e;
  }
  const int sms = sm_count();
  if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidDevice;
  long long threads = (long long)sms * per_sm * block;
  const long long need = (g.vectors + kUnroll - 1) / kUnroll;
  if (need < threads) threads = need;
  if (threads < g.c8) threads = g.c8;
  g.stride = threads / g.c8 * g.c8;
  const long long blocks = (g.stride + block - 1) / block;
  kernel<<<unsigned(blocks), block, smem, st>>>(g);
  return cudaGetLastError();
}

template <typename T, bool kStrided>
cudaError_t dispatch(int mode, const Args& g, cudaStream_t st) {
  switch (mode) {
    case kBias: return launch<T, kBias, kStrided>(g, st);
    case kLeaky: return launch<T, kLeaky, kStrided>(g, st);
    case kResidual: return launch<T, kResidual, kStrided>(g, st);
    case kJunction:
      if constexpr (kStrided) return launch<T, kJunction, true>(g, st);
      break;
    case kMish: return launch<T, kMish, kStrided>(g, st);
    case kMishResidual: return launch<T, kMishResidual, kStrided>(g, st);
  }
  return cudaErrorInvalidValue;
}

template <bool kStrided>
int run(int bf16, int mode, const Args& g, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(bf16 ? dispatch<__nv_bfloat16, kStrided>(mode, g, st)
                  : dispatch<float, kStrided>(mode, g, st));
}

bool reads_table(int bf16) {
  return bf16 ? kTable<__nv_bfloat16, kMish> : kTable<float, kMish>;
}

bool bad(const void* out, const void* y, const void* e, const void* bias,
         const void* table, int bf16, int mode, long long pixels, int c) {
  return out == nullptr || y == nullptr || bias == nullptr || mode < kBias ||
         mode > kMishResidual ||
         ((mode == kResidual || mode == kJunction || mode == kMishResidual) &&
          e == nullptr) ||
         (is_mish(mode) && reads_table(bf16) && table == nullptr) ||
         pixels <= 0 || c <= 0 || c % 8 != 0;
}

}  // namespace

// 1 where the Mish instances of the dtype (bf16, else fp32) read
// conv_epilogue_mish_table's table, 0 where they run the chain.
extern "C" int conv_epilogue_mish_reads_table(int bf16) {
  return int(reads_table(bf16));
}

// Fills table (65,536 bf16 codes, 16-byte aligned) with mish_table_build
// on the stream. Returns the cudaError_t of the launch.
extern "C" int conv_epilogue_mish_table(void* table, void* stream) {
  if (table == nullptr) return int(cudaErrorInvalidValue);
  mish_table_build<<<65536 / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned short*>(table));
  return int(cudaGetLastError());
}

// Dense operands: out, y and e are [pixels, c] row-major (a channels_last
// tensor), 16-byte aligned; out may be y. bf16 selects T (else fp32),
// bias_bf16 the bias's type; any mode but kJunction. table: a filled
// conv_epilogue_mish_table in the Mish modes of a dtype that reads it
// (conv_epilogue_mish_reads_table), else unread. Returns the cudaError_t
// of the launch.
extern "C" int conv_epilogue_dense(void* out, const void* y, const void* e,
                                   const void* bias, const void* table,
                                   int bf16, int bias_bf16, int mode,
                                   long long pixels, int c, float slope,
                                   void* stream) {
  if (bad(out, y, e, bias, table, bf16, mode, pixels, c) || mode == kJunction)
    return int(cudaErrorInvalidValue);
  Args g{};
  g.out = out; g.y = y; g.e = e; g.bias = bias; g.bias_bf16 = bias_bf16;
  g.table = table;
  g.c8 = c / 8;
  g.vectors = pixels * g.c8;
  g.slope = slope;
  return run<false>(bf16, mode, g, stream);
}

// Strided operands: out and y [n, h, w, c], e [n, h, w, c] (a residual) or
// [n, h/2, w/2, c] (kJunction), each with its own n, h and w strides in
// elements (multiples of 8) and a channel stride of 1, 16-byte aligned;
// n * h * w < 2^31. Any mode; table as conv_epilogue_dense's.
extern "C" int conv_epilogue_strided(
    void* out, const void* y, const void* e, const void* bias,
    const void* table, int bf16, int bias_bf16, int mode, int n, int h, int w,
    int c, long long so_n, long long so_h, long long so_w, long long sy_n,
    long long sy_h, long long sy_w, long long se_n, long long se_h,
    long long se_w, float slope, void* stream) {
  const long long pixels = (long long)n * h * w;
  if (bad(out, y, e, bias, table, bf16, mode, pixels, c) || n <= 0 ||
      h <= 0 || w <= 0 || pixels >= 0x80000000LL)
    return int(cudaErrorInvalidValue);
  Args g{};
  g.out = out; g.y = y; g.e = e; g.bias = bias; g.bias_bf16 = bias_bf16;
  g.table = table;
  g.c8 = c / 8;
  g.vectors = pixels * g.c8;
  g.slope = slope;
  g.h = h; g.w = w;
  g.so = Strides{so_n, so_h, so_w};
  g.sy = Strides{sy_n, sy_h, sy_w};
  g.se = Strides{se_n, se_h, se_w};
  return run<true>(bf16, mode, g, stream);
}
