// The SR convolutions' epilogue, one hand-written pass after each conv.
//
// It replaces no TPU kernel: on the TPU, XLA fuses the bias, the ReLU and
// the scaled residual of srs_tpu/models/nets.py into the convolution. On
// the card PyTorch runs cuDNN's convolution, then the bias as its own
// `output.add_(bias.reshape(1, C, 1, 1))`, which on a channels_last output
// takes TensorIterator's generic one-element-per-thread kernel, and then
// the ReLU, the scale and the residual add as three more passes. This
// kernel does the bias and whichever of the other two the net applies in
// one pass over the conv's fresh output y, in place:
//   form 0  y = y + b
//   form 1  y = relu(y + b)
//   form 2  y = x + s * (y + b)     (x the block's input, s its res_scale)
//   form 3  y = gelu(y + b)         (the exact erf GELU, HAT's channel attention)
//   form 4  y = leaky_relu(y + b)   (slope 0.01, HAT's conv_before_upsample)
// y and x are one dense [N, C, H, W] layout, read as flat memory: value i
// has channel (i / inner) mod C, inner 1 for channels_last (NHWC, the SR
// nets') and H * W for NCHW (the generator's convs after a `cat` or an
// upsample). b is [C]. The type is bf16, fp16 or fp32, one for all three.
//
// Rounding is PyTorch's sequence, step by step in fp32 registers, so the
// result is bit-identical to the unfused ops: the bias add rounds to the
// type, the ReLU is clamp_min's rule (NaN passes, else fmaxf with 0), the
// scale multiplies by the float s (PyTorch's scalar 0.1 becomes 0.1f) and
// rounds, the residual add rounds. GELU is ATen's GeluCUDAKernelImpl in
// float, (x * 0.5f) * (1 + erff(x * (float)M_SQRT1_2)); LeakyReLU its
// leaky_relu_kernel, x > 0 ? x : x * 0.01f (NaN takes the second arm). Each step is an explicit _rn intrinsic,
// so no step fuses into an FMA across a rounding (in fp32 too, where the
// rounding to the type is the identity).
//
// Bound by memory: one read and one write of y, and one read of x in form
// 2, against 1-3 FLOP a value. A 128-channel bf16 map of six 1536^2 tiles
// (the fusion cell's second x3 step) moves 10.9 GB in form 2, 3.2 ms at
// 3.35 TB/s. So the design is about wide, coalesced accesses and enough
// bytes in flight:
// - Each thread moves one 16-byte vector (8 bf16 or fp16, 4 fp32 values)
//   as one load and one store.
// - A grid-stride loop over the vectors with at most eight 256-thread
//   blocks per SM; each iteration issues two vectors' loads (four in form
//   2) before any store, ~32-64 KB in flight per SM, over Little's law's
//   ~25 KB at ~1 us of latency.
// - A thread's position (offset within a channel's run, channel) advances
//   by the grid's stride with one carry and one conditional subtraction,
//   so no division runs in the loop.
// - Channels_last with C a multiple of the vector (and b 16-byte aligned):
//   the vector's biases are one 16-byte load (L1-resident). Else one load
//   a value, walking the position, so any C works (3, 27 in the tails) and
//   any H * W in NCHW.
// - The n mod vector values past the last whole vector go to one thread.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kBias = 0, kRelu = 1, kResidual = 2, kGelu = 3, kLrelu = 4;
constexpr float kSqrt1_2 = 0.70710678118654752440f;  // M_SQRT1_2, as ATen's float kAlpha
constexpr float kLreluSlope = 0.01f;  // nn.LeakyReLU's default, as ATen's float negval
constexpr int kBf16 = 0, kFp16 = 1, kFp32 = 2;

template <typename T>
struct Num;
template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float up(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 down(float f) { return __float2bfloat16_rn(f); }
};
template <>
struct Num<__half> {
  static __device__ __forceinline__ float up(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half down(float f) { return __float2half_rn(f); }
};
template <>
struct Num<float> {
  static __device__ __forceinline__ float up(float v) { return v; }
  static __device__ __forceinline__ float down(float f) { return f; }
};

template <typename T, int F>
__device__ __forceinline__ T epilogue(T y, T b, T x, float s) {
  using N = Num<T>;
  T t = N::down(__fadd_rn(N::up(y), N::up(b)));
  if (F == kRelu) {
    const float f = N::up(t);
    t = N::down(isnan(f) ? f : fmaxf(f, 0.0f));
  } else if (F == kResidual) {
    t = N::down(__fmul_rn(N::up(t), s));
    t = N::down(__fadd_rn(N::up(x), N::up(t)));
  } else if (F == kGelu) {
    const float f = N::up(t);
    t = N::down(__fmul_rn(__fmul_rn(f, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(f, kSqrt1_2)))));
  } else if (F == kLrelu) {
    const float f = N::up(t);
    t = N::down(f > 0.0f ? f : __fmul_rn(f, kLreluSlope));
  }
  return t;
}

// A flat index's place in the layout: offset r within its channel's run of
// `inner` values, and channel c.
struct Pos {
  int64_t r;
  int c;
};

__device__ __forceinline__ Pos advance(Pos p, int64_t step_r, int step_c, int64_t inner,
                                       int channels) {
  p.r += step_r;
  int c = p.c + step_c;
  if (p.r >= inner) {
    p.r -= inner;
    ++c;
  }
  p.c = c >= channels ? c - channels : c;
  return p;
}

// The kVec values of one vector whose first value is at p.
template <typename T, int F, bool kVecBias>
__device__ __forceinline__ uint4 vector(uint4 yv, uint4 xv, const T* __restrict__ b, Pos p,
                                        int64_t inner, int channels, float s) {
  constexpr int kVec = 16 / sizeof(T);
  T bias[kVec];
  if (kVecBias) {
    *reinterpret_cast<uint4*>(bias) = __ldg(reinterpret_cast<const uint4*>(b + p.c));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      bias[j] = b[p.c];
      if (++p.r == inner) {
        p.r = 0;
        p.c = p.c + 1 == channels ? 0 : p.c + 1;
      }
    }
  }
  const T* yy = reinterpret_cast<const T*>(&yv);
  const T* xx = reinterpret_cast<const T*>(&xv);
  uint4 out;
  T* oo = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < kVec; ++j) oo[j] = epilogue<T, F>(yy[j], bias[j], xx[j], s);
  return out;
}

// nvec whole vectors, then n - kVec * nvec values (< kVec) by thread 0 of
// block 0. (step_r, step_c) is the grid's stride of kVec * gridDim.x *
// blockDim.x values as a place: (stride mod inner, (stride / inner) mod C).
template <typename T, int F, bool kVecBias>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(T* y, const T* __restrict__ b, const T* x, float s, int64_t n,
                         int64_t nvec, int channels, int64_t inner, int64_t step_r, int step_c) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  Pos p{(v * kVec) % inner, static_cast<int>((v * kVec / inner) % channels)};
  uint4* yv = reinterpret_cast<uint4*>(y);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (; v + stride < nvec; v += 2 * stride) {
    const Pos p1 = advance(p, step_r, step_c, inner, channels);
    const uint4 y0 = yv[v], y1 = yv[v + stride];
    const uint4 x0 = F == kResidual ? xv[v] : zero;
    const uint4 x1 = F == kResidual ? xv[v + stride] : zero;
    yv[v] = vector<T, F, kVecBias>(y0, x0, b, p, inner, channels, s);
    yv[v + stride] = vector<T, F, kVecBias>(y1, x1, b, p1, inner, channels, s);
    p = advance(p1, step_r, step_c, inner, channels);
  }
  if (v < nvec) {
    const uint4 x0 = F == kResidual ? xv[v] : zero;
    yv[v] = vector<T, F, kVecBias>(yv[v], x0, b, p, inner, channels, s);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int64_t i = nvec * kVec; i < n; ++i) {
      const T xi = F == kResidual ? x[i] : Num<T>::down(0.0f);
      y[i] = epilogue<T, F>(y[i], b[(i / inner) % channels], xi, s);
    }
  }
}

template <typename T, int F>
cudaError_t launch(void* y, const void* b, const void* x, float s, int64_t n, int channels,
                   int64_t inner, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t nvec = n / kVec;
  const int64_t resident = static_cast<int64_t>(sms) * kBlocksPerSm;
  int64_t blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  const int64_t stride = kVec * blocks * kThreads;
  const int64_t step_r = stride % inner;
  const int step_c = static_cast<int>((stride / inner) % channels);
  const bool vec_bias =
      inner == 1 && channels % kVec == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  auto* yp = static_cast<T*>(y);
  const auto* bp = static_cast<const T*>(b);
  const auto* xp = static_cast<const T*>(x);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec_bias)
    conv_epilogue_kernel<T, F, true><<<grid, kThreads, 0, stream>>>(
        yp, bp, xp, s, n, nvec, channels, inner, step_r, step_c);
  else
    conv_epilogue_kernel<T, F, false><<<grid, kThreads, 0, stream>>>(
        yp, bp, xp, s, n, nvec, channels, inner, step_r, step_c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_form(int form, void* y, const void* b, const void* x, float s, int64_t n,
                        int channels, int64_t inner, cudaStream_t stream) {
  switch (form) {
    case kBias:
      return launch<T, kBias>(y, b, x, s, n, channels, inner, stream);
    case kRelu:
      return launch<T, kRelu>(y, b, x, s, n, channels, inner, stream);
    case kResidual:
      return launch<T, kResidual>(y, b, x, s, n, channels, inner, stream);
    case kGelu:
      return launch<T, kGelu>(y, b, x, s, n, channels, inner, stream);
    case kLrelu:
      return launch<T, kLrelu>(y, b, x, s, n, channels, inner, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// In place on y: n values of `dtype` (0 bf16, 1 fp16, 2 fp32) in one dense
// [N, C, H, W] layout whose value i has channel (i / inner) mod c, with
// c * inner | n, 16-byte aligned; b [c]; x (form 2 only) laid out as y,
// 16-byte aligned. form: 0 bias, 1 bias and ReLU, 2 bias, scale s and
// residual x, 3 bias and GELU, 4 bias and LeakyReLU. Returns the launch's cudaError.
int srs_conv_epilogue(void* y, const void* b, const void* x, float s, int64_t n, int64_t c,
                      int64_t inner, int dtype, int form, void* stream) {
  if (n < 0 || c <= 0 || c > (1 << 20) || inner <= 0 || n % (c * inner) != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      (form == kResidual && (x == nullptr || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int ci = static_cast<int>(c);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16:
      return static_cast<int>(launch_form<__nv_bfloat16>(form, y, b, x, s, n, ci, inner, st));
    case kFp16:
      return static_cast<int>(launch_form<__half>(form, y, b, x, s, n, ci, inner, st));
    case kFp32:
      return static_cast<int>(launch_form<float>(form, y, b, x, s, n, ci, inner, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
