// Hand-written Hopper kernels for the Gaussian/Laplacian pyramid.
//
// They replace the two Pallas TPU kernels of
// srs_tpu/ops/pallas/pyramid_pallas.py:
//   K1 srs_pyr_down_f32 <- pyr_down_pallas (pyramid_pallas.py:70-93)
//   K2 srs_pyr_up_f32   <- pyr_up_pallas   (pyramid_pallas.py:118-141)
// On the TPU both run as banded MXU products (D_v . X . D_w^T), because
// Mosaic cannot lower stride-2 slices. Here each is a direct separable
// stencil: a block stages its input tile plus a halo in shared memory,
// applying the border rule while it loads; runs the vertical pass into a
// second shared buffer; then runs the horizontal pass and writes its
// output tile once.
//
// Both kernels are bound by memory: each input element is read once from
// device memory (halo rows and columns apart) and each output element is
// written once, against ~10 FLOP per output element. K1 at the main
// path's level 0 ([6,4608,4608,3] -> [6,2304,2304,3]) must move 1.91 GB,
// 0.57 ms at 3.35 TB/s.
//
// Semantics are cv2's pyrDown/pyrUp, as srs_tpu/ops/pyramid.py states
// them:
//   K1: 5-tap binomial (1,4,6,4,1)/16, REFLECT_101 borders, even phase,
//       output ceil(n/2) per axis.
//   K2: polyphase pyrUp to an explicit size n with 2m-2 <= n <= 2m:
//       even out (src[i-1] + 6 src[i] + src[i+1]) / 8, odd out
//       (src[i] + src[i+1]) / 2, with src[-1] = src[1] (REFLECT_101) on
//       the left and src[m] = src[m-1] (replicate) on the right.
// Sums run in the XLA reference's order: vertical pass first, then
// horizontal, taps in order.
//
// Layout: NHWC float32, contiguous, channels innermost.
// C ABI (bound with ctypes): each launcher takes device pointers, sizes
// and a cudaStream_t, launches on that stream, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDownTH = 16;  // K1 output rows per block
constexpr int kDownTW = 32;  // K1 output columns per block
constexpr int kUpTH = 32;    // K2 output rows per block (even)
constexpr int kUpTW = 32;    // K2 output columns per block (even)
constexpr int kThreads = 256;
constexpr int kMaxChannels = 16;

__device__ __forceinline__ int reflect101(int j, int n) {
  if (j >= 0 && j < n) return j;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  j = abs(j) % period;
  return j >= n ? period - j : j;
}

// Source index of logical position j for pyrUp: src[-1] = src[1]
// (src[0] when m == 1), src[j >= m] = src[m-1].
__device__ __forceinline__ int up_source(int j, int m) {
  if (j < 0) return m > 1 ? 1 : 0;
  return j < m ? j : m - 1;
}

__global__ void __launch_bounds__(kThreads)
pyr_down_kernel(const float* __restrict__ x, float* __restrict__ y, int h,
                int w, int c, int ho, int wo) {
  extern __shared__ float smem[];
  constexpr int in_rows = 2 * kDownTH + 3;
  constexpr int in_cols = 2 * kDownTW + 3;
  const int row_elems = in_cols * c;
  float* s_in = smem;                       // [in_rows][in_cols][c]
  float* s_v = smem + in_rows * row_elems;  // [kDownTH][in_cols][c]

  const int b = blockIdx.z;
  const int oi0 = blockIdx.y * kDownTH;
  const int oj0 = blockIdx.x * kDownTW;
  const int r0 = 2 * oi0 - 2;  // input row of s_in row 0
  const int q0 = 2 * oj0 - 2;  // input column of s_in column 0
  const float* xb = x + static_cast<size_t>(b) * h * w * c;

  for (int idx = threadIdx.x; idx < in_rows * row_elems; idx += blockDim.x) {
    const int rr = idx / row_elems;
    const int rem = idx - rr * row_elems;
    const int cc = rem / c;
    const int ch = rem - cc * c;
    const int gi = reflect101(r0 + rr, h);
    const int gj = reflect101(q0 + cc, w);
    s_in[idx] = xb[(static_cast<size_t>(gi) * w + gj) * c + ch];
  }
  __syncthreads();

  const float g0 = 1.0f / 16.0f, g1 = 4.0f / 16.0f, g2 = 6.0f / 16.0f;
  // Vertical: output row oi0+rr reads input rows 2(oi0+rr)-2 .. +2.
  for (int idx = threadIdx.x; idx < kDownTH * row_elems; idx += blockDim.x) {
    const int rr = idx / row_elems;
    const int rem = idx - rr * row_elems;
    const float* p = s_in + 2 * rr * row_elems + rem;
    float acc = p[0] * g0;
    acc = acc + p[row_elems] * g1;
    acc = acc + p[2 * row_elems] * g2;
    acc = acc + p[3 * row_elems] * g1;
    acc = acc + p[4 * row_elems] * g0;
    s_v[idx] = acc;
  }
  __syncthreads();

  // Horizontal with decimation: output column oj0+jj reads columns
  // 2(oj0+jj)-2 .. +2 of the vertical result.
  const int out_elems = kDownTW * c;
  for (int idx = threadIdx.x; idx < kDownTH * out_elems; idx += blockDim.x) {
    const int rr = idx / out_elems;
    const int rem = idx - rr * out_elems;
    const int jj = rem / c;
    const int ch = rem - jj * c;
    const int oi = oi0 + rr;
    const int oj = oj0 + jj;
    if (oi >= ho || oj >= wo) continue;
    const float* p = s_v + rr * row_elems + 2 * jj * c + ch;
    float acc = p[0] * g0;
    acc = acc + p[c] * g1;
    acc = acc + p[2 * c] * g2;
    acc = acc + p[3 * c] * g1;
    acc = acc + p[4 * c] * g0;
    y[((static_cast<size_t>(b) * ho + oi) * wo + oj) * c + ch] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
pyr_up_kernel(const float* __restrict__ x, float* __restrict__ y, int mh,
              int mw, int nh, int nw, int c) {
  extern __shared__ float smem[];
  constexpr int in_rows = kUpTH / 2 + 2;
  constexpr int in_cols = kUpTW / 2 + 2;
  const int row_elems = in_cols * c;
  float* s_in = smem;                       // [in_rows][in_cols][c]
  float* s_v = smem + in_rows * row_elems;  // [kUpTH][in_cols][c]

  const int b = blockIdx.z;
  const int oi0 = blockIdx.y * kUpTH;
  const int oj0 = blockIdx.x * kUpTW;
  const int i0 = oi0 / 2 - 1;  // source row of s_in row 0
  const int j0 = oj0 / 2 - 1;  // source column of s_in column 0
  const float* xb = x + static_cast<size_t>(b) * mh * mw * c;

  for (int idx = threadIdx.x; idx < in_rows * row_elems; idx += blockDim.x) {
    const int rr = idx / row_elems;
    const int rem = idx - rr * row_elems;
    const int cc = rem / c;
    const int ch = rem - cc * c;
    const int gi = up_source(i0 + rr, mh);
    const int gj = up_source(j0 + cc, mw);
    s_in[idx] = xb[(static_cast<size_t>(gi) * mw + gj) * c + ch];
  }
  __syncthreads();

  // Vertical: output row r = oi0+rr takes source row i = r/2, which is
  // s_in row k = rr/2 + 1.
  for (int idx = threadIdx.x; idx < kUpTH * row_elems; idx += blockDim.x) {
    const int rr = idx / row_elems;
    const int rem = idx - rr * row_elems;
    const float* p = s_in + (rr / 2 + 1) * row_elems + rem;
    float v;
    if ((rr & 1) == 0) {
      v = (p[-row_elems] + 6.0f * p[0] + p[row_elems]) * 0.125f;
    } else {
      v = (p[0] + p[row_elems]) * 0.5f;
    }
    s_v[idx] = v;
  }
  __syncthreads();

  const int out_elems = kUpTW * c;
  for (int idx = threadIdx.x; idx < kUpTH * out_elems; idx += blockDim.x) {
    const int rr = idx / out_elems;
    const int rem = idx - rr * out_elems;
    const int qq = rem / c;
    const int ch = rem - qq * c;
    const int r = oi0 + rr;
    const int q = oj0 + qq;
    if (r >= nh || q >= nw) continue;
    const float* p = s_v + rr * row_elems + (qq / 2 + 1) * c + ch;
    float v;
    if ((qq & 1) == 0) {
      v = (p[-c] + 6.0f * p[0] + p[c]) * 0.125f;
    } else {
      v = (p[0] + p[c]) * 0.5f;
    }
    y[((static_cast<size_t>(b) * nh + r) * nw + q) * c + ch] = v;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// x [n, h, w, c] -> y [n, ceil(h/2), ceil(w/2), c].
int srs_pyr_down_f32(const void* x, void* y, int64_t n, int64_t h, int64_t w,
                     int64_t c, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > kMaxChannels || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ho = static_cast<int>((h + 1) / 2);
  const int wo = static_cast<int>((w + 1) / 2);
  const size_t smem = static_cast<size_t>((2 * kDownTH + 3) + kDownTH) *
                      (2 * kDownTW + 3) * c * sizeof(float);
  cudaError_t err = allow_smem(pyr_down_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((wo + kDownTW - 1) / kDownTW, (ho + kDownTH - 1) / kDownTH,
                  static_cast<unsigned>(n));
  pyr_down_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<int>(h), static_cast<int>(w), static_cast<int>(c), ho, wo);
  return static_cast<int>(cudaGetLastError());
}

// x [n, mh, mw, c] -> y [n, nh, nw, c] with 2m-2 <= n <= 2m on each axis.
int srs_pyr_up_f32(const void* x, void* y, int64_t n, int64_t mh, int64_t mw,
                   int64_t nh, int64_t nw, int64_t c, void* stream) {
  if (n <= 0 || mh <= 0 || mw <= 0 || c <= 0 || c > kMaxChannels || n > 65535 ||
      nh < 2 * mh - 2 || nh > 2 * mh || nw < 2 * mw - 2 || nw > 2 * mw ||
      nh <= 0 || nw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>((kUpTH / 2 + 2) + kUpTH) *
                      (kUpTW / 2 + 2) * c * sizeof(float);
  cudaError_t err = allow_smem(pyr_up_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((static_cast<int>(nw) + kUpTW - 1) / kUpTW,
                  (static_cast<int>(nh) + kUpTH - 1) / kUpTH,
                  static_cast<unsigned>(n));
  pyr_up_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<int>(mh), static_cast<int>(mw), static_cast<int>(nh),
      static_cast<int>(nw), static_cast<int>(c));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
