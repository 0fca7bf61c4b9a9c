// Hand-written Hopper kernels for the Gaussian/Laplacian pyramid.
//
// They replace the two Pallas TPU kernels of
// srs_tpu/ops/pallas/pyramid_pallas.py:
//   K1 srs_pyr_down_f32 <- pyr_down_pallas (pyramid_pallas.py:70-93)
//   K2 srs_pyr_up_f32   <- pyr_up_pallas   (pyramid_pallas.py:118-141)
// On the TPU both run as banded MXU products (D_v . X . D_w^T), because
// Mosaic cannot lower stride-2 slices. Here each is a direct separable
// stencil that computes what the TPU kernel computes.
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
// Both kernels are bound by memory: each input element is read once from
// device memory (halo rows and columns apart) and each output element is
// written once, against ~10 FLOP per output element. At the main path's
// level 0 each moves 1.91 GB, 0.57 ms at 3.35 TB/s.
//
// K1 stages a 16x32-output tile plus its halo in shared memory, applying
// the border rule while it loads, runs the vertical pass into a second
// shared buffer, then the horizontal pass, and writes its tile once.
//
// K2 is a row-streaming stencil. Its output is 80% of its bytes (four
// samples written for each one read), so its design is about keeping
// stores wide and many in flight:
// - Layout: an NHWC row is one run of W*C floats. A block owns a band of
//   128 source columns (256 output) and a run of 32 source rows (64
//   output rows) of one plane, and walks down its rows. Level 0
//   ([6,2304^2,3] -> [6,4608^2,3]) is 18 x 72 x 6 blocks of 196 KB of
//   writes each (the old 32x32-output tiles made 124,416 blocks of
//   12 KB).
// - A ring of four staged source rows in shared memory holds rows i-1,
//   i and i+1 while row i+2 arrives by cp.async (16-byte copies on
//   aligned rows), so loads overlap the stores of the row before. Each
//   staged row carries the band's one-pixel halo on both sides and gets
//   the border rule while it is staged; halo and the one-row overlap of
//   runs re-read ~8% of the input.
// - For source row i the vertical pass writes output rows 2i and 2i+1
//   of the band and its halo into a two-row shared buffer (not a whole
//   tile's), and the horizontal pass writes both rows from it.
// - Each thread writes 4 consecutive floats at a time as one 16-byte
//   streaming store (__stcs) wherever the row is 16-byte aligned (n_w*C
//   a multiple of 4, as at every launch of the main path); a ragged
//   right edge or an unaligned row takes scalar stores.
// - C is a template parameter, instantiated for 3 (the main path), so
//   the channel arithmetic is on constants; other channel counts run the
//   same body with C read at run time. No loop divides by C per element:
//   a thread finds its first (pixel, channel) once and steps from there.
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
constexpr int kThreads = 256;  // K1
constexpr int kUpBand = 128;   // K2 source columns per block (256 output)
constexpr int kUpRun = 32;     // K2 source rows per block (64 output)
constexpr int kUpThreads = 192;  // one float4 per thread and output row at C=3
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

// cp.async copies of 4 and 16 bytes into shared memory, and their groups.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Floats from the start of a staged row to its pixel 0: the left halo
// pixel sits just before, and pixel 0 is 16-byte aligned.
__host__ __device__ constexpr int up_lead(int c) { return (c + 3) & ~3; }

// Floats of one staged row: pixels -1 .. kUpBand, rounded up to 16 bytes.
__host__ __device__ constexpr int up_row_floats(int c) {
  return (up_lead(c) + (kUpBand + 1) * c + 3) & ~3;
}

// K2. Block (band, run, b) owns source columns [j0, j0 + kUpBand) and
// source rows [i0, i0 + kUpRun) of plane b, i.e. output columns
// [2 j0, 2 j0 + 2 kUpBand) and rows [2 i0, 2 i0 + 2 kUpRun), and walks
// down its rows. CT is the channel count when it is known at compile
// time (3, the main path's), or 0 to read it from c_rt.
template <int CT>
__global__ void __launch_bounds__(kUpThreads)
pyr_up_kernel(const float* __restrict__ x, float* __restrict__ y, int mh,
              int mw, int nh, int nw, int c_rt, bool vec_in, bool vec_out) {
  const int c = CT > 0 ? CT : c_rt;
  const int t = threadIdx.x;
  const int row_floats = up_row_floats(c);
  const int lead = up_lead(c);
  extern __shared__ __align__(16) float up_smem[];
  float* ring = up_smem;                  // 4 staged source rows
  float* s_v = up_smem + 4 * row_floats;  // vertical results, 2 rows

  const int b = blockIdx.z;
  const int j0 = blockIdx.x * kUpBand;
  const int i0 = blockIdx.y * kUpRun;
  const int i_last = min(i0 + kUpRun, (nh + 1) / 2) - 1;  // last source row
  const int mid = min(kUpBand, mw - j0);  // pixels of the band inside the row
  const float* xb = x + static_cast<size_t>(b) * mh * mw * c;

  // Stage source row j (any j; up_source applies the border rule) into
  // its ring slot: pixels -1 .. kUpBand of the band, as cp.async copies.
  auto stage = [&](int j) {
    const float* src = xb + static_cast<size_t>(up_source(j, mh)) * mw * c;
    float* dst = ring + ((j - i0 + 1) & 3) * row_floats + lead;
    const float* body = src + j0 * c;
    const int body_floats = mid * c;
    int k = t;
    if (vec_in) {
      for (; 4 * k + 3 < body_floats; k += kUpThreads)
        cp_async16(dst + 4 * k, body + 4 * k);
      k = (body_floats & ~3) + t;
    }
    for (; k < body_floats; k += kUpThreads) cp_async4(dst + k, body + k);
    // Pixel -1 and pixels mid .. kUpBand, from their border-rule columns.
    for (int p = t; p < kUpBand + 2 - mid; p += kUpThreads) {
      const int q = p == 0 ? -1 : mid + p - 1;
      const float* from = src + up_source(j0 + q, mw) * c;
      for (int ch = 0; ch < c; ++ch) cp_async4(dst + q * c + ch, from + ch);
    }
  };

  stage(i0 - 1);
  stage(i0);
  stage(i0 + 1);
  cp_async_commit();
  if (i0 + 2 <= i_last + 1) stage(i0 + 2);
  cp_async_commit();

  // This thread's outputs: 4 consecutive floats of a row segment at a
  // time, starting at float 4t and stepping by 4 kUpThreads; (q, ch) is
  // the output pixel within the band and the channel of the first.
  const int seg_floats = min(2 * kUpBand, nw - 2 * j0) * c;
  const int q_first = 4 * t / c, ch_first = 4 * t - q_first * c;
  const int q_step = 4 * kUpThreads / c, ch_step = 4 * kUpThreads - q_step * c;
  const int row_elems = (kUpBand + 2) * c;  // a staged row, halo included

  for (int i = i0; i <= i_last; ++i) {
    cp_async_wait<1>();  // rows up to i + 1 have landed
    __syncthreads();     // ...for every thread; s_v is free again
    // Vertical pass for output rows 2i and 2i+1, over the band and its
    // halo: taps in the reference's order.
    {
      const float* up = ring + ((i - i0) & 3) * row_floats + lead - c;
      const float* mid_row = ring + ((i - i0 + 1) & 3) * row_floats + lead - c;
      const float* down = ring + ((i - i0 + 2) & 3) * row_floats + lead - c;
      float* v0 = s_v + lead - c;
      float* v1 = v0 + row_floats;
      for (int e = t; e < row_elems; e += kUpThreads) {
        const float p0 = up[e], p1 = mid_row[e], p2 = down[e];
        v0[e] = (p0 + 6.0f * p1 + p2) * 0.125f;
        v1[e] = (p1 + p2) * 0.5f;
      }
    }
    __syncthreads();  // s_v is complete; row i - 1's slot is free
    if (i + 3 <= i_last + 1) stage(i + 3);
    cp_async_commit();

    // Horizontal pass: output rows 2i and 2i+1 of the band.
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * i + rr;
      if (r >= nh) break;
      const float* v = s_v + rr * row_floats + lead;  // pixel 0 of the band
      float* out = y + (static_cast<size_t>(b) * nh + r) * nw * c +
                   static_cast<size_t>(2 * j0) * c;
      int q = q_first, ch = ch_first;
      for (int e = 4 * t; e < seg_floats; e += 4 * kUpThreads) {
        float val[4];
        int qk = q, chk = ch;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float* p = v + (qk >> 1) * c + chk;
          val[k] = (qk & 1) ? (p[0] + p[c]) * 0.5f
                            : (p[-c] + 6.0f * p[0] + p[c]) * 0.125f;
          if (++chk == c) {
            chk = 0;
            ++qk;
          }
        }
        if (vec_out && e + 3 < seg_floats) {
          __stcs(reinterpret_cast<float4*>(out + e),
                 make_float4(val[0], val[1], val[2], val[3]));
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (e + k < seg_floats) __stcs(out + e + k, val[k]);
        }
        q += q_step;
        ch += ch_step;
        if (ch >= c) {
          ch -= c;
          ++q;
        }
      }
    }
  }
  cp_async_wait<0>();
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
  const int ci = static_cast<int>(c);
  // 16-byte copies and stores where every row starts 16-byte aligned.
  const bool vec_in = (mw * c) % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = (nw * c) % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const size_t smem = 6 * static_cast<size_t>(up_row_floats(ci)) * sizeof(float);
  const dim3 grid(static_cast<unsigned>((nw + 2 * kUpBand - 1) / (2 * kUpBand)),
                  static_cast<unsigned>(((nh + 1) / 2 + kUpRun - 1) / kUpRun),
                  static_cast<unsigned>(n));
  const auto kernel = ci == 3 ? &pyr_up_kernel<3> : &pyr_up_kernel<0>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kUpThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<int>(mh), static_cast<int>(mw), static_cast<int>(nh),
      static_cast<int>(nw), ci, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
