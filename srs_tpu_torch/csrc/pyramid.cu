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
// K1 is a row-streaming stencil. Its input is 80% of its bytes (four
// samples read for each one written), so its design is about keeping wide
// loads in flight:
// - Layout: an NHWC row is one run of W*C floats. A block owns a band of
//   128 output columns (256 source, plus a two-pixel halo each side) and
//   a run of output rows of one plane, and walks down its rows. Output row
//   o reads source rows 2o-2 .. 2o+2; row o+1 needs two new ones. Level 0
//   ([6,4608^2,3] -> [6,2304^2,3]) is 18 x 72 x 6 blocks of 32 rows (the
//   old 16x32-output tiles made 62,208 blocks that each re-read 15% of
//   their share as halo; now halo and the three-row overlap of runs
//   re-read about 6%).
// - A ring of eight staged source rows in shared memory, filled by
//   cp.async (16-byte copies on aligned rows, as at every main-path
//   launch: W*C is a multiple of 4). Five rows are in use; the two rows of
//   the next output row and the two of the one after are in flight, so a
//   block's loads overlap its own compute, not only other blocks'. By
//   Little's law, 3.35 TB/s at ~1 us of latency needs ~3.4 MB in flight,
//   ~25 KB per SM; a band row is 3.1 KB, so up to four rows in flight per
//   block and four blocks per SM (80 registers a thread at C=3; 28 KB of
//   shared memory a block) cover it. On an H100 (700 W) neither a 16-row
//   ring with four output rows ahead nor 64-column bands at eight blocks
//   per SM moved level 0 (0.77-0.81 ms against 0.77-0.78), so level 0 is
//   not bound by latency. Each staged row gets REFLECT_101 on its row and
//   its halo columns while it is staged, so compute never branches on
//   position, and pixel 0 sits on a 16-byte boundary.
// - Every output row commits one cp.async group, empty past the run's end,
//   so one fixed wait_group count always means the same rows have landed.
// - The vertical pass writes one row of the band and its halo into a
//   one-row shared buffer (not a whole tile's), with even and odd source
//   pixels apart; the horizontal pass then reads output float e's taps at
//   e - C, e and e + C of the two halves, as aligned 16-byte windows at
//   C=3, and decimates without a per-element index computation.
// - Each thread writes 4 consecutive floats as one 16-byte streaming store
//   (__stcs) wherever the output row is 16-byte aligned; a ragged right
//   edge or an unaligned row takes scalar stores.
// - C is a template parameter, instantiated for 3 (the main path);
//   other channel counts run the same body with C read at run time. No
//   loop divides by C or by a row length per element: a thread finds its
//   first (pixel, channel) once and steps from there.
// - Runs sized to the grid: srs_pyr_down_f32 halves the run from 32
//   output rows until the grid holds at least two blocks per SM (2 x 132
//   on the H100), or the run reaches 4 rows. Level 0 keeps 7,776 blocks
//   of 32 rows; level 4 ([6,288^2,3]) gets 432 blocks of 4 rows where
//   32-row runs would give 60, fewer than the card has SMs.
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

constexpr int kDownBand = 128;   // K1 output columns per block (256 source)
constexpr int kDownRunMax = 32;  // K1 output rows per block, longest run
constexpr int kDownRunMin = 4;   // ...and shortest
constexpr int kDownSlots = 8;    // K1 ring of staged source rows
constexpr int kDownAhead = 2;    // K1 output rows staged ahead of the one in use
constexpr int kDownThreads = 192;  // a float4 per thread and staged row at C=3
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

// Four floats from a 16-byte aligned shared address into registers.
__device__ __forceinline__ void unpack4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// Floats before pixel 0 of a staged K1 row: pixels -2 and -1 sit just
// before it, and pixel 0 is 16-byte aligned.
__host__ __device__ constexpr int down_lead(int c) { return (2 * c + 3) & ~3; }

// Floats of one staged K1 row: pixels -2 .. 2 kDownBand, rounded up to
// 16 bytes.
__host__ __device__ constexpr int down_row_floats(int c) {
  return (down_lead(c) + (2 * kDownBand + 1) * c + 3) & ~3;
}

// Floats before pixel 0 of each half of K1's vertical result (one row,
// even and odd source pixels apart), and of one half: pixels -1 ..
// kDownBand and a float4 of slack for the horizontal pass's window.
__host__ __device__ constexpr int down_half_lead(int c) { return (c + 3) & ~3; }
__host__ __device__ constexpr int down_half_floats(int c) {
  return down_half_lead(c) + (((kDownBand + 1) * c + 3) & ~3) + 4;
}

// K1. Block (band, run, b) owns output columns [oj0, oj0 + kDownBand) and
// output rows [o0, o0 + run) of plane b, and walks down its rows. Output
// row o reads source rows 2o-2 .. 2o+2, of which 2o+1 and 2o+2 are new.
// CT is the channel count when it is known at compile time (3, the main
// path's), or 0 to read it from c_rt.
template <int CT>
__global__ void __launch_bounds__(kDownThreads)
pyr_down_kernel(const float* __restrict__ x, float* __restrict__ y, int h,
                int w, int ho, int wo, int run, int c_rt, bool vec_in,
                bool vec_out) {
  static_assert(CT <= 4, "the compile-time horizontal window covers C <= 4");
  static_assert(2 * kDownAhead + 3 <= kDownSlots, "the ring is too small");
  const int c = CT > 0 ? CT : c_rt;
  const int t = threadIdx.x;
  const int row_floats = down_row_floats(c);
  const int lead = down_lead(c);
  extern __shared__ __align__(16) float down_smem[];
  float* ring = down_smem;  // kDownSlots staged source rows
  // Vertical result of one row: even source pixels 2p in ev[p c + ch],
  // odd ones 2p+1 in od[p c + ch], p from -1.
  float* ev = down_smem + kDownSlots * row_floats + down_half_lead(c);
  float* od = ev + down_half_floats(c);

  const int b = blockIdx.z;
  const int oj0 = blockIdx.x * kDownBand;
  const int o0 = blockIdx.y * run;
  const int n_rows = min(run, ho - o0);
  const int nq = min(kDownBand, wo - oj0);  // output pixels of the band
  const int span = 2 * nq + 1;              // source pixels 0 .. 2 nq
  const int j0 = 2 * oj0;                   // source column of pixel 0
  const int mid = min(span, w - j0);        // pixels of the span inside the row
  const int r0 = 2 * o0 - 2;                // source row of staged row 0
  const float* xb = x + static_cast<size_t>(b) * h * w * c;

  // Stage source row r0 + s (REFLECT_101 applied here) into slot s: pixels
  // -2 .. span - 1 of the band, as cp.async copies.
  auto stage = [&](int s) {
    const float* src = xb + static_cast<size_t>(reflect101(r0 + s, h)) * w * c;
    float* dst = ring + (s & (kDownSlots - 1)) * row_floats + lead;
    const float* body = src + static_cast<size_t>(j0) * c;
    const int body_floats = mid * c;
    int k = t;
    if (vec_in) {
      for (; 4 * k + 3 < body_floats; k += kDownThreads)
        cp_async16(dst + 4 * k, body + 4 * k);
      k = (body_floats & ~3) + t;
    }
    for (; k < body_floats; k += kDownThreads) cp_async4(dst + k, body + k);
    // Pixels -2, -1 and mid .. span - 1, from their border-rule columns.
    for (int p = t; p < span + 2 - mid; p += kDownThreads) {
      const int q = p < 2 ? p - 2 : mid + p - 2;
      const float* from = src + reflect101(j0 + q, w) * c;
      for (int ch = 0; ch < c; ++ch) cp_async4(dst + q * c + ch, from + ch);
    }
  };
  // The rows output row i of the run needs that no earlier row brought.
  auto stage_for = [&](int i) {
    if (i >= n_rows) return;
    if (i == 0) {
      stage(0);
      stage(1);
      stage(2);
    }
    stage(2 * i + 3);
    stage(2 * i + 4);
  };

  // One cp.async group per output row, empty past the run's end, so that
  // waiting until kDownAhead - 1 groups are pending means row i's landed.
  for (int i = 0; i < kDownAhead; ++i) {
    stage_for(i);
    cp_async_commit();
  }

  // Vertical pass: this thread's staged floats are f = t + k kDownThreads
  // from pixel -2, channel 0; (vp, vch) is the pixel and channel of the
  // first, stepped without division.
  const int v_floats = (span + 2) * c;
  const int vp_step = kDownThreads / c, vch_step = kDownThreads - vp_step * c;
  const int vp_first = t / c - 2, vch_first = t - (t / c) * c;
  // Horizontal pass: 4 consecutive output floats of the band's row at a
  // time, from float 4t, stepping by 4 kDownThreads.
  const int seg_floats = nq * c;
  const float g0 = 1.0f / 16.0f, g1 = 4.0f / 16.0f, g2 = 6.0f / 16.0f;

  for (int i = 0; i < n_rows; ++i) {
    cp_async_wait<kDownAhead - 1>();  // rows up to 2i + 4 have landed
    __syncthreads();                   // ...for every thread; ev/od are free
    {
      auto row = [&](int s) {  // staged row s from its pixel -2
        return ring + (s & (kDownSlots - 1)) * row_floats + lead - 2 * c;
      };
      const float *s0 = row(2 * i), *s1 = row(2 * i + 1), *s2 = row(2 * i + 2),
                  *s3 = row(2 * i + 3), *s4 = row(2 * i + 4);
      int p = vp_first, ch = vch_first;
      for (int f = t; f < v_floats; f += kDownThreads) {
        float acc = s0[f] * g0;
        acc = acc + s1[f] * g1;
        acc = acc + s2[f] * g2;
        acc = acc + s3[f] * g1;
        acc = acc + s4[f] * g0;
        ((p & 1) ? od : ev)[(p >> 1) * c + ch] = acc;
        p += vp_step;
        ch += vch_step;
        if (ch >= c) {
          ch -= c;
          ++p;
        }
      }
    }
    __syncthreads();  // ev/od are complete; rows 2i and 2i - 1 are free
    stage_for(i + kDownAhead);
    cp_async_commit();

    // Horizontal pass: output float e = q c + ch reads source pixels
    // 2q-2 .. 2q+2 of channel ch, i.e. ev[e - c], od[e - c], ev[e],
    // od[e], ev[e + c], taps in order.
    float* out = y + (static_cast<size_t>(b) * ho + o0 + i) * wo * c +
                 static_cast<size_t>(oj0) * c;
    for (int e = 4 * t; e < seg_floats; e += 4 * kDownThreads) {
      float val[4];
      if constexpr (CT > 0) {
        // Aligned float4 windows ev[e-4, e+8) and od[e-4, e+4).
        float we[12], wd[8];
        unpack4(we, ev + e - 4);
        unpack4(we + 4, ev + e);
        unpack4(we + 8, ev + e + 4);
        unpack4(wd, od + e - 4);
        unpack4(wd + 4, od + e);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float acc = we[4 + k - CT] * g0;
          acc = acc + wd[4 + k - CT] * g1;
          acc = acc + we[4 + k] * g2;
          acc = acc + wd[4 + k] * g1;
          acc = acc + we[4 + k + CT] * g0;
          val[k] = acc;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ek = e + k;
          float acc = ev[ek - c] * g0;
          acc = acc + od[ek - c] * g1;
          acc = acc + ev[ek] * g2;
          acc = acc + od[ek] * g1;
          acc = acc + ev[ek + c] * g0;
          val[k] = acc;
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
    }
  }
  cp_async_wait<0>();
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
  const int ci = static_cast<int>(c);
  const int ho = static_cast<int>((h + 1) / 2);
  const int wo = static_cast<int>((w + 1) / 2);
  // 16-byte copies and stores where every row starts 16-byte aligned.
  const bool vec_in = (w * c) % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = (wo * c) % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // The run: halve it from kDownRunMax until the grid holds two blocks for
  // each SM, or it reaches kDownRunMin.
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t bands = (wo + kDownBand - 1) / kDownBand;
  int run = kDownRunMax;
  while (run > kDownRunMin && bands * ((ho + run - 1) / run) * n < 2 * sms) run /= 2;
  const size_t smem = (kDownSlots * static_cast<size_t>(down_row_floats(ci)) +
                       2 * static_cast<size_t>(down_half_floats(ci))) * sizeof(float);
  const dim3 grid(static_cast<unsigned>(bands), static_cast<unsigned>((ho + run - 1) / run),
                  static_cast<unsigned>(n));
  const auto kernel = ci == 3 ? &pyr_down_kernel<3> : &pyr_down_kernel<0>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kDownThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<int>(h),
      static_cast<int>(w), ho, wo, run, ci, vec_in, vec_out);
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
