// HAT's window attention (Chen et al. 2023, arXiv:2205.04437; XPixelGroup/HAT
// hat_arch.py, WindowAttention and OCAB), one launch per block over the whole
// batch.
//
// It replaces no TPU kernel: the JAX package has no HAT. For every (window,
// head) of a hybrid attention block (HAB) or an overlapping cross-attention
// block (OCAB) it computes
//   out = softmax(q . k^T * scale + B + M) . v
// reading q, k and v straight from the qkv projection's output and writing
// each query's row at its own token, so none of HAT's copies is made:
// - qkv is [N, H, W, 3C] bf16, token-major: head h's q is channels
//   [h*d, h*d + d) of the first C, its k and v the same of the second and
//   third. out is [N, H, W, C] bf16.
// - HAB (kExt 16): the window is 16 x 16 tokens of the map rolled by
//   -shift, so rolled (ys, xs) is token ((ys + shift) mod H, (xs + shift)
//   mod W); its keys are its queries. B is the 31^2 x heads table at HAT's
//   calculate_rpi_sa, (qy - ky + 15) * 31 + (qx - kx + 15) in the window's
//   own coordinates. M is calculate_mask: -100 where the regions of the
//   rolled map differ (rows and columns split at H - 16 and H - shift, so
//   only the last window row and column are masked, each at its local 8).
// - OCAB (kExt 24): the query window is 16 x 16 unrolled tokens, the keys
//   the 24 x 24 tokens from 4 before it; a key outside the map is a zero
//   vector (nn.Unfold's zero padding of the projected k and v): score the
//   bias alone, value zero. B is the 39^2 x heads table at HAT's
//   calculate_rpi_oca, (ey - qy - 7) * 39 + (ex - qx - 7), which runs below
//   0 and wraps as PyTorch's indexing wraps it; the table is loaded into
//   shared memory rotated by that offset, so the kernel indexes it at
//   (ey - qy + 15) * 39 + (ex - qx + 15), from 0.
//
// Precision: the products on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulation), scores, bias, mask and softmax in fp32 (exp2 with
// log2(e) folded into the scale and the table), the probabilities rounded
// to bf16 for the second product, which also sums them in fp32 (v's padded
// channel 31 is 1 for every key), the output rounded to bf16. The head's d
// channels (30 in HAT; at most 30) are padded to 32 in shared memory only.
//
// Work: one CTA of 256 threads per (window, head), head fastest, so a
// window's CTAs run together and share its tokens in L2. The CTA stages
// q (256 x 32), k and v (keys x 32) in shared memory (rows of 64 bytes, their
// 16-byte chunks swizzled so ldmatrix reads them free of bank conflicts; v
// through ldmatrix's transpose), and its head's bias table: 53 KB (HAB) or
// 96 KB (OCAB), so two CTAs share an SM. A window off HAT's mask takes a
// copy of the loop without the mask's tests. Each of the 8 warps owns 32 queries (two 16-row tiles,
// one window row each) and walks the keys in blocks of 32 with an online
// softmax (FlashAttention-2's recurrence): S = Q K^T into registers, the
// scale, bias and mask, the running max and sum, P rounded to bf16 and fed
// from the accumulators straight into the A operand of P V. Bound by the
// exponentials and the per-score work around them, not by memory or the
// tensor cores: a 1536^2 map has 9216 windows, 6 heads, 256 queries and 256
// (HAB) or 576 (OCAB) keys, 3.6e9 or 8.2e9 exponentials a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 16;            // window side
constexpr int kQ = kWin * kWin;     // queries a window
constexpr int kD = 32;              // head width padded
constexpr int kThreads = 256;       // 8 warps of 32 queries
constexpr int kKeyBlock = 32;       // keys per step of the online softmax
constexpr int kRow = kD;            // bf16 per q, k or v row in shared memory (64 B)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMask = -100.0f;    // HAT's calculate_mask value
constexpr float kFloor = -1e30f;    // the running max before any key

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four bytes from global to shared memory without passing registers, or
// four zero bytes where !valid (src must still be a mapped address).
__device__ __forceinline__ void copy4(__nv_bfloat16* dst, const __nv_bfloat16* src, bool valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(src),
               "r"(valid ? 4 : 0));
}

// The place of (row, col) in a staged q, k or v: rows of 64 bytes whose four
// 16-byte chunks are swizzled by the row's bits 1-2, so the eight rows one
// ldmatrix (or one fragment load) reads fall on distinct banks.
__device__ __forceinline__ int at(int row, int col) {
  return row * kRow + ((((col >> 3) ^ (row >> 1)) & 3) << 3) + (col & 7);
}

template <int kExt>
struct Shape {
  static constexpr int kKeys = kExt * kExt;
  static constexpr int kSide = kWin + kExt - 1;
  static constexpr int kTable = kSide * kSide;
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (kQ + 2 * kKeys) * kRow + sizeof(float) * kTable;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// One warp's 32 queries (window rows 2 warp and 2 warp + 1) against every key
// of the window, then their rows written at their tokens. kMasked: the
// window lies on the last window row (mask_rows) or column (mask_cols) of
// the rolled map, where HAT's mask applies.
template <int kExt, bool kMasked>
__device__ __forceinline__ void attend(const __nv_bfloat16* sq, const __nv_bfloat16* sk,
                                       const __nv_bfloat16* sv, const float* sb,
                                       __nv_bfloat16* dst, int h, int w, int c, int d, int shift,
                                       int wy, int wx, bool mask_rows, bool mask_cols,
                                       float scale_log2e) {
  using S = Shape<kExt>;
  constexpr bool kOcab = kExt != kWin;
  constexpr int kTiles = kKeyBlock / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  // Tile mt holds the queries of window row ty = 2 * warp + mt; this lane's
  // rows are columns tx = g (accumulator values 0, 1) and g + 8 (2, 3).
  uint32_t qa[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = (2 * warp + mt) * kWin;
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      qa[mt][kc][0] = ld32(sq + at(r0 + g, kc * 16 + 2 * q4));
      qa[mt][kc][1] = ld32(sq + at(r0 + g + 8, kc * 16 + 2 * q4));
      qa[mt][kc][2] = ld32(sq + at(r0 + g, kc * 16 + 8 + 2 * q4));
      qa[mt][kc][3] = ld32(sq + at(r0 + g + 8, kc * 16 + 8 + 2 * q4));
    }
  }
  // o[mt][3][1] and [3][3] of lane q4 = 3 (channel 31, v's column of ones)
  // accumulate the rows' sums of the bf16 probabilities.
  float o[2][4][4];
  float m[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    m[mt][0] = m[mt][1] = kFloor;
#pragma unroll
    for (int dn = 0; dn < 4; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dn][e] = 0.0f;
  }
  // ldmatrix row addresses within a tile of 8 (k, for S) or 16 (v, for P V,
  // transposed) rows: a tile starts at a multiple of 8 rows, so the swizzle
  // depends on the lane alone
  const int sw = (lane & 7) >> 1;
  const __nv_bfloat16* k_row = sk + (lane & 7) * kRow + ((((lane >> 3) ^ sw) & 3) << 3);
  const int v_r = ((lane & 7) + ((lane >> 3) & 1) * 8) * kRow;
  const __nv_bfloat16* v_row[2] = {sv + v_r + ((((lane >> 4) ^ sw) & 3) << 3),
                                   sv + v_r + ((((2 + (lane >> 4)) ^ sw) & 3) << 3)};

  for (int kb = 0; kb < S::kKeys; kb += kKeyBlock) {
    float s[2][kTiles][4];
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      uint32_t b[4];
      ldsm_x4(b, k_row + (kb + nt * 8) * kRow);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.0f;
        mma(s[mt][nt], qa[mt][0], b[0], b[1]);
        mma(s[mt][nt], qa[mt][1], b[2], b[3]);
      }
    }
    // scale, bias and mask; the block's row maxima
    float mx[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int ty = 2 * warp + mt;
      mx[mt][0] = m[mt][0];
      mx[mt][1] = m[mt][1];
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const int j0 = kb + nt * 8 + 2 * q4;  // this lane's first key of the tile
        const int ky = kOcab ? j0 / kExt : j0 >> 4;
        const int kx = kOcab ? j0 % kExt : j0 & 15;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int tx = g + 8 * r;
          // bias of keys (ky, kx) and (ky, kx + 1)
          const int idx = kOcab ? (ky - ty + kWin - 1) * S::kSide + (kx - tx + kWin - 1)
                                : (ty - ky + kWin - 1) * S::kSide + (tx - kx + kWin - 1);
          float b0 = sb[idx], b1 = sb[kOcab ? idx + 1 : idx - 1];
          if (kMasked) {
            constexpr float kM = kMask * kLog2e;
            const bool row_apart = mask_rows && ((ty >= kWin / 2) != (ky >= kWin / 2));
            b0 += row_apart || (mask_cols && ((tx >= kWin / 2) != (kx >= kWin / 2))) ? kM : 0.0f;
            b1 += row_apart || (mask_cols && ((tx >= kWin / 2) != (kx + 1 >= kWin / 2))) ? kM
                                                                                          : 0.0f;
          }
          const float v0 = fmaf(s[mt][nt][2 * r], scale_log2e, b0);
          const float v1 = fmaf(s[mt][nt][2 * r + 1], scale_log2e, b1);
          s[mt][nt][2 * r] = v0;
          s[mt][nt][2 * r + 1] = v1;
          mx[mt][r] = fmaxf(mx[mt][r], fmaxf(v0, v1));
        }
      }
    }
    // the running max across the quad, the rescale, the probabilities
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = mx[mt][r];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float alpha = ex2(m[mt][r] - v);
        m[mt][r] = v;
#pragma unroll
        for (int dn = 0; dn < 4; ++dn) {
          o[mt][dn][2 * r] *= alpha;
          o[mt][dn][2 * r + 1] *= alpha;
        }
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt) {
          s[mt][nt][2 * r] = ex2(s[mt][nt][2 * r] - v);
          s[mt][nt][2 * r + 1] = ex2(s[mt][nt][2 * r + 1] - v);
        }
      }
    }
    // O += P V: accumulator tiles 2kc and 2kc + 1 are P's A operand for keys
    // [16 kc, 16 kc + 16) of the block
#pragma unroll
    for (int kc = 0; kc < kKeyBlock / 16; ++kc) {
      uint32_t pa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        pa[mt][0] = pack(s[mt][2 * kc][0], s[mt][2 * kc][1]);
        pa[mt][1] = pack(s[mt][2 * kc][2], s[mt][2 * kc][3]);
        pa[mt][2] = pack(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
        pa[mt][3] = pack(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
      }
#pragma unroll
      for (int dn = 0; dn < 4; dn += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, v_row[dn / 2] + (kb + kc * 16) * kRow);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(o[mt][dn], pa[mt], b[0], b[1]);
          mma(o[mt][dn + 1], pa[mt], b[2], b[3]);
        }
      }
    }
  }

  // normalise and write each query's row at its token
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ty = 2 * warp + mt;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = __shfl_sync(0xffffffffu, o[mt][3][2 * r + 1], (lane & ~3) | 3);
      const float inv = 1.0f / sum;
      const int tx = g + 8 * r;
      const int y = (wy * kWin + ty + shift) % h, x = (wx * kWin + tx + shift) % w;
      __nv_bfloat16* row = dst + (static_cast<int64_t>(y) * w + x) * c;
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        const int ch = dn * 8 + 2 * q4;
        if (ch < d)
          *reinterpret_cast<uint32_t*>(row + ch) =
              pack(o[mt][dn][2 * r] * inv, o[mt][dn][2 * r + 1] * inv);
      }
    }
  }
}

template <int kExt>
__global__ void __launch_bounds__(kThreads, 2)
    window_attn_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ table,
                       __nv_bfloat16* __restrict__ out, int h, int w, int heads, int d,
                       int shift, float scale_log2e, int nwy, int nwx) {
  using S = Shape<kExt>;
  constexpr bool kOcab = kExt != kWin;
  constexpr int kPad = (kExt - kWin) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + kQ * kRow;
  __nv_bfloat16* sv = sk + S::kKeys * kRow;
  float* sb = reinterpret_cast<float*>(sv + S::kKeys * kRow);

  const int tid = threadIdx.x;
  const int head = blockIdx.x % heads;
  int win = blockIdx.x / heads;
  const int wx = win % nwx;
  win /= nwx;
  const int wy = win % nwy;
  const int n = win / nwy;
  const int c = heads * d;
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
  const __nv_bfloat16* img = qkv + static_cast<int64_t>(n) * h * w * row_stride + head * d;

  // Rows of 16 words (two channels each): thread (row, word) = (tid / 16 +
  // 16 i, tid % 16), copied with cp.async so every load of the CTA is in
  // flight at once. q's row t is the window's token (t / 16, t % 16) of the
  // rolled map; k's and v's row j the key's token; channels past d are zero
  // (a copy of no bytes fills zeros), but v's channel 31 is one for every key
  // (the row sums ride in P V), and OCAB's keys outside the map are zero
  // vectors.
  const int wd = tid & 15;
  const bool data = wd < d / 2;
  for (int t = tid >> 4; t < kQ; t += kThreads / 16) {
    const int y = (wy * kWin + (t >> 4) + shift) % h, x = (wx * kWin + (t & 15) + shift) % w;
    copy4(sq + at(t, 2 * wd), img + (static_cast<int64_t>(y) * w + x) * row_stride + 2 * wd,
          data);
  }
  for (int j = tid >> 4; j < S::kKeys; j += kThreads / 16) {
    int y, x;
    bool inside = true;
    if (kOcab) {
      y = wy * kWin - kPad + j / kExt;
      x = wx * kWin - kPad + j % kExt;
      inside = y >= 0 && y < h && x >= 0 && x < w;
    } else {
      y = (wy * kWin + (j >> 4) + shift) % h;
      x = (wx * kWin + (j & 15) + shift) % w;
    }
    const __nv_bfloat16* p =
        inside ? img + (static_cast<int64_t>(y) * w + x) * row_stride + 2 * wd : img;
    copy4(sk + at(j, 2 * wd), p + c, inside && data);
    if (wd == 15)  // bf16 1.0 in channel 31, past every head's data
      *reinterpret_cast<uint32_t*>(sv + at(j, 2 * wd)) = 0x3f800000u;
    else
      copy4(sv + at(j, 2 * wd), p + 2 * c, inside && data);
  }
  // The head's bias table, times log2(e); OCAB's rotated to index from 0.
  for (int i = tid; i < S::kTable; i += kThreads) {
    int src = i;
    if (kOcab) src = (i + S::kTable - ((kExt - 2) * (S::kSide + 1)) % S::kTable) % S::kTable;
    sb[i] = table[src * heads + head] * kLog2e;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  __nv_bfloat16* dst = out + static_cast<int64_t>(n) * h * w * c + head * d;
  // HAT's mask touches only the last window row and column of the rolled map.
  const bool mask_rows = !kOcab && shift > 0 && wy == nwy - 1;
  const bool mask_cols = !kOcab && shift > 0 && wx == nwx - 1;
  if (!kOcab && (mask_rows || mask_cols))
    attend<kExt, true>(sq, sk, sv, sb, dst, h, w, c, d, shift, wy, wx, mask_rows, mask_cols,
                       scale_log2e);
  else
    attend<kExt, false>(sq, sk, sv, sb, dst, h, w, c, d, shift, wy, wx, false, false,
                        scale_log2e);
}

template <int kExt>
cudaError_t launch(const void* qkv, const void* table, void* out, int n, int h, int w, int heads,
                   int d, int shift, float scale, cudaStream_t stream) {
  const size_t smem = Shape<kExt>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(window_attn_kernel<kExt>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nwy = h / kWin, nwx = w / kWin;
  const int64_t blocks = static_cast<int64_t>(n) * nwy * nwx * heads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  window_attn_kernel<kExt><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(table),
      static_cast<__nv_bfloat16*>(out), h, w, heads, d, shift, scale * kLog2e, nwy, nwx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One HAB (overlap 0, shift 0 or window / 2) or OCAB (overlap window / 2,
// shift 0) attention over qkv [n, h, w, 3 * heads * d] bf16 (4-byte
// aligned) into out [n, h, w, heads * d] bf16, with the bias table [T,
// heads] fp32 (T = 31^2 or 39^2). window must be 16 and tile h and w; d
// even, at most 30. Returns the launch's cudaError.
int srs_window_attn(const void* qkv, const void* table, void* out, int n, int h, int w, int heads,
                    int d, int window, int shift, int overlap, float scale, void* stream) {
  if (qkv == nullptr || table == nullptr || out == nullptr || window != kWin || n < 0 || h <= 0 ||
      w <= 0 || h % kWin || w % kWin || heads <= 0 || d <= 0 || d > kD - 2 || d % 2 ||
      reinterpret_cast<uintptr_t>(qkv) % 4 || reinterpret_cast<uintptr_t>(out) % 4 ||
      !((overlap == 0 && (shift == 0 || shift == kWin / 2)) || (overlap == kWin / 2 && shift == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  if (overlap == 0)
    return static_cast<int>(launch<kWin>(qkv, table, out, n, h, w, heads, d, shift, scale, st));
  return static_cast<int>(
      launch<kWin + kWin / 2>(qkv, table, out, n, h, w, heads, d, shift, scale, st));
}

}  // extern "C"
