// Full-search block motion estimation, for Hopper (sm_90a).
//
// Replaces the JAX package's two TPU motion kernels:
//   swiftvideo_tpu/ops/motion.py::_me_pallas_program      (exact-integer SAD)
//   swiftvideo_tpu/ops/motion.py::_me_ssd_pallas_program  (SSD, separable MV cost)
// and computes their oracles, motion.py::me_fullsearch_golden and ::me_ssd_golden,
// candidate for candidate: same clamped windows, same float32 scores, same winner.
//
// One thread block per 16x16 macroblock of the current frame (67 x 120 = 8,040 at
// 1080p).  The block stages its clamped reference window (at most 63 x 63 bytes at
// search 64) in shared memory, every thread holds the 16x16 current block in
// registers as 64 packed words, and the 256 threads stride over the window's
// candidates (at most 48 x 48 = 2,304).  A candidate costs 16 rows of five aligned
// shared-memory words, funnel-shifted into the candidate's alignment, and four
// __vsadu4 (SAD: sum |c - r| over 4 bytes) or eight __dp4a (SSD: sum c*r and sum
// r*r) per row.  The winner is a lexicographic (score, key) minimum over the
// block, key = (tx - xlo) * n_y + (ty - ylo): the first strict minimum of the
// oracle's tx-outer, ty-inner scan.
//
// Bound: operations.  At 1080p / 16 / 64 the clamped windows hold 1.83e7
// candidates, 4.7e9 pixel-candidate terms; the frames are 4 MB.  None of the TPU
// kernels' shape work comes over (f32 over exact ints, rolled carries, 8-aligned
// windows, the 128-lane edge tail, im2col by roll, the bf16 MXU product, the band
// roll and the XLA outer stage): integers stay integers, and each block reads its
// own window.  The SSD cross term is a product that tensor cores could take; that
// is later work.
//
// Scores, in float32 with each step rounded on its own (the file is compiled with
// --fmad=false, and the intrinsics below say so again):
//   SAD: cost2[dx][dy] + SAD * (256/255)
//   SSD: (partial * 2^-4 + cy[dy]) + cx[dx],  partial = sum r^2 - 2 sum c r
// Both sums are exact in int32 (SAD <= 65,280; |partial| <= 256 * 255^2 < 2^24), so
// the conversions to float are exact.  The cost tables are built on the host in
// float64 and rounded to float32 (ops/motion.py: tables), as the JAX package does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSad = 0;
constexpr int kSsd = 1;
constexpr float kSadScale = 0x1.010102p+0f;  // float32(256 / 255): integer SAD -> UNORM * 256

// Candidate range [lo, hi) of a block at origin o (motion.py::_search_bounds).
__device__ __forceinline__ void bounds(int o, int search, int size, int& lo, int& hi) {
  const int left = min(max(o + kBlock / 2 - search / 2, 0), size);
  const int right = min(max(left + search, 0), size);
  lo = left;
  hi = right - kBlock;
}

__device__ __forceinline__ bool better(float s, int k, float bs, int bk) {
  return s < bs || (s == bs && k < bk);
}

template <int kMetric>
__global__ void __launch_bounds__(kThreads)
    motion_search_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ ref, int h,
                         int w, int search, int row_words, const float* __restrict__ cost,
                         const uint8_t* __restrict__ mv_u8, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t win[];  // [rows][row_words] reference window
  __shared__ uint32_t cur_s[kBlock * kBlock / 4];
  __shared__ float red_s[kWarps];
  __shared__ int red_k[kWarps];

  const int tid = threadIdx.x;
  const int bx = blockIdx.x, by = blockIdx.y;
  const int ox = bx * kBlock, oy = by * kBlock;
  int xlo, xhi, ylo, yhi;
  bounds(ox, search, w, xlo, xhi);
  bounds(oy, search, h, ylo, yhi);
  const int n_x = max(xhi - xlo, 0);
  const int n_y = max(yhi - ylo, 0);
  const int d_lo = kBlock / 2 - search / 2;
  const int n_d = search - kBlock - d_lo;

  // stage the current block and the window (zero past its right edge)
  uint8_t* cur_b = reinterpret_cast<uint8_t*>(cur_s);
  cur_b[tid] = cur[(oy + tid / kBlock) * w + ox + tid % kBlock];
  const int rows = n_y > 0 ? n_y + kBlock - 1 : 0;
  const int cols = n_x + kBlock - 1;
  uint8_t* win_b = reinterpret_cast<uint8_t*>(win);
  for (int i = tid; i < rows * row_words * 4; i += kThreads) {
    const int r = i / (row_words * 4);
    const int c = i % (row_words * 4);
    win_b[i] = (n_x > 0 && c < cols) ? ref[(ylo + r) * w + xlo + c] : 0;
  }
  __syncthreads();

  uint32_t cw[kBlock * kBlock / 4];
#pragma unroll
  for (int i = 0; i < kBlock * kBlock / 4; ++i) cw[i] = cur_s[i];

  float best_s = __int_as_float(0x7f800000);  // +inf
  int best_k = 0x7fffffff;
  for (int k = tid; k < n_x * n_y; k += kThreads) {
    const int ix = k / n_y;
    const int iy = k - ix * n_y;
    const int shift = (ix & 3) * 8;
    const uint32_t* row = win + iy * row_words + (ix >> 2);
    int acc0 = 0, acc1 = 0;  // SAD; or sum r*r, sum c*r
#pragma unroll
    for (int r = 0; r < kBlock; ++r) {
      uint32_t wd[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) wd[q] = row[r * row_words + q];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t rp = __funnelshift_r(wd[q], wd[q + 1], shift);
        const uint32_t cp = cw[r * 4 + q];
        if constexpr (kMetric == kSad) {
          acc0 += static_cast<int>(__vsadu4(cp, rp));
        } else {
          acc0 = static_cast<int>(__dp4a(rp, rp, static_cast<unsigned>(acc0)));
          acc1 = static_cast<int>(__dp4a(cp, rp, static_cast<unsigned>(acc1)));
        }
      }
    }
    const int di = xlo + ix - ox - d_lo;  // cost-table index of dx
    const int dj = ylo + iy - oy - d_lo;  // and of dy
    float score;
    if constexpr (kMetric == kSad) {
      score = __fadd_rn(cost[di * n_d + dj], __fmul_rn(static_cast<float>(acc0), kSadScale));
    } else {
      const float partial = static_cast<float>(acc0 - 2 * acc1);
      score = __fadd_rn(__fadd_rn(__fmul_rn(partial, 0.0625f), cost[dj]), cost[di]);
    }
    if (better(score, k, best_s, best_k)) {
      best_s = score;
      best_k = k;
    }
  }

  // (score, key) minimum: the warp, then the block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_down_sync(0xffffffffu, best_s, off);
    const int k = __shfl_down_sync(0xffffffffu, best_k, off);
    if (better(s, k, best_s, best_k)) {
      best_s = s;
      best_k = k;
    }
  }
  if ((tid & 31) == 0) {
    red_s[tid >> 5] = best_s;
    red_k[tid >> 5] = best_k;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int i = 1; i < kWarps; ++i) {
    if (better(red_s[i], red_k[i], best_s, best_k)) {
      best_s = red_s[i];
      best_k = red_k[i];
    }
  }
  int mvx = 0, mvy = 0;  // an empty window keeps the zero vector
  if (best_k != 0x7fffffff) {
    const int ix = best_k / n_y;
    mvx = ox - (xlo + ix);
    mvy = oy - (ylo + best_k - ix * n_y);
  }
  const int max_mv = search / 2;
  uint8_t* o = out + 4 * (by * gridDim.x + bx);
  o[0] = mv_u8[min(max(mvx, -max_mv), max_mv) + max_mv];
  o[1] = 128;  // rint(0.5 * 255), half to even
  o[2] = mv_u8[min(max(mvy, -max_mv), max_mv) + max_mv];
  o[3] = 255;
}

template <int kMetric>
int launch(const void* cur, const void* ref, int h, int w, int search, const void* cost,
           const void* mv_u8, void* out, cudaStream_t stream) {
  // words per window row: the candidate at the last column reads 5 aligned
  // words; an odd count keeps a warp's consecutive rows on distinct banks
  const int row_words = ((search + 6) / 4) | 1;
  const int smem = max(search - 1, 1) * row_words * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(motion_search_kernel<kMetric>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(w / kBlock, h / kBlock, 1);
  motion_search_kernel<kMetric><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref), h, w, search, row_words,
      static_cast<const float*>(cost), static_cast<const uint8_t*>(mv_u8),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Full search of cur against ref (h x w u8, row-major, on the device) with 16x16
// blocks and a `search`-pixel window.  metric 0 = SAD: cost = cost2 [n_d * n_d];
// 1 = SSD: cost = the per-axis half [n_d], read as cy then cx.  mv_u8
// [search / 2 * 2 + 1] maps a clamped vector component to its u8 channel.
// out: [h / 16, w / 16, 4] u8.
// Launches on `stream` and returns the launch's CUDA error code.
extern "C" int sv_motion_search(const void* cur, const void* ref, int h, int w, int search,
                                int metric, const void* cost, const void* mv_u8, void* out,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return metric == kSad ? launch<kSad>(cur, ref, h, w, search, cost, mv_u8, out, st)
                        : launch<kSsd>(cur, ref, h, w, search, cost, mv_u8, out, st);
}
