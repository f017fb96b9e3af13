// Full-search block motion estimation, for Hopper (sm_90a).
//
// Replaces the JAX package's two TPU motion kernels:
//   swiftvideo_tpu/ops/motion.py::_me_pallas_program      (exact-integer SAD)
//   swiftvideo_tpu/ops/motion.py::_me_ssd_pallas_program  (SSD, separable MV cost)
// and computes their oracles, motion.py::me_fullsearch_golden and ::me_ssd_golden,
// candidate for candidate: same clamped windows, same float32 scores, same winner.
//
// One thread block of 192 threads per group of G consecutive 16x16 macroblocks
// of one block row (ops/motion.py: groups; G = kSadGroup = 2 for SAD, kSsdGroup
// = 4 for SSD, the fastest at 1080p and 4K on an H100, PERF.md).  Each macroblock's row of the host-built plan (ops/motion.py:
// plan) gives its origin, clamped window, candidate counts and cost-table
// offsets.  The group walks its windows in chunks of 48 x 48 candidates (one
// chunk up to search 64).  The macroblocks' windows start at most 16 columns
// apart, so one chunk of all of them lies in 48 + 16 (G - 1) columns: staged
// once, with 16-byte loads, as four copies shifted by 0..3 bytes, so that a run
// of 4 bytes at any column is one aligned 32-bit shared load.  Neighbouring
// windows overlap about three-fold, so the group stages (and, for SSD, sums
// r^2 over) fewer bytes per macroblock than one block per macroblock would.
//
// SSD (motion_ssd_kernel<4>): score = (f32(partial) * 2^-4 + cy[dy]) + cx[dx],
// partial = sum r^2 - 2 sum c r.  The cross term sum c r runs on the int8 tensor
// cores as mma.sync m16n8k32 u8 x u8 -> s32, exact for any order (each sum is at
// most 256 * 255^2 < 2^31).  For candidate columns x (M = 16) and rows y (N = 8):
//   C[x, y] = sum_Y sum_c ref[Y, x + c] * cur[Y - y, c]
// A is a Hankel slice of two window rows (A[x, 16 j + c] = ref[Y + j, x + c]),
// B a banded Toeplitz matrix of the current block (B[16 j + c, y] =
// cur[Y + j - y, c], zero outside its 16 rows) that is the same for every tile,
// so a warp keeps B for all 12 row pairs in registers and loads each A fragment
// once for every tile it feeds.  sum r^2 is an exact int32 box sum per chunk:
// 16-byte row sums of squares (__dp4a), then running column sums.  mma.sync, not
// wgmma: the tensor-core work is ~5 us at 1080p; the operands are built per warp
// in registers, and the epilogue and staging take the time.
//
// SAD (motion_sad_kernel<2>): score = cost2[dx][dy] + SAD * (256/255).  A thread
// owns one candidate column and a run of 12 candidate rows: it loads each of the
// 27 window rows it needs once (4 aligned words) and feeds it to every
// accumulator that row reaches, with the current block's 64 words in registers.
// Four terms cost one byte-SIMD absolute-difference-and-accumulate instruction
// (vabsdiff4 ... .add; VABSDIFF4 in SASS, 64 lanes per SM per clock on the
// H100, tools/sad_rate.py) and no shift; loads are 9 words a candidate.
//
// The winner is a lexicographic (score, key) minimum over the block, key =
// (tx - xlo) * n_y + (ty - ylo): the first strict minimum of the oracle's
// tx-outer, ty-inner scan, whatever the split of candidates over threads.
// Scores are float32 with each step rounded on its own (the file is compiled
// with --fmad=false, and the intrinsics below say so again); the integer sums are
// exact (SAD <= 65,280; |partial| <= 256 * 255^2 < 2^24), so their conversions to
// float are exact.  The cost tables are built on the host in float64 and rounded
// to float32 (ops/motion.py: tables), as the JAX package does.
//
// Bound: operations.  At 1080p / 16 / 64 the clamped windows hold 1.83e7
// candidates, 4.7e9 pixel-candidate terms; the frames are 4 MB.  SAD: the terms
// at 4 a VABSDIFF4 lane-instruction; SSD: the cross term's 2 operations a term
// at the int8 tensor rate (chip_smoke.py: motion_bound).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kChunk = 48;                  // candidates per axis of a staged chunk
constexpr int kWin = kChunk + kBlock;       // staged window rows
constexpr int kThreads = 192;
constexpr int kWarps = kThreads / 32;
constexpr int kSadRun = 12;                 // candidate rows per SAD thread
constexpr int kYHalf = 24;                  // candidate rows per SSD warp (3 tiles of 8)
constexpr int kPairs = (kYHalf + kBlock) / 2;  // window row pairs an SSD warp reads
constexpr int kKSteps = 12;                 // row pairs of one tile's K (24 rows)
constexpr int kPlanFields = 8;             // ints of a macroblock's plan row
constexpr int kSadGroup = 2;                // macroblocks per CUDA block, SAD
constexpr int kSsdGroup = 4;                // and SSD
constexpr float kSadScale = 0x1.010102p+0f;  // float32(256 / 255): integer SAD -> UNORM * 256
static_assert(kThreads == kChunk * (kChunk / kSadRun), "one SAD thread per column and run");
static_assert(kWarps == (kChunk / 16) * (kChunk / kYHalf), "one SSD warp per tile group");

// Shapes of the staged window of a group of G macroblocks of one block row.
// Their windows start at most 16 columns apart, so a chunk of each one's
// candidates lies in kUnion columns of the group's window.
template <int G>
struct Geo {
  static constexpr int kUnion = kChunk + kBlock * (G - 1);   // candidate columns
  static constexpr int kUsedWords = (kUnion - 1) / 4 + 4;     // words a candidate may read
  static constexpr int kCopyWords = kUsedWords + (kUsedWords & 1);
  static constexpr int kCopyStride = kWin * kCopyWords + 8;  // +8: the copies on distinct banks
  static constexpr int kRawChunks = (4 * kUsedWords + 18 + 15) / 16;  // 16-byte chunks a row
  static constexpr int kRawWords = 4 * kRawChunks;
  static constexpr int kSqStride = kUnion + 4;               // 2 * stride = 8 mod 32 banks
  static constexpr int kSegs = kThreads / kUnion;            // box-sum threads per column
  static constexpr int kSegRows = kChunk / kSegs;
  static constexpr int kScratch =
      kWin * kRawWords > kChunk * kSqStride ? kWin * kRawWords : kChunk * kSqStride;
  static_assert(kThreads % kUnion == 0 && kChunk % kSegs == 0, "box-sum split");
  static_assert(kUsedWords + 5 <= kRawWords, "raw row holds every copy word");
};

// Dynamic shared memory of a block.  scratch holds the raw rows while the
// copies are built, then (kSq, the SSD kernel) the box sums sq[y][x] = sum of
// r^2 over the 16 x 16 box of candidate (x, y).
template <int G, bool kSq>
struct Shared {
  // copy s, row r, word k = window bytes [4k + s, 4k + s + 4) of row r
  uint32_t copy[4 * Geo<G>::kCopyStride];
  uint32_t scratch[kSq ? Geo<G>::kScratch : kWin * Geo<G>::kRawWords];
  uint32_t cur[G][kBlock * kBlock / 4];     // the group's current blocks
  float red_s[2][kWarps];
  int red_k[2][kWarps];
  float best_s[G];
  int best_k[G];
};

__device__ __forceinline__ bool better(float s, int k, float bs, int bk) {
  return s < bs || (s == bs && k < bk);
}

// d = c + sum over the four bytes of |a - b|
__device__ __forceinline__ int sad4_acc(uint32_t a, uint32_t b, int c) {
  int d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// c += A (16 x 32 u8, row-major fragment) * B (32 x 8 u8, column-major fragment)
__device__ __forceinline__ void mma_u8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// plan row of a macroblock (ops/motion.py: plan)
struct Plan {
  int ox, oy, xlo, ylo, n_x, n_y, di0, dj0;
};
static_assert(sizeof(Plan) == kPlanFields * sizeof(int), "plan row layout");

__device__ __forceinline__ Plan read_plan(const int* __restrict__ plan, int mb) {
  const int* p = plan + kPlanFields * mb;
  return Plan{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3),
              __ldg(p + 4), __ldg(p + 5), __ldg(p + 6), __ldg(p + 7)};
}

// The group's current blocks, 16 x 16 bytes each as 64 words (row-major); the
// block minima start empty.
template <int G, bool kSq>
__device__ void stage_current(const uint8_t* __restrict__ cur, int w, const int* __restrict__ plan,
                              int first, int count, Shared<G, kSq>& s) {
  const int tid = threadIdx.x;
  for (int i = tid; i < count * kBlock * kBlock / 4; i += kThreads) {
    const int k = i >> 6, j = i & 63;
    const Plan p = read_plan(plan, first + k);
    const uint8_t* q = cur + static_cast<size_t>(p.oy + (j >> 2)) * w + p.ox + 4 * (j & 3);
    uint32_t v;
    if ((reinterpret_cast<uintptr_t>(q) & 3) == 0) {
      v = *reinterpret_cast<const uint32_t*>(q);
    } else {
      v = q[0] | (q[1] << 8) | (q[2] << 16) | (static_cast<uint32_t>(q[3]) << 24);
    }
    s.cur[k][j] = v;
  }
  if (tid < G) {
    s.best_s[tid] = __int_as_float(0x7f800000);  // +inf
    s.best_k[tid] = 0x7fffffff;
  }
}

// Stage the kWin rows of the group's window at (wy0, wx0) as four shifted
// copies.  Rows past the frame's last row read as zero; columns past its right
// edge hold other bytes of the buffer, which only candidates outside the
// windows ever touch.
template <int G, bool kSq>
__device__ void stage_window(const uint8_t* __restrict__ ref, int h, int w, int wy0, int wx0,
                             Shared<G, kSq>& s) {
  using Gm = Geo<G>;
  const int tid = threadIdx.x;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(ref);
  const uintptr_t hi = lo + static_cast<size_t>(h) * w;
  for (int i = tid; i < kWin * Gm::kRawChunks; i += kThreads) {
    const int r = i / Gm::kRawChunks;
    const int c = i - r * Gm::kRawChunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (wy0 + r < h) {
      const uintptr_t row = lo + static_cast<size_t>(wy0 + r) * w + wx0;
      const uintptr_t a = (row & ~uintptr_t(15)) + 16 * c;
      if (a >= lo && a + 16 <= hi) {
        v = __ldg(reinterpret_cast<const uint4*>(a));
      } else {  // a chunk across either end of the frame's buffer
        uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (a + k >= lo && a + k < hi) {
            const uint32_t byte = *reinterpret_cast<const uint8_t*>(a + k);
            b[k >> 2] |= byte << (8 * (k & 3));
          }
        }
        v = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
    *reinterpret_cast<uint4*>(s.scratch + r * Gm::kRawWords + 4 * c) = v;
  }
  __syncthreads();
  // word k of copy sh is window bytes [4k + sh, 4k + sh + 4): raw bytes from
  // m + 4k + sh, m the row's offset in its first aligned chunk; three raw words
  // hold all four copies' words
  const uint32_t lo32 = static_cast<uint32_t>(lo) + static_cast<uint32_t>(wx0);
  for (int i = tid; i < kWin * Gm::kUsedWords; i += kThreads) {
    const int r = i / Gm::kUsedWords;
    const int k = i - r * Gm::kUsedWords;
    const uint32_t b = ((lo32 + static_cast<uint32_t>(wy0 + r) * static_cast<uint32_t>(w)) & 15) +
                       4 * k;
    const uint32_t* raw = s.scratch + r * Gm::kRawWords + (b >> 2);
    const uint32_t w0 = raw[0], w1 = raw[1], w2 = raw[2];
    uint32_t* dst = s.copy + r * Gm::kCopyWords + k;
#pragma unroll
    for (int sh = 0; sh < 4; ++sh) {
      const uint32_t o = (b & 3) + sh;  // 0..6 bytes into w0
      dst[sh * Gm::kCopyStride] =
          o < 4 ? __funnelshift_r(w0, w1, 8 * o) : __funnelshift_r(w1, w2, 8 * o);
    }
  }
  __syncthreads();
}

// Box sums of r^2 for the group's chunk: thread (column x, segment) sums 16
// squares along each of its rows (__dp4a on the copy words), then 16 rows.
template <int G>
__device__ void box_sums(Shared<G, true>& s) {
  using Gm = Geo<G>;
  const int x = threadIdx.x % Gm::kUnion;
  const int y0 = threadIdx.x / Gm::kUnion * Gm::kSegRows;
  const uint32_t* wd = s.copy + (x & 3) * Gm::kCopyStride + y0 * Gm::kCopyWords + (x >> 2);
  int hr[Gm::kSegRows + kBlock - 1];
#pragma unroll
  for (int j = 0; j < Gm::kSegRows + kBlock - 1; ++j) {
    unsigned acc = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t v = wd[j * Gm::kCopyWords + q];
      acc = __dp4a(v, v, acc);
    }
    hr[j] = static_cast<int>(acc);
  }
  int* sq = reinterpret_cast<int*>(s.scratch) + y0 * Gm::kSqStride + x;
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kBlock; ++j) sum += hr[j];
  sq[0] = sum;
#pragma unroll
  for (int j = 1; j < Gm::kSegRows; ++j) {
    sum += hr[j + kBlock - 1] - hr[j - 1];
    sq[j * Gm::kSqStride] = sum;
  }
}

// (score, key) minimum of the block for macroblock k of the group, merged into
// its running minimum by thread 0.  red_* alternate with k, so one barrier
// keeps the next macroblock's partial minima off those being read.
template <int G, bool kSq>
__device__ void block_min(float best_s, int best_k, int k, Shared<G, kSq>& s) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_down_sync(0xffffffffu, best_s, off);
    const int ko = __shfl_down_sync(0xffffffffu, best_k, off);
    if (better(so, ko, best_s, best_k)) {
      best_s = so;
      best_k = ko;
    }
  }
  if ((tid & 31) == 0) {
    s.red_s[k & 1][tid >> 5] = best_s;
    s.red_k[k & 1][tid >> 5] = best_k;
  }
  __syncthreads();
  if (tid == 0) {
    float bs = s.best_s[k];
    int bk = s.best_k[k];
    for (int i = 0; i < kWarps; ++i) {
      if (better(s.red_s[k & 1][i], s.red_k[k & 1][i], bs, bk)) {
        bs = s.red_s[k & 1][i];
        bk = s.red_k[k & 1][i];
      }
    }
    s.best_s[k] = bs;
    s.best_k[k] = bk;
  }
}

// Thread k writes the MV of macroblock k of the group.
template <int G, bool kSq>
__device__ void write_mvs(const int* __restrict__ plan, int first, int count, int search,
                          const uint8_t* __restrict__ mv_u8, uint8_t* __restrict__ out,
                          Shared<G, kSq>& s) {
  __syncthreads();
  const int k = threadIdx.x;
  if (k >= count) return;
  const Plan p = read_plan(plan, first + k);
  const int best_k = s.best_k[k];
  int mvx = 0, mvy = 0;  // an empty window keeps the zero vector
  if (best_k != 0x7fffffff) {
    const int ix = best_k / p.n_y;
    mvx = p.ox - (p.xlo + ix);
    mvy = p.oy - (p.ylo + best_k - ix * p.n_y);
  }
  const int max_mv = search / 2;
  uint8_t* o = out + 4 * (first + k);
  o[0] = mv_u8[min(max(mvx, -max_mv), max_mv) + max_mv];
  o[1] = 128;  // rint(0.5 * 255), half to even
  o[2] = mv_u8[min(max(mvy, -max_mv), max_mv) + max_mv];
  o[3] = 255;
}

// The widest candidate range of the group's macroblocks (chunks are counted
// from each one's own first candidate).
__device__ __forceinline__ int group_n_x(const int* __restrict__ plan, int first, int count) {
  int n_x = 0;
  for (int k = 0; k < count; ++k) n_x = max(n_x, __ldg(plan + kPlanFields * (first + k) + 4));
  return n_x;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    motion_sad_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ ref, int h,
                      int w, int search, int n_d, const int* __restrict__ plan,
                      const int* __restrict__ groups, const float* __restrict__ cost2,
                      const uint8_t* __restrict__ mv_u8, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  Shared<G, false>& s = *reinterpret_cast<Shared<G, false>*>(smem);
  using Gm = Geo<G>;
  const int tid = threadIdx.x;
  const int first = groups[2 * blockIdx.x], count = groups[2 * blockIdx.x + 1];
  stage_current<G>(cur, w, plan, first, count, s);
  const int x = tid % kChunk;               // candidate column in the chunk
  const int y0 = (tid / kChunk) * kSadRun;  // first candidate row of the thread's run
  const Plan p0 = read_plan(plan, first);
  const int n_x = group_n_x(plan, first, count);
  for (int cy0 = 0; cy0 < p0.n_y; cy0 += kChunk) {
    for (int cx0 = 0; cx0 < n_x; cx0 += kChunk) {
      stage_window<G>(ref, h, w, p0.ylo + cy0, p0.xlo + cx0, s);
      for (int k = 0; k < count; ++k) {
        const Plan p = read_plan(plan, first + k);
        const int u = p.xlo - p0.xlo;  // the macroblock's chunk in the group's window
        uint32_t cw[kBlock * kBlock / 4];
#pragma unroll
        for (int i = 0; i < kBlock * kBlock / 4; ++i) cw[i] = s.cur[k][i];
        const uint32_t* col =
            s.copy + ((u + x) & 3) * Gm::kCopyStride + y0 * Gm::kCopyWords + ((u + x) >> 2);
        int acc[kSadRun];
#pragma unroll
        for (int j = 0; j < kSadRun; ++j) acc[j] = 0;
#pragma unroll
        for (int yi = 0; yi < kSadRun + kBlock - 1; ++yi) {  // the run's 27 window rows
          uint32_t rw[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) rw[q] = col[yi * Gm::kCopyWords + q];
#pragma unroll
          for (int j = 0; j < kSadRun; ++j) {
            const int r = yi - j;  // the row of the current block that meets this window row
            if (r >= 0 && r < kBlock) {
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[j] = sad4_acc(cw[r * 4 + q], rw[q], acc[j]);
            }
          }
        }
        float best_s = __int_as_float(0x7f800000);  // +inf
        int best_k = 0x7fffffff;
        const int ix = cx0 + x;
        if (x < p.n_x - cx0) {
          const float* c2 = cost2 + (p.di0 + ix) * n_d + p.dj0 + cy0;
#pragma unroll
          for (int j = 0; j < kSadRun; ++j) {
            const int y = y0 + j;
            if (y < p.n_y - cy0) {
              const float score =
                  __fadd_rn(c2[y], __fmul_rn(static_cast<float>(acc[j]), kSadScale));
              const int key = ix * p.n_y + cy0 + y;
              if (better(score, key, best_s, best_k)) {
                best_s = score;
                best_k = key;
              }
            }
          }
        }
        block_min<G>(best_s, best_k, k, s);
      }
      __syncthreads();  // the next chunk overwrites the window
    }
  }
  write_mvs<G>(plan, first, count, search, mv_u8, out, s);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    motion_ssd_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ ref, int h,
                      int w, int search, const int* __restrict__ plan,
                      const int* __restrict__ groups, const float* __restrict__ axis,
                      const uint8_t* __restrict__ mv_u8, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  Shared<G, true>& s = *reinterpret_cast<Shared<G, true>*>(smem);
  using Gm = Geo<G>;
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int x0 = 16 * ((tid >> 5) % (kChunk / 16));       // the warp's 16 candidate columns
  const int yw = kYHalf * ((tid >> 5) / (kChunk / 16));   // and its 24 candidate rows
  const int first = groups[2 * blockIdx.x], count = groups[2 * blockIdx.x + 1];
  stage_current<G>(cur, w, plan, first, count, s);
  const int* sq = reinterpret_cast<const int*>(s.scratch);
  const Plan p0 = read_plan(plan, first);
  const int n_x = group_n_x(plan, first, count);
  for (int cy0 = 0; cy0 < p0.n_y; cy0 += kChunk) {
    for (int cx0 = 0; cx0 < n_x; cx0 += kChunk) {
      stage_window<G>(ref, h, w, p0.ylo + cy0, p0.xlo + cx0, s);
      box_sums<G>(s);
      __syncthreads();
      for (int k = 0; k < count; ++k) {
        const Plan p = read_plan(plan, first + k);
        const int u = p.xlo - p0.xlo;  // the macroblock's chunk in the group's window
        // B fragments of the 12 row pairs: lane (g, t) holds cur[2 kk + b - g][4t .. 4t + 3]
        uint32_t bf[kKSteps][2];
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int r = 2 * kk + b - g;
            bf[kk][b] = (r >= 0 && r < kBlock) ? s.cur[k][r * 4 + t] : 0u;
          }
        }
        // A fragments: lane (g, t), register q reads copy (u + x0 + g) & 3, row
        // Y + (q >> 1), word (u + x0 + g) / 4 + 2 (q & 1) + t
        const int a0x = u + x0 + g;
        const uint32_t* a_col =
            s.copy + (a0x & 3) * Gm::kCopyStride + yw * Gm::kCopyWords + (a0x >> 2) + t;
        // sum c r: tile i holds candidate rows yw + 8 i + [0, 8); window row pair
        // yw + 2 pr meets tile i at K step pr - 4 i
        int acc[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = 0;
        }
#pragma unroll
        for (int pr = 0; pr < kPairs; ++pr) {
          const uint32_t* a = a_col + 2 * pr * Gm::kCopyWords;
          const uint32_t a0 = a[0], a1 = a[2], a2 = a[Gm::kCopyWords], a3 = a[Gm::kCopyWords + 2];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int kk = pr - 4 * i;
            if (kk >= 0 && kk < kKSteps) mma_u8(acc[i], a0, a1, a2, a3, bf[kk][0], bf[kk][1]);
          }
        }
        // accumulator (i, q) is candidate x = x0 + g + 8 (q >> 1),
        // y = yw + 8 i + 2 t + (q & 1); the thread's 2 column and 6 row costs
        const int cx_n = p.n_x - cx0, cy_n = p.n_y - cy0;
        float cx[2], cy[3][2];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int x = x0 + g + 8 * v;
          cx[v] = x < cx_n ? axis[p.di0 + cx0 + x] : 0.0f;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int y = yw + 8 * i + 2 * t + v;
            cy[i][v] = y < cy_n ? axis[p.dj0 + cy0 + y] : 0.0f;
          }
        }
        float best_s = __int_as_float(0x7f800000);  // +inf
        int best_k = 0x7fffffff;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int x = x0 + g + 8 * (q >> 1);
            const int y = yw + 8 * i + 2 * t + (q & 1);
            if (x < cx_n && y < cy_n) {
              const int partial = sq[y * Gm::kSqStride + u + x] - 2 * acc[i][q];
              const float score = __fadd_rn(
                  __fadd_rn(__fmul_rn(static_cast<float>(partial), 0.0625f), cy[i][q & 1]),
                  cx[q >> 1]);
              const int key = (cx0 + x) * p.n_y + cy0 + y;
              if (better(score, key, best_s, best_k)) {
                best_s = score;
                best_k = key;
              }
            }
          }
        }
        block_min<G>(best_s, best_k, k, s);
      }
      __syncthreads();  // the next chunk overwrites the window and the sums
    }
  }
  write_mvs<G>(plan, first, count, search, mv_u8, out, s);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

}  // namespace

// Full search of cur against ref (h x w u8, row-major, on the device) with 16x16
// blocks and a `search`-pixel window.  plan: [h / 16 * (w / 16), kPlanFields]
// int32 rows of ops/motion.py: plan, one per macroblock in row-major order;
// groups: [n_groups, 2] int32 (first macroblock, count) of ops/motion.py:
// groups, one CUDA block each, kSadGroup (SAD) or kSsdGroup (SSD) macroblocks at
// most.  metric 0 = SAD: cost = cost2 [n_d * n_d]; 1 = SSD: cost = the per-axis
// half [n_d], read as cy then cx.  mv_u8 [search / 2 * 2 + 1] maps a clamped
// vector component to its u8 channel.  out: [h / 16 * (w / 16), 4] u8.  Launches
// on `stream` and returns the launch's CUDA error code.
extern "C" int sv_motion_search(const void* cur, const void* ref, int h, int w, int search,
                                int metric, const void* plan, const void* groups, int n_groups,
                                int n_d, const void* cost, const void* mv_u8, void* out,
                                void* stream) {
  const auto* c = static_cast<const uint8_t*>(cur);
  const auto* r = static_cast<const uint8_t*>(ref);
  const auto* pl = static_cast<const int*>(plan);
  const auto* gr = static_cast<const int*>(groups);
  const auto* co = static_cast<const float*>(cost);
  const auto* lut = static_cast<const uint8_t*>(mv_u8);
  auto* o = static_cast<uint8_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (metric == 0) {
    const int smem = static_cast<int>(sizeof(Shared<kSadGroup, false>));
    const cudaError_t e = allow_smem(motion_sad_kernel<kSadGroup>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    motion_sad_kernel<kSadGroup><<<n_groups, kThreads, smem, st>>>(c, r, h, w, search, n_d, pl,
                                                                   gr, co, lut, o);
  } else {
    const int smem = static_cast<int>(sizeof(Shared<kSsdGroup, true>));
    const cudaError_t e = allow_smem(motion_ssd_kernel<kSsdGroup>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    motion_ssd_kernel<kSsdGroup><<<n_groups, kThreads, smem, st>>>(c, r, h, w, search, pl, gr,
                                                                   co, lut, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The geometry that ops/motion.py mirrors (its GEOMETRY, in this order): writes
// up to n values to out and returns how many there are.
extern "C" int sv_motion_geometry(int* out, int n) {
  const int geometry[] = {kBlock,  kChunk,      kThreads,  kSadRun,  kYHalf,
                          kKSteps, kPlanFields, kSadGroup, kSsdGroup};
  const int count = static_cast<int>(sizeof(geometry) / sizeof(geometry[0]));
  for (int i = 0; i < count && i < n; ++i) out[i] = geometry[i];
  return count;
}
