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
//
// Coarse mode, the first stage of the two-stage search ops/motion.py:
// me_fullsearch_pyramid, replaces the JAX package's
// motion.py::_me_mxu_program(grouped, raw=True, stride), which reduces in two
// stages: over ty first by (inner, ty), inner = f32(partial) * 2^-4 + cy, then
// over tx by (inner + cx, tx).  That is one lexicographic minimum of
// (score, tx, inner, ty), which the kernels take with key = (ix << 16) | iy,
// and they write the raw integer vector (ox - tx, oy - ty), not the RGBA map,
// for the refine stage.  With a candidate stride of 2 only every second tx of
// the global grid (tx - ox - d_lo even, so every grid tx of the frame has the
// parity of d_lo) and every second ty of the window (ty - ylo even) compete.
// motion_coarse_kernel<4> stages, multiplies, sums and reduces those
// candidates alone.  Two warps per macroblock of a group of four; a chunk is
// 24 x 24 grid candidates.  The cross term is transposed against K5's: an
// m16n8k32 tile holds 16 grid rows (M) by 8 grid columns (N), and K is 32
// window columns of one current-block row r, so
//   C[m, n] = sum_r sum_c' win[2 m + r][x0 + c'] * cur[r][c' - 2 n - delta],
// A a slice of every second window row, B a band of the current row r with
// stride-2 steps (delta = 0 or 2 puts the tile's first grid column at an even
// byte of an aligned word; 2 n + delta + 15 < 32 for n < 8).  Every grid
// column starts at a byte of one parity, so ONE staged copy of the window,
// shifted to that parity, gives every A register as one aligned 32-bit shared
// load, and neighbouring N tiles share half their A words.  sum r^2 is summed
// at grid positions only (__dp4a row sums of 16 squares at every second
// column, running sums over every second row).  The epilogue visits grid
// candidates only.  Stride 1 (no group size of ops/motion.py: PYRAMID_GROUPS
// divides the block columns) is the dense grid: motion_ssd_kernel<4, true>,
// K5 with the two-stage minimum.
//
// Scores are float32 with each step rounded on its own (the file is compiled
// with --fmad=false, and the intrinsics below say so again); the integer sums are
// exact (SAD <= 65,280; |partial| <= 256 * 255^2 < 2^24), so their conversions to
// float are exact.  The cost tables are built on the host in float64 and rounded
// to float32 (ops/motion.py: tables), as the JAX package does.
//
// Refine (motion_refine_kernel): the pyramid's second stage, which the JAX
// package runs in XLA outside Pallas (motion.py::_me_refine_program).  One
// warp per macroblock stages its win x win patch (win = 16 + 2 refine) around
// its coarse vector, clamped into the frame, as four byte-shifted copies in
// shared memory.  Its (2 refine + 1)^2 candidates x 4 quarters of the block's
// rows are split over all 32 lanes: lane 4 c + q scores rows 4 q .. 4 q + 3
// of candidate 8 i + c in round i, 16 aligned words against the current rows
// it holds in registers (vabsdiff4 for SAD, __dp4a for r^2 and c r, exact in
// int32); two xor-shuffles add the quarters.  The float32 score keeps the
// plain version's order, and a warp (score, s) minimum picks the first minimum
// in tx-major order.  Candidates outside the macroblock's clamped window are
// left out; none left gives the zero vector.  It exists because the same
// stage as torch ops took about 20 times the coarse launch's device time on an
// H100 (chip_smoke.py phase 17, PERF.md).
//
// Bound: operations.  At 1080p / 16 / 64 the clamped windows hold 1.83e7
// candidates, 4.7e9 pixel-candidate terms; the frames are 4 MB.  SAD: the terms
// at 4 a VABSDIFF4 lane-instruction; SSD: the cross term's 2 operations a term
// at the int8 tensor rate (chip_smoke.py: motion_bound).  The coarse kernel:
// the stride-2 grid's cross-term operations at the int8 tensor rate against
// the frames' bytes, the refine kernel likewise for its candidates; both come
// out bound by bytes (chip_smoke.py phase 17: grid_candidates).

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
constexpr int kRefineWarps = 8;            // macroblocks per CUDA block, refine
constexpr int kGridChunk = 24;              // grid candidates per axis of a coarse chunk
constexpr int kSqSegs = 4;                  // coarse box-sum threads per grid column
constexpr int kCurWords = 12;               // words of a zero-padded current row (coarse)
constexpr float kSadScale = 0x1.010102p+0f;  // float32(256 / 255): integer SAD -> UNORM * 256
static_assert(kThreads == kChunk * (kChunk / kSadRun), "one SAD thread per column and run");
static_assert(kWarps == (kChunk / 16) * (kChunk / kYHalf), "one SSD warp per tile group");
static_assert(2 * kGridChunk == kChunk && kGridChunk == 8 * 3 && kGridChunk % kSqSegs == 0,
              "a coarse chunk: kWin window rows, 3 N tiles, 2 overlapping M tiles");

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
  float red_i[2][kWarps];  // coarse mode: the inner score of red_s
  float best_s[G];
  int best_k[G];
  float best_i[G];
};

__device__ __forceinline__ bool better(float s, int k, float bs, int bk) {
  return s < bs || (s == bs && k < bk);
}

// Coarse mode: (score, tx, inner, ty) with key = (ix << 16) | iy.
__device__ __forceinline__ bool better_coarse(float s, int k, float in, float bs, int bk,
                                              float bin) {
  if (s != bs) return s < bs;
  if ((k >> 16) != (bk >> 16)) return k < bk;
  return in < bin || (in == bin && k < bk);
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
// block minima start empty.  Sh: a kernel's shared layout (cur, best_*).
template <int G, typename Sh>
__device__ void stage_current(const uint8_t* __restrict__ cur, int w, const int* __restrict__ plan,
                              int first, int count, Sh& s) {
  const int tid = threadIdx.x;
  for (int i = tid; i < count * kBlock * kBlock / 4; i += blockDim.x) {
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
    s.best_i[tid] = __int_as_float(0x7f800000);
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
// its running minimum by thread 0; in coarse mode the (score, tx, inner, ty)
// minimum.  red_* alternate with k, so one barrier keeps the next macroblock's
// partial minima off those being read.
template <bool kCoarse>
__device__ __forceinline__ bool better_of(float s, int k, float in, float bs, int bk,
                                          float bin) {
  if constexpr (kCoarse) {
    return better_coarse(s, k, in, bs, bk, bin);
  } else {
    return better(s, k, bs, bk);
  }
}

template <int G, bool kSq, bool kCoarse = false>
__device__ void block_min(float best_s, int best_k, float best_i, int k, Shared<G, kSq>& s) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_down_sync(0xffffffffu, best_s, off);
    const int ko = __shfl_down_sync(0xffffffffu, best_k, off);
    float io = 0.0f;
    if constexpr (kCoarse) io = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better_of<kCoarse>(so, ko, io, best_s, best_k, best_i)) {
      best_s = so;
      best_k = ko;
      best_i = io;
    }
  }
  if ((tid & 31) == 0) {
    s.red_s[k & 1][tid >> 5] = best_s;
    s.red_k[k & 1][tid >> 5] = best_k;
    if constexpr (kCoarse) s.red_i[k & 1][tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    float bs = s.best_s[k];
    int bk = s.best_k[k];
    float bi = s.best_i[k];
    for (int i = 0; i < kWarps; ++i) {
      const float ri = kCoarse ? s.red_i[k & 1][i] : 0.0f;
      if (better_of<kCoarse>(s.red_s[k & 1][i], s.red_k[k & 1][i], ri, bs, bk, bi)) {
        bs = s.red_s[k & 1][i];
        bk = s.red_k[k & 1][i];
        bi = ri;
      }
    }
    s.best_s[k] = bs;
    s.best_k[k] = bk;
    s.best_i[k] = bi;
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

// Coarse mode: thread k writes the raw vector (ox - tx, oy - ty) of
// macroblock k of the group as two int32, (0, 0) for an empty candidate set.
template <int G, bool kSq>
__device__ void write_raw(const int* __restrict__ plan, int first, int count, int* __restrict__ raw,
                          Shared<G, kSq>& s) {
  __syncthreads();
  const int k = threadIdx.x;
  if (k >= count) return;
  const Plan p = read_plan(plan, first + k);
  const int best_k = s.best_k[k];
  int mvx = 0, mvy = 0;
  if (best_k != 0x7fffffff) {
    mvx = p.ox - (p.xlo + (best_k >> 16));
    mvy = p.oy - (p.ylo + (best_k & 0xffff));
  }
  raw[2 * (first + k)] = mvx;
  raw[2 * (first + k) + 1] = mvy;
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
        block_min<G>(best_s, best_k, 0.0f, k, s);
      }
      __syncthreads();  // the next chunk overwrites the window
    }
  }
  write_mvs<G>(plan, first, count, search, mv_u8, out, s);
}

// kCoarse: the pyramid's coarse stage on the stride-1 (dense) grid (the
// two-stage minimum, raw vectors into `raw`); otherwise the exhaustive search
// (RGBA map into `out`).
template <int G, bool kCoarse>
__global__ void __launch_bounds__(kThreads)
    motion_ssd_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ ref, int h,
                      int w, int search, const int* __restrict__ plan,
                      const int* __restrict__ groups, const float* __restrict__ axis,
                      const uint8_t* __restrict__ mv_u8, uint8_t* __restrict__ out,
                      int* __restrict__ raw) {
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
        float best_i = __int_as_float(0x7f800000);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int x = x0 + g + 8 * (q >> 1);
            const int y = yw + 8 * i + 2 * t + (q & 1);
            if (x < cx_n && y < cy_n) {
              const int partial = sq[y * Gm::kSqStride + u + x] - 2 * acc[i][q];
              const float inner =
                  __fadd_rn(__fmul_rn(static_cast<float>(partial), 0.0625f), cy[i][q & 1]);
              const float score = __fadd_rn(inner, cx[q >> 1]);
              if constexpr (kCoarse) {
                const int key = ((cx0 + x) << 16) | (cy0 + y);
                if (better_coarse(score, key, inner, best_s, best_k, best_i)) {
                  best_s = score;
                  best_k = key;
                  best_i = inner;
                }
              } else {
                const int key = (cx0 + x) * p.n_y + cy0 + y;
                if (better(score, key, best_s, best_k)) {
                  best_s = score;
                  best_k = key;
                }
              }
            }
          }
        }
        block_min<G, true, kCoarse>(best_s, best_k, best_i, k, s);
      }
      __syncthreads();  // the next chunk overwrites the window and the sums
    }
  }
  if constexpr (kCoarse) {
    write_raw<G>(plan, first, count, raw, s);
  } else {
    write_mvs<G>(plan, first, count, search, mv_u8, out, s);
  }
}

// The 16 bytes at address a (any alignment) as 4 words, from the two aligned
// 16-byte granules that hold them.  Each granule's address is clamped into
// [lo16, last16], the granules of the frame's buffer, so a load never leaves
// them and never branches: a byte of the buffer comes back as itself, a
// byte outside it as some other byte of the buffer, which the callers never
// use (the candidates inside the clamped windows read the frame alone).
__device__ __forceinline__ void bytes16(uintptr_t a, uintptr_t lo16, uintptr_t last16,
                                        uint32_t (&o)[4]) {
  const uintptr_t a0 = a & ~uintptr_t(15);
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(min(max(a0, lo16), last16)));
  const uint4 y = __ldg(reinterpret_cast<const uint4*>(min(max(a0 + 16, lo16), last16)));
  const uint32_t v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  const int q = static_cast<int>(a >> 2) & 3;  // whole words to skip, by selects
  const uint32_t sh = 8 * static_cast<uint32_t>(a & 3);
  uint32_t u[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    u[i] = q == 0 ? v[i] : q == 1 ? v[i + 1] : q == 2 ? v[i + 2] : v[i + 3];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __funnelshift_r(u[i], u[i + 1], sh);
}

// Bytes o .. o + 3 of a 16-byte row (4 words), zero outside it; o may be
// negative.
__device__ __forceinline__ uint32_t row_bytes(const uint32_t* row, int o) {
  const int i = o >> 2;  // floor
  const uint32_t lo = (i >= 0 && i < 4) ? row[i] : 0u;
  const uint32_t hi = (i >= -1 && i < 3) ? row[i + 1] : 0u;
  return __funnelshift_r(lo, hi, 8 * (o & 3));
}

// Shapes of the coarse kernel's staged chunk for a group of G macroblocks:
// kWin window rows of kWords words, word k = bytes [4 k, 4 k + 4) from the
// group's first grid column.  Each macroblock's first grid column lies a_k <=
// 16 (G - 1) bytes in (even), so its 24 grid columns start below 2 kUnionGrid.
template <int G>
struct CoarseGeo {
  static constexpr int kThreads = 64 * G;                     // two warps a macroblock
  static constexpr int kUnionGrid = kGridChunk + 8 * (G - 1);  // the group's grid columns
  static constexpr int kWords = 4 * (G - 1) + 16;              // words an A load may read
  // row stride = 2 mod 16 words: rows 2 g + r of lanes g land 4 banks apart
  static constexpr int kRowStride = kWords + (18 - kWords % 16) % 16;
  // sum r^2 at grid (row y, column u): plane u & 1, row y, word u >> 1; the
  // stride is 4 x odd, so an epilogue load (lanes g: rows, t: words) and a
  // box-sum store (two planes) hit 32 banks
  static constexpr int kSqStride = 4 * (((kUnionGrid / 2 + 3) / 4) | 1);
  static constexpr int kSqPlane =
      kGridChunk * kSqStride + (48 - (kGridChunk * kSqStride) % 32) % 32;  // = 16 mod 32
  static constexpr int kSqRows = kGridChunk / kSqSegs;  // grid rows a box-sum thread sums
  static_assert(kUnionGrid / 2 * kSqSegs <= kThreads, "a box-sum thread per column pair, segment");
  static_assert(kRowStride % 16 == 2 && kSqPlane % 32 == 16, "bank spread");
};

template <int G>
struct CoarseShared {
  uint32_t copy[kWin * CoarseGeo<G>::kRowStride];
  int sq[2 * CoarseGeo<G>::kSqPlane];
  uint32_t cur[G][kBlock * kBlock / 4];
  // macroblock k's current rows, zero-padded by 16 bytes on each side, as
  // words from padded byte 2 s: word w of plane s, row r = row bytes [4 w +
  // 2 s - 16, 4 w + 2 s - 12), zero outside the row; a B register is one word
  uint32_t curp[G][2][kBlock][kCurWords];
  Plan plan[G];
  float red_s[2 * G];
  int red_k[2 * G];
  float red_i[2 * G];
  float best_s[G];
  int best_k[G];
  float best_i[G];
};

// The coarse stage on the stride-2 grid: the group `groups[blockIdx.x]` of at
// most G macroblocks; warp 2 k + mt takes macroblock k's grid rows 8 mt + [0,
// 16) of each chunk (mt = 1 scores only 16 .. 23, the rows 8 .. 15 it shares
// with mt = 0 are the other warp's) and all 24 grid columns (3 N tiles).
template <int G>
__global__ void __launch_bounds__(64 * G, 3)
    motion_coarse_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ ref, int h,
                         int w, const int* __restrict__ plan, const int* __restrict__ groups,
                         const float* __restrict__ axis, int* __restrict__ raw) {
  using Cg = CoarseGeo<G>;
  extern __shared__ uint4 smem[];
  CoarseShared<G>& s = *reinterpret_cast<CoarseShared<G>*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int first = groups[2 * blockIdx.x], count = groups[2 * blockIdx.x + 1];
  if (tid < count * kPlanFields) {
    reinterpret_cast<int*>(s.plan)[tid] = __ldg(plan + kPlanFields * first + tid);
  }
  stage_current<G>(cur, w, plan, first, count, s);
  __syncthreads();  // the plan rows and the current blocks
  const Plan p0 = s.plan[0];
  const int e0 = p0.di0 & 1;
  const int nyg = (p0.n_y + 1) >> 1;  // grid rows of every window of the group
  int nxg_max = 0;
  for (int k = 0; k < count; ++k) {
    nxg_max = max(nxg_max, (s.plan[k].n_x - (s.plan[k].di0 & 1) + 1) >> 1);
  }
  const int k = warp >> 1, mt = warp & 1;
  const bool active = k < count;
  const Plan p = s.plan[active ? k : 0];
  const int ek = p.di0 & 1;                 // grid ix = ek + 2 (grid column)
  const int nxg = (p.n_x - ek + 1) >> 1;    // the macroblock's grid columns
  const int a = p.xlo - p0.xlo + ek - e0;  // its first grid column in the staged row (even)
  const int wd0 = a >> 2;
  for (int i = tid; i < count * 2 * kBlock * kCurWords; i += Cg::kThreads) {
    const int wd = i % kCurWords, rest = i / kCurWords;  // rest = (k, plane, row)
    reinterpret_cast<uint32_t*>(s.curp)[i] =
        row_bytes(s.cur[rest / (2 * kBlock)] + 4 * (rest % kBlock),
                  4 * wd + 2 * ((rest / kBlock) & 1) - 16);
  }
  // B fragments: lane (g, t) register b holds B[16 b + 4 t + e, g] =
  // cur[r][o_b + e], o_b = 16 b + 4 t - 2 g - delta (delta = a & 3), the word
  // (o_b + 16) >> 2 of plane (o_b >> 1) & 1
  const int o0 = 4 * t - 2 * g - (a & 3), o1 = o0 + 16;
  const uint32_t* b0 = &s.curp[k][(o0 >> 1) & 1][0][(o0 + 16) >> 2];
  const uint32_t* b1 = &s.curp[k][(o1 >> 1) & 1][0][(o1 + 16) >> 2];
  const uintptr_t lo = reinterpret_cast<uintptr_t>(ref);
  const uintptr_t lo16 = lo & ~uintptr_t(15);
  const uintptr_t last16 = (lo + static_cast<size_t>(h) * w - 1) & ~uintptr_t(15);
  for (int cgy0 = 0; cgy0 < nyg; cgy0 += kGridChunk) {
    for (int cgx0 = 0; cgx0 < nxg_max; cgx0 += kGridChunk) {
      const int gx_n = nxg - cgx0, gy_n = nyg - cgy0;  // grid candidates left in the chunk
      // the lane's cost-table entries, loaded ahead: accumulator (j, q) is
      // grid row 8 mt + g + 8 (q >> 1), grid column 8 j + 2 t + (q & 1)
      float cx[3][2], cy[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int gx = 8 * j + 2 * t + v;
          cx[j][v] = active && gx < gx_n ? __ldg(axis + p.di0 + ek + 2 * (cgx0 + gx)) : 0.0f;
        }
        const int gy = 8 * mt + g + 8 * v;
        cy[v] = active && gy < gy_n ? __ldg(axis + p.dj0 + 2 * (cgy0 + gy)) : 0.0f;
      }
      // stage the chunk: rows from ylo + 2 cgy0, bytes from the group's first
      // grid column of the chunk; 16 bytes a thread and round, all loads
      // issued before any is used
      const int wy0 = p0.ylo + 2 * cgy0, wb = p0.xlo + 2 * cgx0 + e0;
      constexpr int kQuads = Cg::kWords / 4, kItems = kWin * kQuads;
#pragma unroll
      for (int it = 0; it < (kItems + Cg::kThreads - 1) / Cg::kThreads; ++it) {
        const int i = tid + it * Cg::kThreads;
        if (i < kItems) {
          const int r = i / kQuads, c = i - r * kQuads;
          uint32_t o[4];
          bytes16(lo + static_cast<size_t>(wy0 + r) * w + wb + 16 * c, lo16, last16, o);
          uint32_t* dst = s.copy + r * Cg::kRowStride + 4 * c;
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[e] = o[e];
        }
      }
      __syncthreads();
      // sum r^2 at grid positions: thread (column pair v, segment) sums 16
      // squares of each row from bytes 4 v (words v .. v + 3) and 4 v + 2
      // (the high half of word v, words v + 1 .. v + 3, the low half of word
      // v + 4), then 16 rows at every second row, for columns u = 2 v and
      // 2 v + 1
      if (tid < Cg::kUnionGrid / 2 * kSqSegs) {
        const int v = tid % (Cg::kUnionGrid / 2), seg = tid / (Cg::kUnionGrid / 2);
        const uint32_t* wd = s.copy + 2 * Cg::kSqRows * seg * Cg::kRowStride + v;
        constexpr int kRows = 2 * (Cg::kSqRows - 1) + kBlock;
        int hr[2][kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const uint32_t* row = wd + j * Cg::kRowStride;
          const uint32_t w0 = row[0], hi0 = w0 & 0xffff0000u, lo4 = row[4] & 0x0000ffffu;
          unsigned mid = __dp4a(row[1], row[1], 0u);
          mid = __dp4a(row[2], row[2], mid);
          mid = __dp4a(row[3], row[3], mid);
          hr[0][j] = static_cast<int>(__dp4a(w0, w0, mid));
          hr[1][j] = static_cast<int>(__dp4a(hi0, hi0, __dp4a(lo4, lo4, mid)));
        }
#pragma unroll
        for (int o = 0; o < 2; ++o) {  // column u = 2 v + o: plane o, word v
          int* sq = s.sq + o * Cg::kSqPlane + Cg::kSqRows * seg * Cg::kSqStride + v;
          int sum = 0;
#pragma unroll
          for (int j = 0; j < kBlock; ++j) sum += hr[o][j];
          sq[0] = sum;
#pragma unroll
          for (int n = 1; n < Cg::kSqRows; ++n) {
            sum += hr[o][2 * n + kBlock - 2] + hr[o][2 * n + kBlock - 1] - hr[o][2 * n - 2] -
                   hr[o][2 * n - 1];
            sq[n * Cg::kSqStride] = sum;
          }
        }
      }
      __syncthreads();
      float best_s = __int_as_float(0x7f800000);  // +inf
      int best_k = 0x7fffffff;
      float best_i = __int_as_float(0x7f800000);
      if (active && gx_n > 0 && (mt == 0 || gy_n > 16)) {
        const int nj = min((gx_n + 7) >> 3, 3);  // N tiles holding a candidate
        // sum c r: tile j, K step r: A[m, c'] = row 2 (8 mt + m) + r, bytes 4 wd0
        // + 16 j + c'; lane (g, t) loads rows 2 (8 mt + g) + r (+ 16) at words
        // wd0 + 4 j + t (+ 4), the high half of tile j is tile j + 1's low half
        int acc[3][4];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] = 0;
        }
        const uint32_t* a_lo = s.copy + 2 * (8 * mt + g) * Cg::kRowStride + wd0 + t;
#pragma unroll
        for (int r = 0; r < kBlock; ++r) {
          const uint32_t bf0 = b0[r * kCurWords], bf1 = b1[r * kCurWords];
          const uint32_t* a0 = a_lo + r * Cg::kRowStride;
          const uint32_t* a1 = a0 + 16 * Cg::kRowStride;
          uint32_t x0[4], x1[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            x0[jj] = a0[4 * jj];
            x1[jj] = a1[4 * jj];
          }
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            if (j < nj) mma_u8(acc[j], x0[j], x1[j], x0[j + 1], x1[j + 1], bf0, bf1);
          }
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (mt == 1 && q < 2) continue;  // grid rows 8 .. 15: warp mt = 0's
            const int gy = 8 * mt + g + 8 * (q >> 1), gx = 8 * j + 2 * t + (q & 1);
            if (gx < gx_n && gy < gy_n) {
              const int u = (a >> 1) + gx;  // the grid column in the staged row
              const int partial =
                  s.sq[(u & 1) * Cg::kSqPlane + gy * Cg::kSqStride + (u >> 1)] - 2 * acc[j][q];
              const float inner =
                  __fadd_rn(__fmul_rn(static_cast<float>(partial), 0.0625f), cy[q >> 1]);
              const float score = __fadd_rn(inner, cx[j][q & 1]);
              const int key = ((ek + 2 * (cgx0 + gx)) << 16) | (2 * (cgy0 + gy));
              if (better_coarse(score, key, inner, best_s, best_k, best_i)) {
                best_s = score;
                best_k = key;
                best_i = inner;
              }
            }
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float so = __shfl_down_sync(0xffffffffu, best_s, off);
        const int ko = __shfl_down_sync(0xffffffffu, best_k, off);
        const float io = __shfl_down_sync(0xffffffffu, best_i, off);
        if (better_coarse(so, ko, io, best_s, best_k, best_i)) {
          best_s = so;
          best_k = ko;
          best_i = io;
        }
      }
      if (lane == 0) {
        s.red_s[warp] = best_s;
        s.red_k[warp] = best_k;
        s.red_i[warp] = best_i;
      }
      __syncthreads();  // also: every warp is done with this chunk's window
      if (tid < count) {
        float bs = s.best_s[tid];
        int bk = s.best_k[tid];
        float bi = s.best_i[tid];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int i = 2 * tid + m;
          if (better_coarse(s.red_s[i], s.red_k[i], s.red_i[i], bs, bk, bi)) {
            bs = s.red_s[i];
            bk = s.red_k[i];
            bi = s.red_i[i];
          }
        }
        s.best_s[tid] = bs;
        s.best_k[tid] = bk;
        s.best_i[tid] = bi;
      }
    }
  }
  __syncthreads();
  if (tid < count) {  // thread k: macroblock k's raw vector, (0, 0) for none
    const Plan q = s.plan[tid];
    const int bk = s.best_k[tid];
    raw[2 * (first + tid)] = bk != 0x7fffffff ? q.ox - (q.xlo + (bk >> 16)) : 0;
    raw[2 * (first + tid) + 1] = bk != 0x7fffffff ? q.oy - (q.ylo + (bk & 0xffff)) : 0;
  }
}

// Shared words per warp of the refine kernel at refine radius `refine`: the
// patch's four copies, its rows, and its candidates' cost-table entries and
// u8 channels.
__host__ __device__ constexpr int refine_kw(int refine) { return (refine >> 1) + 4; }
__host__ __device__ constexpr int refine_rw(int refine) { return 4 * ((refine_kw(refine) + 4) >> 2); }
// cost entries: SAD one a candidate, SSD one a row and one a column
__host__ __device__ constexpr int refine_costs(int refine) {
  return (2 * refine + 1) * (2 * refine + 1) > 2 * (2 * refine + 1)
             ? (2 * refine + 1) * (2 * refine + 1)
             : 2 * (2 * refine + 1);
}
__host__ __device__ constexpr int refine_words(int refine) {
  return (4 * refine_kw(refine) + refine_rw(refine)) * (kBlock + 2 * refine) +
         refine_costs(refine) + 2 * (2 * refine + 1);
}

// The pyramid's refine stage: warp k of CUDA block b re-scores macroblock
// b * kRefineWarps + k around its coarse vector raw[2 mb], raw[2 mb + 1].
// metric 0 = SAD (cost: cost2 [n_d, n_d], x major), 1 = SSD (cost: axis
// [n_d]); both indexed by t - o - d_lo through the plan's di0, dj0, as the
// exhaustive kernels index them.  Writes the RGBA MV map.  kR: the refine
// radius at compile time (1, 2), or 0 to take `refine_arg`.  Shared memory per
// warp (refine_words): the patch's four copies (copy sh, row r, word k =
// patch bytes [4 k + sh, 4 k + sh + 4)), its rows as words from its first
// column, the costs of its candidates (SAD: by candidate; SSD: by ddy, then
// by ddx) and the u8 channels of their vector components (by ddx, then ddy).
template <int kR>
__global__ void __launch_bounds__(32 * kRefineWarps)
    motion_refine_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ ref, int h,
                         int w, int search, int refine_arg, int metric, int n_mb,
                         const int* __restrict__ plan, const int* __restrict__ raw, int n_d,
                         const float* __restrict__ cost, const uint8_t* __restrict__ mv_u8,
                         uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const int refine = kR > 0 ? kR : refine_arg;
  const int win = kBlock + 2 * refine, n_off = 2 * refine + 1, n_s = n_off * n_off;
  const int kw = refine_kw(refine), rw = refine_rw(refine), quads = rw >> 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mb = blockIdx.x * kRefineWarps + warp;
  if (mb >= n_mb) return;  // the warp's own macroblock only: no block barrier below
  uint32_t* copy = reinterpret_cast<uint32_t*>(smem) + warp * refine_words(refine);
  uint32_t* rows = copy + 4 * kw * win;
  const int n_c = refine_costs(refine);
  float* costs = reinterpret_cast<float*>(rows + rw * win);
  int* chan = reinterpret_cast<int*>(costs + n_c);
  const Plan p = read_plan(plan, mb);
  const int gy0 = min(max(p.oy - raw[2 * mb + 1] - refine, 0), h - win);
  const int gx0 = min(max(p.ox - raw[2 * mb] - refine, 0), w - win);
  // the costs and u8 channels of the patch's candidates, loaded with the
  // patch (indices clamped into the tables: a candidate outside the window
  // is never scored)
  const int max_mv = search / 2;
  for (int i = lane; i < n_c + 2 * n_off; i += 32) {
    if (i < n_c) {
      const int ddx = i / n_off, ddy = i - ddx * n_off;
      const int ix = min(max(gx0 + ddx - p.xlo + p.di0, 0), n_d - 1);
      const int iy = min(max(gy0 + ddy - p.ylo + p.dj0, 0), n_d - 1);
      costs[i] = metric == 0 ? __ldg(cost + ix * n_d + iy)
                             : __ldg(cost + (i < n_off ? iy : min(max(gx0 + i - n_off - p.xlo + p.di0, 0), n_d - 1)));
    } else {
      const int j = i - n_c;  // ddx = j, then ddy = j - n_off
      const int mv = j < n_off ? p.ox - (gx0 + j) : p.oy - (gy0 + j - n_off);
      chan[j] = __ldg(mv_u8 + min(max(mv, -max_mv), max_mv) + max_mv);
    }
  }
  // lane 4 c + q: rows 4 q .. 4 q + 3 of the current block in registers
  const int quarter = lane & 3, slot = lane >> 2;
  const size_t frame = static_cast<size_t>(h) * w;
  const uintptr_t clo = reinterpret_cast<uintptr_t>(cur);
  uint32_t cw[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bytes16(clo + static_cast<size_t>(p.oy + 4 * quarter + i) * w + p.ox, clo & ~uintptr_t(15),
            (clo + frame - 1) & ~uintptr_t(15), cw[i]);
  }
  // the patch's rows from its first column, 16 bytes a lane and round
  const uintptr_t lo = reinterpret_cast<uintptr_t>(ref);
  for (int i = lane; i < win * quads; i += 32) {
    const int r = i / quads, c = i - r * quads;
    uint32_t o[4];
    bytes16(lo + static_cast<size_t>(gy0 + r) * w + gx0 + 16 * c, lo & ~uintptr_t(15),
            (lo + frame - 1) & ~uintptr_t(15), o);
#pragma unroll
    for (int e = 0; e < 4; ++e) rows[r * rw + 4 * c + e] = o[e];
  }
  __syncwarp();
  // copy sh, row r, word c = patch bytes [4 c + sh, 4 c + sh + 4)
  for (int i = lane; i < win * kw; i += 32) {
    const int r = i / kw, c = i - r * kw;
    const uint32_t w0 = rows[r * rw + c], w1 = rows[r * rw + c + 1];
#pragma unroll
    for (int sh = 0; sh < 4; ++sh) copy[(sh * win + r) * kw + c] = __funnelshift_r(w0, w1, 8 * sh);
  }
  __syncwarp();
  float best_s = __int_as_float(0x7f800000);  // +inf
  int best_k = 0x7fffffff;
  for (int s0 = 0; s0 < n_s; s0 += 8) {
    const int k = s0 + slot;  // the candidate, tx-major
    const int ddx = k / n_off, ddy = k - ddx * n_off;
    const int ty = gy0 + ddy, tx = gx0 + ddx;
    const bool ok = k < n_s && ty >= p.ylo && ty < p.ylo + p.n_y && tx >= p.xlo &&
                    tx < p.xlo + p.n_x;
    int part = 0;  // SAD, or sum r^2 - 2 sum c r, over the quarter's rows
    if (ok) {
      const uint32_t* pr = copy + ((ddx & 3) * win + ddy + 4 * quarter) * kw + (ddx >> 2);
      if (metric == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) part = sad4_acc(cw[i][q], pr[i * kw + q], part);
        }
      } else {
        unsigned r2 = 0, cr = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t v = pr[i * kw + q];
            r2 = __dp4a(v, v, r2);
            cr = __dp4a(cw[i][q], v, cr);
          }
        }
        part = static_cast<int>(r2) - 2 * static_cast<int>(cr);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);  // the four quarters of candidate k
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (ok && quarter == 0) {
      const float score =
          metric == 0
              ? __fadd_rn(costs[k], __fmul_rn(static_cast<float>(part), kSadScale))
              : __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(part), 0.0625f), costs[ddy]),
                          costs[n_off + ddx]);
      if (better(score, k, best_s, best_k)) {
        best_s = score;
        best_k = k;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_down_sync(0xffffffffu, best_s, off);
    const int ko = __shfl_down_sync(0xffffffffu, best_k, off);
    if (better(so, ko, best_s, best_k)) {
      best_s = so;
      best_k = ko;
    }
  }
  if (lane != 0) return;
  uint8_t* o = out + 4 * mb;
  if (best_k != 0x7fffffff) {
    const int ddx = best_k / n_off;
    o[0] = static_cast<uint8_t>(chan[ddx]);
    o[2] = static_cast<uint8_t>(chan[n_off + best_k - ddx * n_off]);
  } else {  // no candidate keeps the zero vector
    o[0] = o[2] = mv_u8[max_mv];
  }
  o[1] = 128;
  o[3] = 255;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

// Makes card `device` the calling thread's current device for its scope, and
// then the one that was current again.
struct DeviceScope {
  int device, current;
  explicit DeviceScope(int d) : device(d), current(d) {
    cudaGetDevice(&current);
    if (current != device) cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (current != device) cudaSetDevice(current);
  }
};

}  // namespace

// Full search of cur against ref (h x w u8, row-major, on the device) with 16x16
// blocks and a `search`-pixel window.  plan: [h / 16 * (w / 16), kPlanFields]
// int32 rows of ops/motion.py: plan, one per macroblock in row-major order;
// groups: [n_groups, 2] int32 (first macroblock, count) of ops/motion.py:
// groups, one CUDA block each, kSadGroup (SAD) or kSsdGroup (SSD) macroblocks at
// most.  metric 0 = SAD: cost = cost2 [n_d * n_d]; 1 = SSD: cost = the per-axis
// half [n_d], read as cy then cx.  mv_u8 [search / 2 * 2 + 1] maps a clamped
// vector component to its u8 channel.  out: [h / 16 * (w / 16), 4] u8.  Launches
// on `stream` of card `device` and returns the launch's CUDA error code; the
// calling thread's current device is left as it was.
extern "C" int sv_motion_search(const void* cur, const void* ref, int h, int w, int search,
                                int metric, const void* plan, const void* groups, int n_groups,
                                int n_d, const void* cost, const void* mv_u8, void* out,
                                int device, void* stream) {
  const DeviceScope scope(device);
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
    const cudaError_t e = allow_smem(motion_ssd_kernel<kSsdGroup, false>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    motion_ssd_kernel<kSsdGroup, false><<<n_groups, kThreads, smem, st>>>(
        c, r, h, w, search, pl, gr, co, lut, o, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// The coarse stage of the two-stage search: the SSD kernel's plan, groups
// (kSsdGroup) and per-axis cost table, candidates on the `stride` grid (2:
// motion_coarse_kernel, 1: motion_ssd_kernel's coarse mode), the two-stage
// minimum of motion.py::_me_mxu_program.  raw: [h / 16 * (w / 16), 2] int32
// (mvx, mvy).  Launches on `stream` of card `device` and returns the launch's
// CUDA error code; the calling thread's current device is left as it was.
extern "C" int sv_motion_coarse(const void* cur, const void* ref, int h, int w, int search,
                                int stride, const void* plan, const void* groups, int n_groups,
                                const void* axis, void* raw, int device, void* stream) {
  const DeviceScope scope(device);
  const auto* c = static_cast<const uint8_t*>(cur);
  const auto* r = static_cast<const uint8_t*>(ref);
  const auto* pl = static_cast<const int*>(plan);
  const auto* gr = static_cast<const int*>(groups);
  const auto* ax = static_cast<const float*>(axis);
  auto* out = static_cast<int*>(raw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stride == 2) {
    const int smem = static_cast<int>(sizeof(CoarseShared<kSsdGroup>));
    const cudaError_t e = allow_smem(motion_coarse_kernel<kSsdGroup>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    motion_coarse_kernel<kSsdGroup><<<n_groups, CoarseGeo<kSsdGroup>::kThreads, smem, st>>>(
        c, r, h, w, pl, gr, ax, out);
  } else if (stride == 1) {
    const int smem = static_cast<int>(sizeof(Shared<kSsdGroup, true>));
    const cudaError_t e = allow_smem(motion_ssd_kernel<kSsdGroup, true>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    motion_ssd_kernel<kSsdGroup, true><<<n_groups, kThreads, smem, st>>>(
        c, r, h, w, search, pl, gr, ax, nullptr, nullptr, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The refine stage of the two-stage search over n_mb macroblocks (plan rows of
// ops/motion.py: plan) around raw: [n_mb, 2] int32 coarse vectors.  metric 0 =
// SAD with cost = cost2 [n_d, n_d], 1 = SSD with cost = axis [n_d] (the
// exhaustive kernels' tables, ops/motion.py: tables); mv_u8 [search / 2 * 2 +
// 1] (ops/motion.py: tables).  out: [n_mb, 4] u8.  Launches on `stream` of
// card `device` and returns the launch's CUDA error code; the calling thread's
// current device is left as it was.
extern "C" int sv_motion_refine(const void* cur, const void* ref, int h, int w, int search,
                                int refine, int metric, const void* plan, int n_mb,
                                const void* raw, int n_d, const void* cost, const void* mv_u8,
                                void* out, int device, void* stream) {
  const DeviceScope scope(device);
  const int win = kBlock + 2 * refine;
  if (refine < 0 || h < win || w < win) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(uint32_t)) * kRefineWarps * refine_words(refine);
  const auto kernel = refine == 1 ? motion_refine_kernel<1>
                      : refine == 2 ? motion_refine_kernel<2>
                                    : motion_refine_kernel<0>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (n_mb + kRefineWarps - 1) / kRefineWarps;
  kernel<<<blocks, 32 * kRefineWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref), h, w, search, refine,
      metric, n_mb, static_cast<const int*>(plan), static_cast<const int*>(raw), n_d,
      static_cast<const float*>(cost), static_cast<const uint8_t*>(mv_u8),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The geometry that ops/motion.py mirrors (its GEOMETRY, in this order): writes
// up to n values to out and returns how many there are.
extern "C" int sv_motion_geometry(int* out, int n) {
  const int geometry[] = {kBlock,  kChunk,      kThreads,  kSadRun,  kYHalf,
                          kKSteps, kPlanFields, kSadGroup, kSsdGroup, kGridChunk,
                          kCurWords};
  const int count = static_cast<int>(sizeof(geometry) / sizeof(geometry[0]));
  for (int i = 0; i < count && i < n; ++i) out[i] = geometry[i];
  return count;
}
