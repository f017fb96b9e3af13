// Whole-frame z-ordered composite onto a planar yuv (4:2:0, 4:2:2, 4:4:4), nv12 /
// nv21 or an RGBA / BGRA target, for Hopper (sm_90a).
//
// Replaces the JAX package's three TPU frame kernels:
//   swiftvideo_tpu/ops/pallas_frame.py::_frame_kernel         (planar-yuv / nv12 / nv21 sources)
//   swiftvideo_tpu/ops/pallas_frame.py::_frame_kernel_rgba    (RGBA / BGRA overlays)
//   swiftvideo_tpu/ops/pallas_frame.py::_frame_kernel_rgbaout (RGBA / BGRA targets)
// and computes what they compute: golden.composite_stack (swiftvideo_tpu/ops/golden.py)
// for y420p, y422p, y444p, nv12, nv21, RGBA and BGRA targets (the TPU kernels take
// y420p, nv12 and nv21 of the yuv ones).  frame_composite_kernel writes the yuv targets
// (K1 + K2), frame_composite_rgba_kernel the RGBA / BGRA ones (K3).  A yuv target's
// chroma grid comes with the launch (FrameParams ch, cw): golden's masks and sampling
// are defined on each plane's own grid, so only the tiles and the stores know it.
//
// Bound: device memory.  A 4-camera 1080p tick with a 1080p-wide overlay reads
// 4 x 3.11 MB of camera planes and 1.66 MB of RGBA and writes 3.11 MB of y420p
// (~17 MB, 5.1 us at 3.35 TB/s), or 8.29 MB of RGBA (6.7 us).  Golden's arithmetic is
// ~50 float and integer instructions per pixel and channel, so in practice the
// instruction count and the latency of each block's serial steps decide the time.
// This form cuts both:
//
// * Launch.  The per-source table (SrcDesc, 192 bytes each) travels by value in the
//   kernel's parameters: one FrameParams of up to kCapacity (32) sources, 6208 bytes,
//   passed as a __grid_constant__ (CUDA 12.1 and later take up to 32764 bytes of
//   parameters).  The host neither pins nor copies a table per call, and every
//   thread reads the uniforms through the constant cache.  A longer stack runs as
//   consecutive launches, each after the first chained onto what the previous one
//   wrote (ops/frame.py launch_plan).
// * Tiles and runs.  A tile is 64 x 16 output pixels of one grid (a yuv target's luma
//   tiles come first, then its chroma tiles).  A block of 256 threads gives each
//   thread a run of 4 adjacent pixels of one tile row (4 luma bytes, 4 chroma pairs
//   or 4 RGBA pixels), loaded in chained mode and stored as one 32-, 64- or 128-bit
//   word where the run is whole and aligned, else word by word (one uchar4 per RGBA
//   pixel) or byte by byte at a ragged edge.
// * Persistent blocks.  The launch holds as many blocks as fit on the card at once;
//   each walks the tiles t = blockIdx.x, + gridDim.x, ...  A block fills its
//   256-entry u8 -> float table once (golden's true division by 255, so the table
//   holds the very values the division gives), then plans each tile: the pixel
//   positions, and which sources can touch it.
// * Culling.  A plan intersects each source's host-computed border box with the
//   tile; a source that misses the tile costs nothing more.
// * Taps gather from global memory through L1.  A 2:1 camera reads each texel about
//   once; the re-reads of a 1:1 overlay or an upscale hit L1, which on this card is
//   the same SRAM as shared memory.  Copying each tile's footprint into shared
//   memory with cp.async first measured slower on every case, the 2x upscale
//   included (PERF.md), and is not done.
// * Fewer instructions per pixel.  For an axis-aligned source the row side of the
//   maps (border, element and texture y, the row taps and their offsets) is the same
//   along a run and is computed once per run.  An RGBA texel is one 32-bit load and
//   an nv12 / nv21 pair one 16-bit load.
// * TMA is not used: the planes are new allocations every tick, so a tensor map
//   would have to be encoded on the host for every plane of every call, which is the
//   host cost this form removes.
//
// Numerics follow golden operation for operation, and this file is compiled with
// --fmad=false so no multiply-add pair is contracted into an FMA: the mask tests at
// element seams then land on the same side as golden's, and the kernels agree with
// the plain version (ops/composite.py) bit for bit rather than within 1 LSB.  The
// pixel-grid positions are true divisions (__fdiv_rn) and the quantize is rintf.  A
// product that is the same along a row (u[13] * py) is taken once per run: it is the
// same value.  The row side of an axis-aligned map is computed once per run: the
// terms that would differ between pixels are products with an exact zero, so every
// pixel would compute the same value (at most a zero of the other sign, which no
// test or tap can tell apart).  No sum is reassociated.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kCapacity = 32;  // sources per launch; ops/frame.py CAPACITY
constexpr int kRun = 4;        // adjacent output pixels per thread
constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
constexpr int kThreads = kBlockX * kBlockY;  // one run each
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = kBlockX * kRun;  // output pixels per tile row
constexpr int kTileH = kBlockY;         // output rows per tile
static_assert(kThreads == 256, "the table is filled one entry per thread");
static_assert(kCapacity <= 32, "a tile's active sources are one 32-bit mask");

enum SrcFmt : int { kPlanar = 0, kNv12 = 1, kNv21 = 2, kRgba = 3, kBgra = 4 };
enum OutFmt : int { kOutPlanar = 0, kOutNv12 = 1, kOutNv21 = 2, kOutRgba = 3, kOutBgra = 4 };
// the grid a tile lies on: a yuv target's luma or chroma grid, or an RGBA target
enum Grid : int { kLuma = 0, kChroma = 1, kRgbaGrid = 2 };

// One source of the frame.  Layout shared with ops/frame.py (_DESC).
struct SrcDesc {
  unsigned long long plane[3];  // device pointers of the source planes (0 = unused)
  int fmt;                      // SrcFmt
  int dims[4];                  // plane 0 (h, w), chroma plane (h, w)
  int box[2][4];                // per grid (luma, chroma): y0, y1, x0, x1, half-open
  float u[29];                  // ImageUniforms.pack()
};
static_assert(sizeof(SrcDesc) == 192, "SrcDesc layout is shared with ops/frame.py");

// One launch.  Layout shared with ops/frame.py (_PARAMS).
struct FrameParams {
  unsigned long long out[3];  // target planes, as sv_frame_composite describes
  int n;                      // sources in src[0, n), z-sorted
  int h, w;                   // target size
  int out_fmt;                // OutFmt
  int chained;                // 0: start from the cleared frame; 1: from the outputs
  int ch, cw;                 // a yuv target's chroma grid (rows, columns)
  int pad[3];
  SrcDesc src[kCapacity];
};
static_assert(sizeof(FrameParams) == 64 + kCapacity * 192,
              "FrameParams layout is shared with ops/frame.py");

// ops/color.py RGB2YUV, rounded from double to float as numpy rounds it.
__constant__ float kRgb2Yuv[3][4] = {
    {static_cast<float>(0.299), static_cast<float>(0.587), static_cast<float>(0.113), 0.0f},
    {static_cast<float>(-0.169), static_cast<float>(-0.331), 0.5f, 0.5f},
    {0.5f, static_cast<float>(-0.419), static_cast<float>(-0.081), 0.5f}};

// One row of the csc on a homogeneous [r, g, b, 1], in golden's operation order.
__device__ __forceinline__ float csc(int row, float r, float g, float b) {
  const float* m = kRgb2Yuv[row];
  return m[0] * r + m[1] * g + m[2] * b + m[3];
}

// ops/color.py YUV2RGB (the inverse of RGB2YUV in float64, rounded to float32),
// as exact hex literals; tests/test_torch_convert.py holds them to the table.
__constant__ float kYuv2Rgb[3][4] = {
    {0x1.00419ap+0f, 0x1.bc2cfcp-11f, 0x1.66d502p+0f, -0x1.670c88p-1f},
    {0x1.00419ap+0f, -0x1.5e20a8p-2f, -0x1.6da76ep-1f, 0x1.0e5be2p-1f},
    {0x1.00419ap+0f, 0x1.c62090p+0f, 0x1.03d81ap-10f, -0x1.c66186p-1f}};

__device__ __forceinline__ int quant(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(v * 255.0f), 0.0f), 255.0f));
}

__device__ __forceinline__ bool in01(float v) { return v >= 0.0f && v <= 1.0f; }

// golden._grid_ndc: i / n * 2 - 1
__device__ __forceinline__ float ndc(int i, int n) {
  return __fdiv_rn(static_cast<float>(i), static_cast<float>(n)) * 2.0f - 1.0f;
}

// golden.bilinear_norm's taps along one axis: clamp-to-edge, texel corners at
// t * n - 0.5; i0 and i1 are the texel indices, f the weight of i1.
struct AxisTaps {
  int i0, i1;
  float f;
};

__device__ __forceinline__ AxisTaps axis_taps(float t, int n) {
  const float v = t * static_cast<float>(n) - 0.5f;
  const float vf = floorf(v);
  AxisTaps a;
  a.f = v - vf;
  a.i0 = static_cast<int>(fminf(fmaxf(vf, 0.0f), static_cast<float>(n - 1)));
  a.i1 = static_cast<int>(fminf(fmaxf(vf + 1.0f, 0.0f), static_cast<float>(n - 1)));
  return a;
}

// x lerp first, then y (golden.bilinear_norm)
__device__ __forceinline__ float lerp2(float p00, float p01, float p10, float p11, float fx,
                                       float fy) {
  const float top = p00 * (1.0f - fx) + p01 * fx;
  const float bot = p10 * (1.0f - fx) + p11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

// The planes a source is sampled from on one grid, in a fixed order: the index in
// SrcDesc::plane, the dims pair that sizes it (0: plane 0, 1: chroma) and its bytes
// per texel.  Always indexed with constants.
struct Sampled {
  int n;
  int plane[3], dsel[3], cs[3];
};

__device__ __forceinline__ Sampled sampled_planes(int fmt, int grid) {
  Sampled s = {1, {0, 0, 0}, {0, 0, 0}, {1, 1, 1}};
  if (fmt >= kRgba) {
    s.cs[0] = 4;  // the interleaved plane, on every grid
  } else if (grid == kChroma) {
    s.plane[0] = 1;
    s.dsel[0] = 1;
    if (fmt == kPlanar) {
      s.n = 2;
      s.plane[1] = 2;
      s.dsel[1] = 1;
    } else {
      s.cs[0] = 2;
    }
  } else if (grid == kRgbaGrid) {
    // luma, then the chroma plane(s)
    s.plane[1] = 1;
    s.dsel[1] = 1;
    if (fmt == kPlanar) {
      s.n = 3;
      s.plane[2] = 2;
      s.dsel[2] = 1;
    } else {
      s.n = 2;
      s.cs[1] = 2;
    }
  }
  return s;
}

// A tile of the launch.
struct Tile {
  int grid, gx0, gy0, gh, gw;
};

// A tile's plan: its pixel positions, and per planning warp, bit s set if source s
// can touch the tile (mask) and if it is axis-aligned (sep).
struct Plan {
  unsigned mask[kWarps];
  unsigned sep[kWarps];
  float px[kTileW];
  float py[kTileH];
};

__device__ __forceinline__ int tiles_of(int gh, int gw) {
  return ((gw + kTileW - 1) / kTileW) * ((gh + kTileH - 1) / kTileH);
}

__device__ __forceinline__ int tile_count(const FrameParams& p, bool rgba) {
  return rgba ? tiles_of(p.h, p.w) : tiles_of(p.h, p.w) + tiles_of(p.ch, p.cw);
}

// Tile t: a yuv target's luma tiles, then its chroma tiles; an RGBA target's tiles.
__device__ __forceinline__ Tile tile_at(const FrameParams& p, bool rgba, int t) {
  Tile g;
  g.grid = rgba ? kRgbaGrid : kLuma;
  g.gh = p.h;
  g.gw = p.w;
  int across = (g.gw + kTileW - 1) / kTileW;
  if (!rgba) {
    const int luma = across * ((g.gh + kTileH - 1) / kTileH);
    if (t >= luma) {
      t -= luma;
      g.grid = kChroma;
      g.gh = p.ch;
      g.gw = p.cw;
      across = (g.gw + kTileW - 1) / kTileW;
    }
  }
  g.gx0 = (t % across) * kTileW;
  g.gy0 = (t / across) * kTileH;
  return g;
}

// Whether source d's border box meets tile g.
__device__ __forceinline__ bool touches(const SrcDesc& d, const Tile& g) {
  const int* box = d.box[g.grid == kChroma ? 1 : 0];
  return max(g.gx0, box[2]) < min(min(g.gx0 + kTileW, g.gw), box[3]) &&
         max(g.gy0, box[0]) < min(min(g.gy0 + kTileH, g.gh), box[1]);
}

// Whether source d's maps are axis-aligned (no rotation in the element, texture or
// border map) and finite (no overflow on the way to the taps); & keeps the loads
// independent of each other.
__device__ __forceinline__ bool axis_aligned(const SrcDesc& d) {
  const float* u = d.u;
  bool sep = (u[1] == 0.0f) & (u[2] == 0.0f) & (u[7] == 0.0f) & (u[8] == 0.0f) &
             (u[13] == 0.0f) & (u[14] == 0.0f);
#pragma unroll
  for (int i = 0; i < 18; ++i) sep &= fabsf(u[i]) < 1e6f;
  return sep;
}

// Plans tile g into pl: every thread takes part, one warp per source.
__device__ __forceinline__ void plan_tile(const FrameParams& p, const Tile& g, Plan& pl) {
  const int tid = threadIdx.x;
  if (tid < kTileW) {
    pl.px[tid] = ndc(g.gx0 + tid, g.gw);
  } else if (tid < kTileW + kTileH) {
    pl.py[tid - kTileW] = ndc(g.gy0 + tid - kTileW, g.gh);
  }
  const int n = min(p.n, kCapacity);
  unsigned mask = 0u, sep = 0u;
  for (int s = tid >> 5; s < n; s += kWarps) {
    if (touches(p.src[s], g)) {
      mask |= 1u << s;
      if (axis_aligned(p.src[s])) sep |= 1u << s;
    }
  }
  if ((tid & 31) == 0) {
    pl.mask[tid >> 5] = mask;
    pl.sep[tid >> 5] = sep;
  }
}

__device__ __forceinline__ unsigned merged(const unsigned (&m)[kWarps]) {
  unsigned r = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r |= m[w];
  return r;
}

// A sampled plane of a source in global memory.
struct PlaneRef {
  const uint8_t* p;
  int stride;  // bytes per plane row
  bool words;  // texels of 2 or 4 bytes may be read as one word
};

__device__ __forceinline__ PlaneRef plane_ref(const SrcDesc& d, const Sampled& sp, int k) {
  PlaneRef r;
  r.stride = d.dims[2 * sp.dsel[k] + 1] * sp.cs[k];
  r.p = reinterpret_cast<const uint8_t*>(d.plane[sp.plane[k]]);
  r.words = (reinterpret_cast<uintptr_t>(r.p) & (sp.cs[k] - 1)) == 0;
  return r;
}

// The two tap rows of a plane: their offsets and the weight of the second.
struct RowTaps {
  int r0, r1;
  float fy;
};

__device__ __forceinline__ RowTaps row_taps(const PlaneRef& r, float v, int h) {
  const AxisTaps a = axis_taps(v, h);
  RowTaps t;
  t.r0 = a.i0 * r.stride;
  t.r1 = a.i1 * r.stride;
  t.fy = a.f;
  return t;
}

// The tap rows of up to three sampled planes (a, b, c) of one source.
struct Rows {
  RowTaps a, b, c;
};

__device__ __forceinline__ Rows rows_of(int n, const PlaneRef& ra, int ha, const PlaneRef& rb,
                                        const PlaneRef& rc, int hbc, float v) {
  Rows r = {};
  r.a = row_taps(ra, v, ha);
  if (n > 1) r.b = row_taps(rb, v, hbc);
  if (n > 2) r.c = row_taps(rc, v, hbc);
  return r;
}

// A texel of kCs bytes (2 or 4) as one little-endian word.
template <int kCs>
__device__ __forceinline__ uint32_t texel(const uint8_t* p, bool words) {
  if (words) {
    if (kCs == 4) return *reinterpret_cast<const uint32_t*>(p);
    return *reinterpret_cast<const uint16_t*>(p);
  }
  uint32_t v = 0;
#pragma unroll
  for (int q = 0; q < kCs; ++q) v |= static_cast<uint32_t>(p[q]) << (8 * q);
  return v;
}

// The two tap columns of a plane: their byte offsets in a row and the weight of the
// second.
struct ColTap {
  int c0, c1;
  float fx;
};

__device__ __forceinline__ ColTap col_tap(float v, int w, int cs) {
  const AxisTaps a = axis_taps(v, w);
  return ColTap{a.i0 * cs, a.i1 * cs, a.f};
}

// The single channel of a 1-byte plane at rows rt, columns ct.
__device__ __forceinline__ float sample1(const PlaneRef& r, const RowTaps& rt, const ColTap& ct,
                                         const float* lut) {
  return lerp2(lut[r.p[rt.r0 + ct.c0]], lut[r.p[rt.r0 + ct.c1]], lut[r.p[rt.r1 + ct.c0]],
               lut[r.p[rt.r1 + ct.c1]], ct.fx, rt.fy);
}

// Every channel of a kCs-byte plane (memory order) at rows rt, columns ct.
template <int kCs>
__device__ __forceinline__ void sample_n(const PlaneRef& r, const RowTaps& rt, const ColTap& ct,
                                         const float* lut, float (&out)[kCs]) {
  const uint32_t t00 = texel<kCs>(r.p + rt.r0 + ct.c0, r.words);
  const uint32_t t01 = texel<kCs>(r.p + rt.r0 + ct.c1, r.words);
  const uint32_t t10 = texel<kCs>(r.p + rt.r1 + ct.c0, r.words);
  const uint32_t t11 = texel<kCs>(r.p + rt.r1 + ct.c1, r.words);
#pragma unroll
  for (int c = 0; c < kCs; ++c) {
    out[c] = lerp2(lut[(t00 >> (8 * c)) & 255], lut[(t01 >> (8 * c)) & 255],
                   lut[(t10 >> (8 * c)) & 255], lut[(t11 >> (8 * c)) & 255], ct.fx, rt.fy);
  }
}

// The per-run state of a source's maps.  For an axis-aligned source (kSep) the row
// side is filled once per run by run_rows; otherwise by pixel_maps at each pixel.
struct Maps {
  float tx_x, tx_y, uv_x, uv_y;
  bool tx_in_y, uv_in_y;
  float u7ty;  // u[7] * tx_y
};

template <bool kSep>
__device__ __forceinline__ bool run_rows(const float* u, float px0, float u1py, float u3py,
                                         float u15py, Maps& m) {
  if (!kSep) return true;
  const float bd_y = u[14] * px0 + u15py + u[17];
  const float tx_x0 = u[0] * px0 + u1py + u[4];
  m.tx_y = u[2] * px0 + u3py + u[5];
  m.uv_y = u[8] * tx_x0 + u[9] * m.tx_y + u[11];
  m.tx_in_y = in01(m.tx_y);
  m.uv_in_y = in01(m.uv_y);
  m.u7ty = u[7] * m.tx_y;
  return in01(bd_y);  // no pixel of the run is inside the border otherwise
}

// At pixel x: false if it lies outside the box or the border (no write); else the
// element and texture maps, with m_tx / m_uv their masks.
template <bool kSep>
__device__ __forceinline__ bool pixel_maps(const float* u, const int* box, int x, float px,
                                           float u1py, float u3py, float u13py, float u15py,
                                           Maps& m, bool& m_tx, bool& m_uv) {
  if (x < box[2] || x >= box[3]) return false;
  const float bd_x = u[12] * px + u13py + u[16];
  if (kSep) {
    if (!in01(bd_x)) return false;
    m.tx_x = u[0] * px + u1py + u[4];
    m.uv_x = u[6] * m.tx_x + m.u7ty + u[10];
    m_tx = in01(m.tx_x) && m.tx_in_y;
    m_uv = in01(m.uv_x) && m.uv_in_y;
    return true;
  }
  const float bd_y = u[14] * px + u15py + u[17];
  if (!(in01(bd_x) && in01(bd_y))) return false;
  m.tx_x = u[0] * px + u1py + u[4];
  m.tx_y = u[2] * px + u3py + u[5];
  m.uv_x = u[6] * m.tx_x + u[7] * m.tx_y + u[10];
  m.uv_y = u[8] * m.tx_x + u[9] * m.tx_y + u[11];
  m_tx = in01(m.tx_x) && in01(m.tx_y);
  m_uv = in01(m.uv_x) && in01(m.uv_y);
  return true;
}

// One source over a run of a yuv target's grid: acc[j] = luma, or (cb, cr) on the
// chroma grid, as u8 values.  x is the run's first pixel, nv its pixels in the grid.
template <bool kSep>
__device__ __forceinline__ void fold_yuv(const SrcDesc& d, int chroma, const float* lut,
                                         const float (&px)[kRun], float py, int x, int nv,
                                         int (&acc)[kRun][2]) {
  const int* box = d.box[chroma];
  const float* u = d.u;
  const float u1py = u[1] * py;
  const float u3py = u[3] * py;
  const float u13py = u[13] * py;
  const float u15py = u[15] * py;
  const float op = u[22];
  const float a_fill = op * u[21];
  const int nch = chroma ? 2 : 1;
  const bool yuv = d.fmt < kRgba;
  // the sampled planes' size on this grid: the chroma planes for a yuv source on
  // the chroma grid, else plane 0
  const int th = yuv && chroma ? d.dims[2] : d.dims[0];
  const int tw = yuv && chroma ? d.dims[3] : d.dims[1];
  const Sampled sp = sampled_planes(d.fmt, chroma ? kChroma : kLuma);
  const PlaneRef ra = plane_ref(d, sp, 0);
  const PlaneRef rb = plane_ref(d, sp, 1);  // planar cr
  Maps m;
  if (!run_rows<kSep>(u, px[0], u1py, u3py, u15py, m)) return;
  Rows rw = {};
  if (kSep) rw = rows_of(sp.n, ra, th, rb, rb, th, m.uv_y);
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (j >= nv) continue;
    bool m_tx, m_uv;
    if (!pixel_maps<kSep>(u, box, x + j, px[j], u1py, u3py, u13py, u15py, m, m_tx, m_uv)) continue;

    if (yuv) {
      // family A: yuv source (kernels.cl.swift:186-255)
      if (m_tx && m_uv) {
        if (!kSep) rw = rows_of(sp.n, ra, th, rb, rb, th, m.uv_y);
        const ColTap cx = col_tap(m.uv_x, tw, sp.cs[0]);
        float smp[2] = {0.0f, 0.0f};
        if (!chroma) {
          smp[0] = sample1(ra, rw.a, cx, lut);
        } else if (d.fmt == kPlanar) {
          smp[0] = sample1(ra, rw.a, cx, lut);
          smp[1] = sample1(rb, rw.b, cx, lut);
        } else {
          float pair[2];
          sample_n<2>(ra, rw.a, cx, lut, pair);
          const bool nv21 = d.fmt == kNv21;
          smp[0] = nv21 ? pair[1] : pair[0];
          smp[1] = nv21 ? pair[0] : pair[1];
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (k == nch) break;
          const float cur = lut[acc[j][k]];
          acc[j][k] = quant(cur * (1.0f - op) + smp[k] * op);
        }
      } else {
        const float lo = chroma ? -1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (k == nch) break;
          const float fill = csc(chroma + k, u[18], u[19], u[20]);
          const float cur = lut[acc[j][k]];
          const float filled = cur * (1.0f - a_fill) + fill * a_fill;
          acc[j][k] = quant(fminf(fmaxf(filled, lo), 1.0f));
        }
      }
      continue;
    }

    // family B: RGBA / BGRA source (kernels.cl.swift:267-532); write mask = border & element
    if (!m_tx) continue;
    float r = 0.0f, gr = 0.0f, b = 0.0f, a_s = 0.0f;
    if (m_uv) {
      if (!kSep) rw = rows_of(sp.n, ra, th, rb, rb, th, m.uv_y);
      float c4[4];
      sample_n<4>(ra, rw.a, col_tap(m.uv_x, tw, 4), lut, c4);
      const bool bgra = d.fmt == kBgra;
      a_s = c4[3] * op;
      r = (bgra ? c4[2] : c4[0]) * a_s;
      gr = c4[1] * a_s;
      b = (bgra ? c4[0] : c4[2]) * a_s;
    }
    const float fr = u[18] * a_fill;
    const float fg = u[19] * a_fill;
    const float fb = u[20] * a_fill;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == nch) break;
      const int row = chroma + k;
      const float cur = lut[acc[j][k]];
      float res = cur * (1.0f - a_fill) + csc(row, fr, fg, fb) * a_fill;
      if (chroma) res = fminf(fmaxf(res, -1.0f), 1.0f);
      if (m_uv) res = res * (1.0f - a_s) + csc(row, r, gr, b) * a_s;
      acc[j][k] = quant(res);
    }
  }
}

// One source over a run of an RGBA / BGRA target: golden._composite_rgba_out (the
// blit blend).  acc[j] in r, g, b, a order, as u8 values.
template <bool kSep>
__device__ __forceinline__ void fold_rgba(const SrcDesc& d, const float* lut,
                                          const float (&px)[kRun], float py, int x, int nv,
                                          int (&acc)[kRun][4]) {
  const int* box = d.box[0];
  const float* u = d.u;
  const float u1py = u[1] * py;
  const float u3py = u[3] * py;
  const float u13py = u[13] * py;
  const float u15py = u[15] * py;
  const float op = u[22];
  const bool yuv = d.fmt < kRgba;
  const Sampled sp = sampled_planes(d.fmt, kRgbaGrid);
  const PlaneRef ra = plane_ref(d, sp, 0);  // RGBA, or luma
  const PlaneRef rb = plane_ref(d, sp, 1);  // chroma: cb, or the pairs
  const PlaneRef rc = plane_ref(d, sp, 2);  // planar cr
  Maps m;
  if (!run_rows<kSep>(u, px[0], u1py, u3py, u15py, m)) return;
  Rows rw = {};
  if (kSep) rw = rows_of(sp.n, ra, d.dims[0], rb, rc, d.dims[2], m.uv_y);
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (j >= nv) continue;
    bool m_tx, m_uv;
    if (!pixel_maps<kSep>(u, box, x + j, px[j], u1py, u3py, u13py, u15py, m, m_tx, m_uv)) continue;

    if (m_tx && m_uv) {
      if (!kSep) rw = rows_of(sp.n, ra, d.dims[0], rb, rc, d.dims[2], m.uv_y);
      float nw[4];
      float alpha;
      if (!yuv) {
        float c4[4];
        sample_n<4>(ra, rw.a, col_tap(m.uv_x, d.dims[1], 4), lut, c4);
        const bool bgra = d.fmt == kBgra;
        nw[0] = bgra ? c4[2] : c4[0];
        nw[1] = c4[1];
        nw[2] = bgra ? c4[0] : c4[2];
        alpha = c4[3] * op;
      } else {
        const float yv = sample1(ra, rw.a, col_tap(m.uv_x, d.dims[1], 1), lut);
        const ColTap cx = col_tap(m.uv_x, d.dims[3], sp.cs[1]);
        float cb, cr;
        if (d.fmt == kPlanar) {
          cb = sample1(rb, rw.b, cx, lut);
          cr = sample1(rc, rw.c, cx, lut);
        } else {
          float pair[2];
          sample_n<2>(rb, rw.b, cx, lut, pair);
          const bool nv21 = d.fmt == kNv21;
          cb = nv21 ? pair[1] : pair[0];
          cr = nv21 ? pair[0] : pair[1];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float* mm = kYuv2Rgb[k];
          nw[k] = mm[0] * yv + mm[1] * cb + mm[2] * cr + mm[3];
        }
        alpha = op;
      }
      nw[3] = 1.0f;
      const float keep = 1.0f - alpha;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = quant(lut[acc[j][k]] * keep + nw[k] * alpha);
    } else {
      // border only: the fill colour, alpha channel 1
      const float a_fill = op * u[21];
      const float keep = 1.0f - a_fill;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float fill = k < 3 ? u[18 + k] : 1.0f;
        const float filled = lut[acc[j][k]] * keep + fill * a_fill;
        acc[j][k] = quant(fminf(fmaxf(filled, 0.0f), 1.0f));
      }
    }
  }
}

// N bytes of a thread's run, little-endian in 32-bit words.
template <int N>
struct Run {
  uint32_t w[N / 4];
  __device__ __forceinline__ int get(int i) const { return (w[i >> 2] >> (8 * (i & 3))) & 255; }
  __device__ __forceinline__ void set(int i, int v) {
    w[i >> 2] = (w[i >> 2] & ~(255u << (8 * (i & 3)))) | (static_cast<uint32_t>(v) << (8 * (i & 3)));
  }
};

// Loads the first n of N bytes at p: one N-byte word where the run is whole and
// aligned, else 32-bit words where aligned and bytes for the rest.
template <int N>
__device__ __forceinline__ Run<N> load_run(const uint8_t* p, int n) {
  Run<N> r;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n == N && a % N == 0) {
    if constexpr (N == 4) {
      r.w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (N == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      r.w[0] = v.x;
      r.w[1] = v.y;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      r.w[0] = v.x;
      r.w[1] = v.y;
      r.w[2] = v.z;
      r.w[3] = v.w;
    }
    return r;
  }
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    if (4 * i + 4 <= n && a % 4 == 0) {
      r.w[i] = *reinterpret_cast<const uint32_t*>(p + 4 * i);
    } else {
      r.w[i] = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * i + q < n) r.w[i] |= static_cast<uint32_t>(p[4 * i + q]) << (8 * q);
    }
  }
  return r;
}

// Stores the first n of N bytes at p, with load_run's widths.
template <int N>
__device__ __forceinline__ void store_run(uint8_t* p, int n, const Run<N>& r) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n == N && a % N == 0) {
    if constexpr (N == 4) {
      *reinterpret_cast<uint32_t*>(p) = r.w[0];
    } else if constexpr (N == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    if (4 * i + 4 <= n && a % 4 == 0) {
      *reinterpret_cast<uint32_t*>(p + 4 * i) = r.w[i];
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * i + q < n) p[4 * i + q] = static_cast<uint8_t>(r.w[i] >> (8 * q));
    }
  }
}

// A thread's run on a yuv target: acc[j][0] = luma, or (cb, cr) on the chroma grid.
struct YuvRun {
  static constexpr int kCh = 2;
  __device__ __forceinline__ static void clear(int grid, int (&acc)[kRun][kCh]) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) acc[j][0] = acc[j][1] = grid == kChroma ? 128 : 0;
  }
  __device__ __forceinline__ static void load(const FrameParams& p, const Tile& g, int pix, int nv,
                                              int (&acc)[kRun][kCh]) {
    const int cb_at = p.out_fmt == kOutNv21 ? 1 : 0;  // nv12 (cb, cr), nv21 (cr, cb)
    const uint8_t* out0 = reinterpret_cast<const uint8_t*>(p.out[0]);
    const uint8_t* out1 = reinterpret_cast<const uint8_t*>(p.out[1]);
    const uint8_t* out2 = reinterpret_cast<const uint8_t*>(p.out[2]);
    if (g.grid == kLuma) {
      const Run<4> v = load_run<4>(out0 + pix, nv);
#pragma unroll
      for (int j = 0; j < kRun; ++j) acc[j][0] = v.get(j);
    } else if (p.out_fmt == kOutPlanar) {
      const Run<4> cb = load_run<4>(out1 + pix, nv);
      const Run<4> cr = load_run<4>(out2 + pix, nv);
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        acc[j][0] = cb.get(j);
        acc[j][1] = cr.get(j);
      }
    } else {
      const Run<8> v = load_run<8>(out1 + 2 * pix, 2 * nv);
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        acc[j][0] = v.get(2 * j + cb_at);
        acc[j][1] = v.get(2 * j + 1 - cb_at);
      }
    }
  }
  __device__ __forceinline__ static void store(const FrameParams& p, const Tile& g, int pix, int nv,
                                               const int (&acc)[kRun][kCh]) {
    const int cb_at = p.out_fmt == kOutNv21 ? 1 : 0;
    uint8_t* out0 = reinterpret_cast<uint8_t*>(p.out[0]);
    uint8_t* out1 = reinterpret_cast<uint8_t*>(p.out[1]);
    uint8_t* out2 = reinterpret_cast<uint8_t*>(p.out[2]);
    if (g.grid == kLuma) {
      Run<4> v;
      v.w[0] = 0u;
#pragma unroll
      for (int j = 0; j < kRun; ++j) v.set(j, acc[j][0]);
      store_run<4>(out0 + pix, nv, v);
    } else if (p.out_fmt == kOutPlanar) {
      Run<4> cb, cr;
      cb.w[0] = cr.w[0] = 0u;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        cb.set(j, acc[j][0]);
        cr.set(j, acc[j][1]);
      }
      store_run<4>(out1 + pix, nv, cb);
      store_run<4>(out2 + pix, nv, cr);
    } else {
      Run<8> v;
      v.w[0] = v.w[1] = 0u;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        v.set(2 * j + cb_at, acc[j][0]);
        v.set(2 * j + 1 - cb_at, acc[j][1]);
      }
      store_run<8>(out1 + 2 * pix, 2 * nv, v);
    }
  }
  template <bool kSep>
  __device__ __forceinline__ static void fold(const SrcDesc& d, const Tile& g, const float* lut,
                                              const float (&px)[kRun], float py, int x, int nv,
                                              int (&acc)[kRun][kCh]) {
    fold_yuv<kSep>(d, g.grid == kChroma, lut, px, py, x, nv, acc);
  }
};

// A thread's run on an RGBA / BGRA target: acc[j] in r, g, b, a order.
struct RgbaRun {
  static constexpr int kCh = 4;
  __device__ __forceinline__ static void clear(int, int (&acc)[kRun][kCh]) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = 0;
      acc[j][3] = 255;  // a cleared target is (0, 0, 0, 255)
    }
  }
  __device__ __forceinline__ static void load(const FrameParams& p, const Tile&, int pix, int nv,
                                              int (&acc)[kRun][kCh]) {
    const int r_at = p.out_fmt == kOutBgra ? 2 : 0;  // memory channel of red
    const Run<16> v = load_run<16>(reinterpret_cast<const uint8_t*>(p.out[0]) + 4 * pix, 4 * nv);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      acc[j][0] = v.get(4 * j + r_at);
      acc[j][1] = v.get(4 * j + 1);
      acc[j][2] = v.get(4 * j + 2 - r_at);
      acc[j][3] = v.get(4 * j + 3);
    }
  }
  __device__ __forceinline__ static void store(const FrameParams& p, const Tile&, int pix, int nv,
                                               const int (&acc)[kRun][kCh]) {
    const int r_at = p.out_fmt == kOutBgra ? 2 : 0;
    Run<16> v;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      v.w[j] = 0u;
      v.set(4 * j + r_at, acc[j][0]);
      v.set(4 * j + 1, acc[j][1]);
      v.set(4 * j + 2 - r_at, acc[j][2]);
      v.set(4 * j + 3, acc[j][3]);
    }
    store_run<16>(reinterpret_cast<uint8_t*>(p.out[0]) + 4 * pix, 4 * nv, v);
  }
  template <bool kSep>
  __device__ __forceinline__ static void fold(const SrcDesc& d, const Tile&, const float* lut,
                                              const float (&px)[kRun], float py, int x, int nv,
                                              int (&acc)[kRun][kCh]) {
    fold_rgba<kSep>(d, lut, px, py, x, nv, acc);
  }
};

// The body of both kernels: a block walks its tiles, plans each, and folds every
// source that touches it into each thread's run.
template <typename Target>
__device__ __forceinline__ void composite_tiles(const FrameParams& p, bool rgba) {
  __shared__ float lut[256];
  __shared__ Plan pl;
  const int tid = threadIdx.x;
  lut[tid] = __fdiv_rn(static_cast<float>(tid), 255.0f);  // golden.py _to_f

  const int ntiles = tile_count(p, rgba);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile g = tile_at(p, rgba, t);
    plan_tile(p, g, pl);
    __syncthreads();  // the plan (and, the first time, the table) is in
    const int lx = (tid % kBlockX) * kRun;
    const int ty = tid / kBlockX;
    const int x = g.gx0 + lx;
    const int y = g.gy0 + ty;
    const int nv = y < g.gh ? max(0, min(kRun, g.gw - x)) : 0;  // pixels of the run in the grid
    if (nv > 0) {
      const int pix = y * g.gw + x;
      int acc[kRun][Target::kCh];
      Target::clear(g.grid, acc);
      if (p.chained) Target::load(p, g, pix, nv, acc);
      float px[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) px[j] = pl.px[lx + j];
      const float py = pl.py[ty];
      const unsigned sep = merged(pl.sep);
      for (unsigned todo = merged(pl.mask); todo; todo &= todo - 1) {
        const int s = __ffs(static_cast<int>(todo)) - 1;
        const SrcDesc& d = p.src[s];
        const int* box = d.box[g.grid == kChroma ? 1 : 0];
        if (y < box[0] || y >= box[1]) continue;
        if ((sep >> s) & 1u) {
          Target::template fold<true>(d, g, lut, px, py, x, nv, acc);
        } else {
          Target::template fold<false>(d, g, lut, px, py, x, nv, acc);
        }
      }
      Target::store(p, g, pix, nv, acc);
    }
    __syncthreads();  // every thread is done with the plan before the next tile's
  }
}

// yuv targets (K1 + K2)
__global__ void __launch_bounds__(kThreads)
    frame_composite_kernel(const __grid_constant__ FrameParams p) {
  composite_tiles<YuvRun>(p, false);
}

// RGBA / BGRA targets (K3): one grid of [h, w, 4] u8 pixels, written interleaved.
__global__ void __launch_bounds__(kThreads)
    frame_composite_rgba_kernel(const __grid_constant__ FrameParams p) {
  composite_tiles<RgbaRun>(p, true);
}

int host_tiles(int gh, int gw) {
  return ((gw + kTileW - 1) / kTileW) * ((gh + kTileH - 1) / kTileH);
}

// Blocks of `kernel` the current device holds at once, cached per device.
template <typename Kernel>
int resident_blocks(Kernel kernel, int which) {
  static int cache[2][16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) dev = 0;
  if (cache[which][dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cache[which][dev] = max(1, per_sm) * max(1, sms);
  }
  return cache[which][dev];
}

}  // namespace

// One launch: params points to a host FrameParams (ops/frame.py pack_params), copied
// into the launch's parameters.  out_fmt 0: out[0] = Y, out[1] = Cb, out[2] = Cr, the
// chroma planes [ch, cw] (y420p, y422p or y444p); 1 / 2: out[0] = Y, out[1] =
// interleaved nv12 / nv21 chroma [ch, cw, 2]; 3 / 4: out[0] = interleaved [h, w, 4]
// RGBA / BGRA (ch, cw unused).  Launches on `stream` of card `device` as many
// blocks as the card holds at once (at most one per tile) and returns
// cudaGetLastError(); the calling thread's current device is left as it was.
extern "C" int sv_frame_composite(const void* params, int device, void* stream) {
  FrameParams p;
  std::memcpy(&p, params, sizeof p);
  int current = device;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads, 1, 1);
  if (p.out_fmt == kOutRgba || p.out_fmt == kOutBgra) {
    const int tiles = host_tiles(p.h, p.w);
    const int grid = min(tiles, resident_blocks(frame_composite_rgba_kernel, 1));
    frame_composite_rgba_kernel<<<grid, block, 0, st>>>(p);
  } else {
    const int tiles = host_tiles(p.h, p.w) + host_tiles(p.ch, p.cw);
    const int grid = min(tiles, resident_blocks(frame_composite_kernel, 0));
    frame_composite_kernel<<<grid, block, 0, st>>>(p);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (current != device) cudaSetDevice(current);
  return err;
}

// The layout the host packs against: sizeof(FrameParams) and the sources per launch.
extern "C" int sv_frame_params_size() { return static_cast<int>(sizeof(FrameParams)); }
extern "C" int sv_frame_capacity() { return kCapacity; }
