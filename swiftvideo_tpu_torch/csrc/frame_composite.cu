// Whole-frame z-ordered composite onto a yuv 4:2:0 or an RGBA / BGRA target, for
// Hopper (sm_90a).
//
// Replaces the JAX package's three TPU frame kernels:
//   swiftvideo_tpu/ops/pallas_frame.py::_frame_kernel         (planar-yuv / nv12 / nv21 sources)
//   swiftvideo_tpu/ops/pallas_frame.py::_frame_kernel_rgba    (RGBA / BGRA overlays)
//   swiftvideo_tpu/ops/pallas_frame.py::_frame_kernel_rgbaout (RGBA / BGRA targets)
// and computes what they compute: golden.composite_stack (swiftvideo_tpu/ops/golden.py)
// for y420p, nv12, nv21, RGBA and BGRA targets.
//
// One launch per frame.  Each thread owns one output pixel of the luma grid
// (blockIdx.z == 0) or of the half-resolution chroma grid (blockIdx.z == 1, both
// chroma channels), keeps its accumulator in registers, and folds every source
// in z order: normpos -> element / texture / border affines -> masks -> clamped
// bilinear gather -> family A or B blend -> u8 quantize (rint, half to even)
// after every source.  Camera and overlay sources mix freely in one launch; a
// rotated source costs nothing extra because the gather is per pixel.
//
// Bound: device memory.  A 4-camera 1080p tick with a 1080p-wide overlay reads
// 4 x 3.11 MB of camera planes, 1.66 MB of RGBA and writes 3.11 MB (~17 MB).
// This first form reads each source texel once per output pixel that samples it
// (4 taps per channel, served mostly from L1/L2), with no shared-memory staging;
// a per-source pixel box computed on the host lets threads skip sources that
// cannot touch them.
//
// An RGBA / BGRA target (frame_composite_rgba_kernel) is one grid of [h, w, 4] u8
// pixels, written interleaved in place: each thread reads its pixel's four bytes,
// folds every source with golden._composite_rgba_out's blit blend (yuv sources go
// through YUV2RGB) and writes the four bytes back.  It reads what the yuv kernel
// reads and writes 4 bytes a pixel: 8.3 MB for a 1080p canvas.
//
// Numerics follow golden operation for operation, and this file is compiled with
// --fmad=false so no multiply-add pair is contracted into an FMA: the mask tests
// at element seams then land on the same side as golden's, and the kernel agrees
// with the plain version (ops/composite.py) bit for bit rather than within 1 LSB.
// The u8 read is a true division by 255 (golden.py _to_f), not a reciprocal
// multiply.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum SrcFmt : int { kPlanar = 0, kNv12 = 1, kNv21 = 2, kRgba = 3, kBgra = 4 };
enum OutFmt : int { kOutPlanar = 0, kOutNv12 = 1, kOutNv21 = 2, kOutRgba = 3, kOutBgra = 4 };

// One source of the frame.  Layout shared with ops/frame.py (_DESC).
struct SrcDesc {
  unsigned long long plane[3];  // device pointers of the source planes (0 = unused)
  int fmt;                      // SrcFmt
  int dims[4];                  // plane 0 (h, w), chroma plane (h, w)
  int box[2][4];                // per grid (luma, chroma): y0, y1, x0, x1, half-open
  float u[29];                  // ImageUniforms.pack()
};
static_assert(sizeof(SrcDesc) == 192, "SrcDesc layout is shared with ops/frame.py");

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

__device__ __forceinline__ float u8f(unsigned v) { return __fdiv_rn(static_cast<float>(v), 255.0f); }

__device__ __forceinline__ int quant(float v) {
  return static_cast<int>(fminf(fmaxf(rintf(v * 255.0f), 0.0f), 255.0f));
}

__device__ __forceinline__ bool inside(float x, float y) {
  return x >= 0.0f && x <= 1.0f && y >= 0.0f && y <= 1.0f;
}

// golden.bilinear_norm's taps: clamp-to-edge, texel corners at u * w - 0.5.
struct Taps {
  int y0, y1, x0, x1;
  float fx, fy;
};

__device__ __forceinline__ Taps taps(float u, float v, int h, int w) {
  const float x = u * static_cast<float>(w) - 0.5f;
  const float y = v * static_cast<float>(h) - 0.5f;
  const float xf = floorf(x);
  const float yf = floorf(y);
  Taps t;
  t.fx = x - xf;
  t.fy = y - yf;
  t.x0 = static_cast<int>(fminf(fmaxf(xf, 0.0f), static_cast<float>(w - 1)));
  t.x1 = static_cast<int>(fminf(fmaxf(xf + 1.0f, 0.0f), static_cast<float>(w - 1)));
  t.y0 = static_cast<int>(fminf(fmaxf(yf, 0.0f), static_cast<float>(h - 1)));
  t.y1 = static_cast<int>(fminf(fmaxf(yf + 1.0f, 0.0f), static_cast<float>(h - 1)));
  return t;
}

// Channel c of a [h, w, cs] u8 plane, sampled at t (x lerp first, then y).
__device__ __forceinline__ float sample(const uint8_t* __restrict__ p, const Taps& t, int w, int cs,
                                        int c) {
  const float p00 = u8f(p[(t.y0 * w + t.x0) * cs + c]);
  const float p01 = u8f(p[(t.y0 * w + t.x1) * cs + c]);
  const float p10 = u8f(p[(t.y1 * w + t.x0) * cs + c]);
  const float p11 = u8f(p[(t.y1 * w + t.x1) * cs + c]);
  const float top = p00 * (1.0f - t.fx) + p01 * t.fx;
  const float bot = p10 * (1.0f - t.fx) + p11 * t.fx;
  return top * (1.0f - t.fy) + bot * t.fy;
}

__global__ void frame_composite_kernel(const SrcDesc* __restrict__ descs, int n,
                                       uint8_t* __restrict__ out0, uint8_t* __restrict__ out1,
                                       uint8_t* __restrict__ out2, int h, int w, int out_fmt,
                                       int chained) {
  const int chroma = blockIdx.z;
  const int gh = chroma ? h / 2 : h;
  const int gw = chroma ? w / 2 : w;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= gw || y >= gh) return;
  const int pix = y * gw + x;
  // nv12 keeps (cb, cr) per chroma pixel, nv21 (cr, cb)
  const int cb_at = out_fmt == kOutNv21 ? 1 : 0;

  // acc[0] = luma, or (cb, cr) on the chroma grid; u8 values
  int acc[2];
  if (!chroma) {
    acc[0] = chained ? out0[pix] : 0;
    acc[1] = 0;
  } else if (out_fmt == kOutPlanar) {
    acc[0] = chained ? out1[pix] : 128;
    acc[1] = chained ? out2[pix] : 128;
  } else {
    acc[0] = chained ? out1[2 * pix + cb_at] : 128;
    acc[1] = chained ? out1[2 * pix + 1 - cb_at] : 128;
  }

  // golden._grid_ndc: x / W * 2 - 1 on this grid
  const float px = __fdiv_rn(static_cast<float>(x), static_cast<float>(gw)) * 2.0f - 1.0f;
  const float py = __fdiv_rn(static_cast<float>(y), static_cast<float>(gh)) * 2.0f - 1.0f;

  for (int s = 0; s < n; ++s) {
    const SrcDesc& d = descs[s];
    const int* box = d.box[chroma];
    if (y < box[0] || y >= box[1] || x < box[2] || x >= box[3]) continue;
    const float* u = d.u;
    const float bd_x = u[12] * px + u[13] * py + u[16];
    const float bd_y = u[14] * px + u[15] * py + u[17];
    if (!inside(bd_x, bd_y)) continue;  // outside the border: no write
    const float tx_x = u[0] * px + u[1] * py + u[4];
    const float tx_y = u[2] * px + u[3] * py + u[5];
    const bool m_tx = inside(tx_x, tx_y);
    const float uv_x = u[6] * tx_x + u[7] * tx_y + u[10];
    const float uv_y = u[8] * tx_x + u[9] * tx_y + u[11];
    const bool m_uv = inside(uv_x, uv_y);
    const float op = u[22];
    const float a_fill = op * u[21];
    const uint8_t* p0 = reinterpret_cast<const uint8_t*>(d.plane[0]);
    const int nch = chroma ? 2 : 1;

    if (d.fmt < kRgba) {
      // family A: yuv source (kernels.cl.swift:186-255)
      if (m_tx && m_uv) {
        float smp[2];
        if (!chroma) {
          smp[0] = sample(p0, taps(uv_x, uv_y, d.dims[0], d.dims[1]), d.dims[1], 1, 0);
        } else {
          const Taps t = taps(uv_x, uv_y, d.dims[2], d.dims[3]);
          const uint8_t* p1 = reinterpret_cast<const uint8_t*>(d.plane[1]);
          if (d.fmt == kPlanar) {
            smp[0] = sample(p1, t, d.dims[3], 1, 0);
            smp[1] = sample(reinterpret_cast<const uint8_t*>(d.plane[2]), t, d.dims[3], 1, 0);
          } else {
            const int src_cb = d.fmt == kNv21 ? 1 : 0;
            smp[0] = sample(p1, t, d.dims[3], 2, src_cb);
            smp[1] = sample(p1, t, d.dims[3], 2, 1 - src_cb);
          }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (k == nch) break;
          const float cur = u8f(acc[k]);
          acc[k] = quant(cur * (1.0f - op) + smp[k] * op);
        }
      } else {
        const float lo = chroma ? -1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (k == nch) break;
          const float fill = csc(chroma + k, u[18], u[19], u[20]);
          const float cur = u8f(acc[k]);
          const float filled = cur * (1.0f - a_fill) + fill * a_fill;
          acc[k] = quant(fminf(fmaxf(filled, lo), 1.0f));
        }
      }
      continue;
    }

    // family B: RGBA / BGRA source (kernels.cl.swift:267-532); write mask = border & element
    if (!m_tx) continue;
    float r = 0.0f, g = 0.0f, b = 0.0f, a_s = 0.0f;
    if (m_uv) {
      const Taps t = taps(uv_x, uv_y, d.dims[0], d.dims[1]);
      const int ri = d.fmt == kBgra ? 2 : 0;
      const float a = sample(p0, t, d.dims[1], 4, 3);
      a_s = a * op;
      r = sample(p0, t, d.dims[1], 4, ri) * a_s;
      g = sample(p0, t, d.dims[1], 4, 1) * a_s;
      b = sample(p0, t, d.dims[1], 4, 2 - ri) * a_s;
    }
    const float fr = u[18] * a_fill;
    const float fg = u[19] * a_fill;
    const float fb = u[20] * a_fill;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == nch) break;
      const int row = chroma + k;
      const float cur = u8f(acc[k]);
      float res = cur * (1.0f - a_fill) + csc(row, fr, fg, fb) * a_fill;
      if (chroma) res = fminf(fmaxf(res, -1.0f), 1.0f);
      if (m_uv) res = res * (1.0f - a_s) + csc(row, r, g, b) * a_s;
      acc[k] = quant(res);
    }
  }

  if (!chroma) {
    out0[pix] = static_cast<uint8_t>(acc[0]);
  } else if (out_fmt == kOutPlanar) {
    out1[pix] = static_cast<uint8_t>(acc[0]);
    out2[pix] = static_cast<uint8_t>(acc[1]);
  } else {
    out1[2 * pix + cb_at] = static_cast<uint8_t>(acc[0]);
    out1[2 * pix + 1 - cb_at] = static_cast<uint8_t>(acc[1]);
  }
}

// RGBA / BGRA target: golden._composite_rgba_out (the blit blend) per source.
__global__ void frame_composite_rgba_kernel(const SrcDesc* __restrict__ descs, int n,
                                            uint8_t* __restrict__ out, int h, int w, int bgra,
                                            int chained) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  uint8_t* px4 = out + 4 * (y * w + x);
  const int r_at = bgra ? 2 : 0;  // memory channel of red

  // acc in r, g, b, a order; u8 values; a cleared target is (0, 0, 0, 255)
  int acc[4] = {0, 0, 0, 255};
  if (chained) {
    acc[0] = px4[r_at];
    acc[1] = px4[1];
    acc[2] = px4[2 - r_at];
    acc[3] = px4[3];
  }

  const float px = __fdiv_rn(static_cast<float>(x), static_cast<float>(w)) * 2.0f - 1.0f;
  const float py = __fdiv_rn(static_cast<float>(y), static_cast<float>(h)) * 2.0f - 1.0f;

  for (int s = 0; s < n; ++s) {
    const SrcDesc& d = descs[s];
    const int* box = d.box[0];
    if (y < box[0] || y >= box[1] || x < box[2] || x >= box[3]) continue;
    const float* u = d.u;
    const float bd_x = u[12] * px + u[13] * py + u[16];
    const float bd_y = u[14] * px + u[15] * py + u[17];
    if (!inside(bd_x, bd_y)) continue;  // outside the border: no write
    const float tx_x = u[0] * px + u[1] * py + u[4];
    const float tx_y = u[2] * px + u[3] * py + u[5];
    const float uv_x = u[6] * tx_x + u[7] * tx_y + u[10];
    const float uv_y = u[8] * tx_x + u[9] * tx_y + u[11];
    const float op = u[22];
    const uint8_t* p0 = reinterpret_cast<const uint8_t*>(d.plane[0]);

    if (inside(tx_x, tx_y) && inside(uv_x, uv_y)) {
      float nw[4];
      float alpha;
      if (d.fmt >= kRgba) {
        const Taps t = taps(uv_x, uv_y, d.dims[0], d.dims[1]);
        const int ri = d.fmt == kBgra ? 2 : 0;
        nw[0] = sample(p0, t, d.dims[1], 4, ri);
        nw[1] = sample(p0, t, d.dims[1], 4, 1);
        nw[2] = sample(p0, t, d.dims[1], 4, 2 - ri);
        alpha = sample(p0, t, d.dims[1], 4, 3) * op;
      } else {
        const float yv = sample(p0, taps(uv_x, uv_y, d.dims[0], d.dims[1]), d.dims[1], 1, 0);
        const Taps t = taps(uv_x, uv_y, d.dims[2], d.dims[3]);
        const uint8_t* p1 = reinterpret_cast<const uint8_t*>(d.plane[1]);
        float cb, cr;
        if (d.fmt == kPlanar) {
          cb = sample(p1, t, d.dims[3], 1, 0);
          cr = sample(reinterpret_cast<const uint8_t*>(d.plane[2]), t, d.dims[3], 1, 0);
        } else {
          const int src_cb = d.fmt == kNv21 ? 1 : 0;
          cb = sample(p1, t, d.dims[3], 2, src_cb);
          cr = sample(p1, t, d.dims[3], 2, 1 - src_cb);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float* m = kYuv2Rgb[k];
          nw[k] = m[0] * yv + m[1] * cb + m[2] * cr + m[3];
        }
        alpha = op;
      }
      nw[3] = 1.0f;
      const float keep = 1.0f - alpha;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = quant(u8f(acc[k]) * keep + nw[k] * alpha);
    } else {
      // border only: the fill colour, alpha channel 1
      const float a_fill = op * u[21];
      const float keep = 1.0f - a_fill;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float fill = k < 3 ? u[18 + k] : 1.0f;
        const float filled = u8f(acc[k]) * keep + fill * a_fill;
        acc[k] = quant(fminf(fmaxf(filled, 0.0f), 1.0f));
      }
    }
  }

  px4[r_at] = static_cast<uint8_t>(acc[0]);
  px4[1] = static_cast<uint8_t>(acc[1]);
  px4[2 - r_at] = static_cast<uint8_t>(acc[2]);
  px4[3] = static_cast<uint8_t>(acc[3]);
}

}  // namespace

// Composite n sources (descs: device array of SrcDesc) onto an h x w target.
// out_fmt 0: out0 = Y, out1 = Cb, out2 = Cr; 1 / 2: out0 = Y, out1 = interleaved
// nv12 / nv21 chroma; 3 / 4: out0 = interleaved [h, w, 4] RGBA / BGRA.
// chained != 0 starts from the values in the outputs instead of the cleared frame.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int sv_frame_composite(const void* descs, int n, void* out0, void* out1, void* out2,
                                  int h, int w, int out_fmt, int chained, void* stream) {
  const dim3 block(32, 8, 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_fmt == kOutRgba || out_fmt == kOutBgra) {
    const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, 1);
    frame_composite_rgba_kernel<<<grid, block, 0, st>>>(static_cast<const SrcDesc*>(descs), n,
                                                        static_cast<uint8_t*>(out0), h, w,
                                                        out_fmt == kOutBgra, chained);
  } else {
    const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, 2);
    frame_composite_kernel<<<grid, block, 0, st>>>(
        static_cast<const SrcDesc*>(descs), n, static_cast<uint8_t*>(out0),
        static_cast<uint8_t*>(out1), static_cast<uint8_t*>(out2), h, w, out_fmt, chained);
  }
  return static_cast<int>(cudaGetLastError());
}
