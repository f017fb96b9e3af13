// The mixing wall's N-way s16 audio mix, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package mixes the wall's audio with XLA ops
// (swiftvideo_tpu/parallel/wall.py MixingWall mix_audio: gain, float32 sum over
// the streams, trunc, clamp to s16).  The port ran the same formula as six torch
// ops a tick, whose host time set the wall's tick; this kernel is that formula as
// one launch (ops/audio.py mix_wall_s16_cuda, plain version mix_wall_s16_torch).
//
//   out[i] = s16(clamp(trunc(sum over s = 0 .. streams - 1 of gains[s] * audio[s][i]),
//                      -32768, 32767))
//
// Order: each output sample's sum is taken from stream 0 to stream streams - 1,
// starting from 0.0f, each product of the sample (exact in float32) and its gain
// rounded to float32 on its own and each add rounded on its own (__fmul_rn,
// __fadd_rn; the file is built with --fmad=false as well).  Where every partial sum
// is an exact float32 integer (unity or power-of-two gains with sums below 2^24) any
// order gives the same result, and so does torch.sum's; for other gains this order
// is the kernel's contract.
//
// Bound: latency, not bytes.  The wall's tick reads 64 x 1600 s16 (204.8 KB) and
// writes 3.2 KB: 0.06 us at 3.35 TB/s.  What costs is waiting on device memory: a
// thread that loads its streams into registers one after another waits about once a
// stream, since the compiler keeps few such loads in flight (~17 us a tick on an
// H100 for one thread over 8 samples and every stream, PERF.md).  So a
// block of 64 threads takes 64 adjacent samples (25 blocks for the wall's 1600),
// and stages the samples of up to kTile streams in shared memory first: every
// thread issues its 16-byte cp.async copies (8 each at 64 streams) without waiting
// on any, so the block waits on device memory once a tile.  Then each thread sums
// its one sample over the tile's streams in order from shared memory.  Shapes whose
// rows are not whole 16-byte pieces (samples not a multiple of 8, or an unaligned
// base) stage the tile with 2-byte loads instead; the last block of a row takes the
// tail of fewer than 64 samples.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;    // adjacent samples a block, one a thread
constexpr int kThreads = kChunk;
constexpr int kTile = 64;     // streams staged in shared memory at a time
constexpr int kPiece = 8;     // samples in one 16-byte copy

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ int16_t saturate(float sum) {
  return static_cast<int16_t>(
      static_cast<int>(fminf(fmaxf(truncf(sum), -32768.0f), 32767.0f)));
}

// kWide: samples % kPiece == 0 and audio 16-byte aligned, so that every row's
// chunk is whole 16-byte pieces.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
wall_audio_kernel(const int16_t* __restrict__ audio, const float* __restrict__ gains,
                  int16_t* __restrict__ out, int streams, int samples) {
  __shared__ __align__(16) int16_t tile[kTile][kChunk];
  __shared__ float gain[kTile];
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * kChunk;
  const int width = min(kChunk, samples - i0);  // this block's samples
  float acc = 0.0f;
  for (int s0 = 0; s0 < streams; s0 += kTile) {
    const int rows = min(kTile, streams - s0);
    const int16_t* src = audio + static_cast<size_t>(s0) * samples + i0;
    if (kWide) {
      const int pieces = width / kPiece;
      for (int k = t; k < rows * pieces; k += kThreads) {
        const int r = k / pieces, p = k - r * pieces;
        copy16(&tile[r][p * kPiece], src + static_cast<size_t>(r) * samples + p * kPiece);
      }
    } else {
      for (int k = t; k < rows * width; k += kThreads) {
        const int r = k / width, c = k - r * width;
        tile[r][c] = __ldg(src + static_cast<size_t>(r) * samples + c);
      }
    }
    if (t < rows) gain[t] = __ldg(gains + s0 + t);
    if (kWide) wait_copies();
    __syncthreads();
    if (t < width) {
#pragma unroll 8
      for (int r = 0; r < rows; ++r)
        acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(tile[r][t]), gain[r]));
    }
    __syncthreads();
  }
  if (t < width) out[i0 + t] = saturate(acc);
}

}  // namespace

// Mix [streams, samples] s16 `audio` with [streams] float32 `gains` into [samples]
// s16 `out`, all on card `device`, on `stream`.  Returns cudaGetLastError() after
// the launch (0: launched).
extern "C" int sv_wall_audio(const void* audio, const void* gains, void* out, int streams,
                             int samples, int device, void* stream) {
  if (samples <= 0) return 0;
  int current = device;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int16_t*>(audio);
  const auto* g = static_cast<const float*>(gains);
  auto* o = static_cast<int16_t*>(out);
  const int blocks = (samples + kChunk - 1) / kChunk;
  if (samples % kPiece == 0 && reinterpret_cast<uintptr_t>(audio) % 16 == 0)
    wall_audio_kernel<true><<<blocks, kThreads, 0, st>>>(a, g, o, streams, samples);
  else
    wall_audio_kernel<false><<<blocks, kThreads, 0, st>>>(a, g, o, streams, samples);
  const int err = static_cast<int>(cudaGetLastError());
  if (current != device) cudaSetDevice(current);
  return err;
}
