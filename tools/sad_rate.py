"""Measure the byte-SIMD SAD instruction's throughput on a CUDA card.

    python tools/sad_rate.py

Builds a kernel (with ``swiftvideo_tpu_torch.ops.nvcc``, into the package's
build directory) whose threads run 8 independent chains of the
instruction that ``csrc/motion_search.cu``'s SAD kernel uses,
``vabsdiff4.u32.u32.u32.add`` (4 bytes' |a - b| added into an
accumulator), and times 132 x 16 blocks of 256 threads with CUDA events.
Prints one JSON line: lane-instructions per second, and per SM per clock at
the SM clock nvidia-smi reads right after the run, with the card's name and
power limit.  ``chip_smoke.py`` bounds K4 by 4 terms a lane-instruction at
``INT_LANES_PER_SM_CLOCK`` lanes per SM per clock; this checks that rate.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from swiftvideo_tpu_torch.ops import nvcc  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void sad_rate_kernel(const uint32_t* in, int* out, int iters) {
  const uint32_t a = in[threadIdx.x & 31], b = in[32 + (threadIdx.x & 31)];
  int acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %0;" : "+r"(acc[j]) : "r"(a ^ j), "r"(b));
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int sv_sad_rate(const void* in, void* out, int iters, int blocks, void* stream) {
  sad_rate_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<int*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""
INSTR_PER_ITER = 16 * 8


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    nvcc.BUILD_DIR.mkdir(exist_ok=True)
    src = nvcc.BUILD_DIR / "sad_rate.cu"
    src.write_text(SOURCE)
    nvcc.build_all([src])
    lib = ctypes.CDLL(str(nvcc.library_path(src)))
    fn = lib.sv_sad_rate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    blocks, iters = 132 * 16, 2000
    inp = torch.randint(0, 2 ** 31, (64,), dtype=torch.int64).to(torch.int32).to(dev)
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if fn(inp.data_ptr(), out.data_ptr(), iters, blocks, stream) != 0:
            raise SystemExit("sad_rate_kernel launch failed")

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    n = 10
    a.record()
    for _ in range(n):
        run()
    b.record()
    torch.cuda.synchronize()
    sec = a.elapsed_time(b) / 1e3 / n
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True).stdout.strip()
    clock_mhz = float(smi.split(",")[2])
    rate = blocks * 256 * iters * INSTR_PER_ITER / sec
    print(json.dumps({"card": smi, "lane_instructions_per_s": rate,
                      "per_sm_per_clock_at_read_clock": rate / (132 * clock_mhz * 1e6),
                      "ms_per_launch": sec * 1e3}))


if __name__ == "__main__":
    main()
