"""The bf16 rate of warp-level ``mma.sync`` (m16n8k16, f32 accumulation) on
the card: the ceiling of a kernel that runs its products that way, beside
the data sheet's 989 TFLOP/s for ``wgmma``.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of a
checkout:

    python3 scripts/mma_peak.py

Each thread of 132 x 1 or 2 blocks of 128, 256 or 512 threads runs 4096
iterations of 8 or 16 independent ``mma.sync`` chains on register operands;
the rate is the blocks' products over one CUDA-event timing after a warm-up.
Prints the card's name and power limit first, then one line a shape.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from cirkit_tpu_torch.ops._build import NVCC_FLAGS, _nvcc  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int CH>
__global__ void peak(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, 7u};
  float d[CH][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) mma_bf16(d[c], a, a[c & 3], a[(c + 1) & 3]);
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 12345.f) out[threadIdx.x] = s;  // keeps the products
}
extern "C" int run_peak(int ch, int blocks, int threads, int iters, float* out) {
  if (ch == 8) peak<8><<<blocks, threads>>>(out, iters);
  else peak<16><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__)
        return 2
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "peak.cu", Path(tmp) / "libpeak.so"
        src.write_text(SOURCE)
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src)],
                       check=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.run_peak.argtypes = (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
        out = torch.zeros(1024, device="cuda")
        for ch in (8, 16):
            for threads in (128, 256, 512):
                for per_sm in (1, 2):
                    blocks, iters = 132 * per_sm, 4096
                    if lib.run_peak(ch, blocks, threads, iters, out.data_ptr()) != 0:
                        raise RuntimeError("launch failed")
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    lib.run_peak(ch, blocks, threads, iters, out.data_ptr())
                    end.record()
                    end.synchronize()
                    flops = blocks * threads // 32 * iters * ch * 2 * 16 * 8 * 16
                    rate = flops / start.elapsed_time(end) / 1e9
                    print(f"mma.sync bf16: {ch} chains a warp, {threads} threads, {per_sm} "
                          f"block(s) an SM: {rate:.0f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
