"""What an f32-accurate tensor-core product costs on the card: the issue rate
of ``mma.sync`` m16n8k8 TF32 alone and beside the 3xTF32 operand split.

    python3 tools/torch_mma_split_bench.py

Builds a small CUDA program with nvcc (into ``build/kernels/``) from the
split and MMA of ``kernels/csrc/mma_tf32.cuh`` and runs it: 132 blocks of 4,
8 or 16 warps, each warp issuing independent MMA chains on register
operands, with 0, 8 or 16 splits (``split_tf32``) beside every 8 MMAs.
Prints, for each case, TFLOP/s of TF32 products and the clocks each MMA
takes on one of an SM's four schedulers (at the card's maximum SM clock,
read from nvidia-smi).  The tensor-core kernels of the port (B2-B5) issue
about one split per MMA: this is the number that says whether they are
bound by the tensor cores or by the instructions around them.

Needs nvcc and a CUDA device.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOURCE = r"""
#include <cstdio>
#include "mma_tf32.cuh"
using namespace mmatf32;

template <int CHAINS, int SPLITS>
__global__ void bench(float* out, int iters, float seed) {
  float acc[CHAINS][4];
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  uint32_t a[4], b[2];
  float v = seed + threadIdx.x;
  for (int e = 0; e < 4; ++e) a[e] = __float_as_uint(v + e);
  b[0] = __float_as_uint(v * 2);
  b[1] = __float_as_uint(v * 3);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < SPLITS; ++s) {  // operands change: splits are live
      uint32_t h, l;
      split_tf32(v, h, l);
      a[s % 4] ^= h;
      b[s % 2] ^= l;
      v += 1.0f;
    }
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma_tf32(acc[c], a, b);
  }
  float s = 0;
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  if (s == 12345.f) out[threadIdx.x] = s;
}

template <int CHAINS, int SPLITS>
void run(int warps, float* out, double mhz) {
  const int iters = 4096;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  bench<CHAINS, SPLITS><<<132, 32 * warps>>>(out, 16, 1.f);
  cudaEventRecord(e0);
  bench<CHAINS, SPLITS><<<132, 32 * warps>>>(out, iters, 1.f);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = double(warps) / 4 * iters * CHAINS;  // a scheduler's
  printf("warps a SM %2d, MMA chains a warp %d, splits a step of %d MMAs "
         "%2d: %.4f ms, %.1f TFLOP/s TF32, %.2f clocks an MMA a scheduler\n",
         warps, CHAINS, CHAINS, SPLITS, ms,
         132.0 * warps * iters * CHAINS * 2048.0 / ms / 1e9,
         ms * 1e-3 * mhz * 1e6 / mmas);
}

int main(int argc, char** argv) {
  const double mhz = atof(argv[1]);
  float* out;
  cudaMalloc(&out, 4096);
  run<8, 0>(4, out, mhz);
  run<8, 0>(8, out, mhz);
  run<8, 0>(16, out, mhz);
  run<1, 0>(8, out, mhz);
  run<8, 8>(8, out, mhz);
  run<8, 16>(8, out, mhz);
  run<8, 8>(16, out, mhz);
  return cudaGetLastError() != cudaSuccess;
}
"""


def main() -> int:
    from cvpr2021_vspw_implement_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit, mhz = (f.strip() for f in smi.split(","))
    print(f"{name}, {limit} W, SM clock at most {mhz} MHz")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(kernels.BUILD_DIR, "mma_split_bench.cu")
    exe = os.path.join(kernels.BUILD_DIR, "mma_split_bench")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-I", kernels.CSRC, "-o", exe, src], check=True)
    return subprocess.run([exe, mhz]).returncode


if __name__ == "__main__":
    sys.exit(main())
