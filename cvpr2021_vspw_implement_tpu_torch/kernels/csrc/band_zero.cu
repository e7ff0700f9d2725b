// In-place re-zero of the width-bucketed pad band for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel cvpr2021_vspw_implement_tpu/ops/pallas/
// band_zero.py::band_zero_inplace (kernels _row_kernel and _col_kernel).
// x is a contiguous [planes, H, W] view of any [..., H, W] tensor (NCHW
// activations, or the [B, P, Hl, Wl] levels of RAFT's correlation pyramid).
// The kernel writes zeros at rows [hv, H) of every plane and at columns
// [wv, W) of rows [0, hv), and touches nothing else.
//
// Bound on this card: bytes written.  It reads nothing: the band is
// planes * ((H - hv) * W + hv * (W - wv)) floats.  At R101's C5 in the
// 480x896 bucket (2048 planes of 60x112, valid 60x107) that is 2.5 MB,
// 0.73 us at 3.35 TB/s, so a launch (a few us) bounds it in practice.
//
// Design: the TPU kernel copied whole blocks through VMEM and wrote the
// still-valid ones back, because a Pallas block is DMA'd in and out whole.
// Here threads store only band elements, in one launch for both bands: one
// grid-stride loop over the column band (W - wv scattered floats per row,
// scalar stores), then over the row band, which is one contiguous run of
// (H - hv) * W floats per plane and is written with 16-byte stores when
// every plane's run starts 16-byte aligned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4 * 132 * 8;

__global__ void __launch_bounds__(kThreads)
    band_zero_kernel(float* __restrict__ x, long long planes, int H, int W,
                     int hv, int wv, bool vec) {
  const long long plane = (long long)H * W;
  const int ncols = W - wv;                       // column band, per row
  const long long col_n = (long long)hv * ncols;  // column band, per plane
  const long long row0 = (long long)hv * W;       // start of the row band
  const long long row_n = plane - row0;           // row band, per plane
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  if (col_n > 0) {
    const long long total = planes * col_n;
    for (long long i = first; i < total; i += stride) {
      const long long p = i / col_n;
      const long long k = i - p * col_n;
      const long long r = k / ncols;
      x[p * plane + r * W + wv + (k - r * ncols)] = 0.f;
    }
  }
  if (row_n > 0) {
    if (vec) {
      const long long per = row_n / 4;  // float4 units a plane
      const long long total = planes * per;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (long long i = first; i < total; i += stride) {
        const long long p = i / per;
        float4* run = reinterpret_cast<float4*>(x + p * plane + row0);
        run[i - p * per] = zero;
      }
    } else {
      const long long total = planes * row_n;
      for (long long i = first; i < total; i += stride) {
        const long long p = i / row_n;
        x[p * plane + row0 + (i - p * row_n)] = 0.f;
      }
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int band_zero_f32(void* x, int planes, int H, int W, int hv,
                             int wv, void* stream) {
  if (planes < 0 || H < 0 || W < 0 || hv < 0 || hv > H || wv < 0 || wv > W)
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)H * W;
  const long long row0 = (long long)hv * W;
  const long long col_n = (long long)hv * (W - wv);
  const long long row_n = plane - row0;
  const long long col_units = (long long)planes * col_n;
  // 16-byte stores need every plane's row run 16-byte aligned and whole
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   plane % 4 == 0 && row0 % 4 == 0;
  const long long row_units = (long long)planes * (vec ? row_n / 4 : row_n);
  const long long units = col_units > row_units ? col_units : row_units;
  if (units == 0) return (int)cudaGetLastError();
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  band_zero_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), planes, H, W, hv, wv, vec);
  return (int)cudaGetLastError();
}
