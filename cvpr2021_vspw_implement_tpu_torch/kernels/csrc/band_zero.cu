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
// 0.73 us at 3.35 TB/s; but each row's 5-float column run still costs a
// whole 32-byte sector, 2048 * 60 of them: 3.9 MB, 1.17 us.  A launch of a
// few us bounds it in practice.
//
// Design: the TPU kernel copied whole blocks through VMEM and wrote the
// still-valid ones back, because a Pallas block is DMA'd in and out whole.
// Here warps store only band elements, in one launch for both bands, with
// 32-bit indices and no division in any loop (the card has no 64-bit
// divider; one 32-bit division a warp finds its plane):
// * the column band: a warp owns up to 32 rows of one plane; when the run
//   is at most 32 floats, lane i writes column i % n of every (32 / n)-th
//   row, so one store instruction covers 32 / n whole runs (6 rows at C5);
//   wider runs take the warp along each row;
// * the row band, one contiguous run of (H - hv) * W floats a plane: a warp
//   owns a segment of 256 units, 16-byte stores when every plane's run
//   starts 16-byte aligned.
// The first blocks of the grid take the column band, the rest the row band;
// planes and segments run along gridDim.x (y and z stop at 65,535).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLogWarps = 3;
constexpr int kWarps = 1 << kLogWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kLogChunkRows = 5;
constexpr int kChunkRows = 1 << kLogChunkRows;  // column-band rows a warp
constexpr int kLogRunUnits = 8;
constexpr int kRunUnits = 1 << kLogRunUnits;  // row-band units a warp

struct Band {
  int planes, H, W, hv, wv;
  int col_chunks;  // warps a plane's column band takes
  int col_blocks;  // blocks of the column band, first in the grid
  int row_units;   // the row band's units a plane
  int row_segs;    // warps a plane's row band takes
  bool vec;        // the row band in float4 units
};

__global__ void __launch_bounds__(kThreads)
    band_zero_kernel(float* __restrict__ x, const Band a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if ((int)blockIdx.x < a.col_blocks) {
    const int unit = (int)blockIdx.x * kWarps + warp;
    const int p = unit / a.col_chunks;
    if (p >= a.planes) return;
    const int r0 = (unit - p * a.col_chunks) * kChunkRows;
    const int r1 = min(r0 + kChunkRows, a.hv);
    const int ncols = a.W - a.wv;
    float* base = x + (int64_t)p * a.H * a.W + a.wv;
    if (ncols <= 32) {
      const int step = 32 / ncols;  // whole runs a store instruction covers
      const int dr = lane / ncols;
      if (dr >= step) return;
      const int c = lane - dr * ncols;
      for (int r = r0 + dr; r < r1; r += step) base[r * a.W + c] = 0.f;
    } else {
      for (int r = r0; r < r1; ++r)
        for (int c = lane; c < ncols; c += 32) base[r * a.W + c] = 0.f;
    }
  } else {
    const int unit = ((int)blockIdx.x - a.col_blocks) * kWarps + warp;
    const int p = unit / a.row_segs;
    if (p >= a.planes) return;
    const int s0 = (unit - p * a.row_segs) * kRunUnits;
    const int s1 = min(s0 + kRunUnits, a.row_units);
    float* run = x + (int64_t)p * a.H * a.W + a.hv * a.W;
    if (a.vec) {
      float4* run4 = reinterpret_cast<float4*>(run);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = s0 + lane; i < s1; i += 32) run4[i] = zero;
    } else {
      for (int i = s0 + lane; i < s1; i += 32) run[i] = 0.f;
    }
  }
}

// ceil(a / 2^k), without a division
int64_t cdiv_pow2(int64_t a, int k) {
  return (a + (int64_t{1} << k) - 1) >> k;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue, without launching, for sizes out of range or a
// tensor whose rows (planes * H) or plane (H * W) do not fit 32 bits.
extern "C" int band_zero_f32(void* x, int planes, int H, int W, int hv,
                             int wv, void* stream) {
  if (planes < 0 || H < 0 || W < 0 || hv < 0 || hv > H || wv < 0 || wv > W ||
      (int64_t)planes * H > INT_MAX || (int64_t)H * W > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Band a{planes, H, W, hv, wv, 0, 0, 0, 0, false};
  const int64_t row_floats = (int64_t)(H - hv) * W;
  // 16-byte stores need every plane's row run 16-byte aligned and whole
  a.vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
          (((int64_t)H * W) & 3) == 0 && (((int64_t)hv * W) & 3) == 0;
  a.row_units = (int)(a.vec ? row_floats >> 2 : row_floats);
  const int64_t col_chunks = wv < W ? cdiv_pow2(hv, kLogChunkRows) : 0;
  const int64_t row_segs = cdiv_pow2(a.row_units, kLogRunUnits);
  const int64_t col_blocks = cdiv_pow2(planes * col_chunks, kLogWarps);
  const int64_t blocks =
      col_blocks + cdiv_pow2(planes * row_segs, kLogWarps);
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks * kWarps > INT_MAX) return (int)cudaErrorInvalidValue;
  a.col_chunks = (int)col_chunks;
  a.col_blocks = (int)col_blocks;
  a.row_segs = (int)row_segs;
  band_zero_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), a);
  return (int)cudaGetLastError();
}
