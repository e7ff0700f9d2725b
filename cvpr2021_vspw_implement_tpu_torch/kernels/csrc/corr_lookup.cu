// RAFT correlation-pyramid window lookup for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel cvpr2021_vspw_implement_tpu/ops/pallas/corr.py::
// lookup_corr_pyramid_fused (kernel _corr_lookup_pyr_kernel).  For every
// query pixel p and pyramid level l it bilinearly samples a 9x9 (r = 4)
// window of the level plane around coords(p) / 2^l.  Taps outside
// [0, Hl-1] x [0, Wl-1] read zero.  Output channel l*81 + tx*9 + ty holds
// the tap at (x + tx - 4, y + ty - 4): x is the outer tap, y the inner one,
// the reference's channel order (models/raft/corr.py::_lookup_level).
//
// Layout: level l is [B, P, Hl, Wl] contiguous (P = H1*W1 query pixels);
// coords are [B, 2, P] (x plane, then y plane); the output is
// [B, L*81, P], i.e. NCHW for the motion encoder that consumes it.
//
// Bound on this card: bytes.  A query touches at most (2r+2)^2 = 100
// distinct values of each level, so at the TC shape (B=1, P=60*107=6420,
// 4 levels) one call must move about 6420*(4*100*4 + 324*4) B = 18.6 MB:
// 5.6 us at 3.35 TB/s.  The arithmetic (a few FMAs per tap) is negligible.
//
// Design: the TPU kernel turned the gather into one-hot mask-reductions
// because the TPU has no fast gather; here a gather is the natural form.
// One block takes 32 queries of one level.  Each thread computes whole taps
// (four reads and a 2x2 blend); neighbouring threads take neighbouring x
// taps of one query, so the four reads of a warp fall on few rows of the
// plane and the repeats of the 10x10 patch hit L1.  The 81x32 results are
// staged in shared memory and written as rows of 32 consecutive queries,
// so the channel-major output is stored coalesced.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kR = 4;
constexpr int kK = 2 * kR + 1;  // taps per axis
constexpr int kTaps = kK * kK;  // channels per level
constexpr int kTileP = 32;      // queries per block
constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;

struct Levels {
  const float* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(Levels lv, const float* __restrict__ coords,
                   float* __restrict__ out, int P, int n_levels) {
  __shared__ float tile[kTaps][kTileP + 1];
  const int p0 = blockIdx.x * kTileP;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int h = lv.h[l];
  const int w = lv.w[l];
  const int64_t plane_size = (int64_t)h * w;
  const float* level = lv.ptr[l] + (int64_t)b * P * plane_size;
  const float* cxs = coords + (int64_t)b * 2 * P;
  const float* cys = cxs + P;
  const float scale = 1.0f / (float)(1 << l);  // exact: a power of two

  for (int i = threadIdx.x; i < kTileP * kTaps; i += kThreads) {
    const int q = i / kTaps;
    const int t = i % kTaps;
    const int ty = t / kK;
    const int tx = t % kK;
    const int p = p0 + q;
    float v = 0.0f;
    if (p < P) {
      const float cx = cxs[p] * scale + (float)(tx - kR);
      const float cy = cys[p] * scale + (float)(ty - kR);
      const float x0f = floorf(cx);
      const float y0f = floorf(cy);
      const float lx = cx - x0f;
      const float ly = cy - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      // validity tested without forming x0 + 1, which could overflow
      const bool vx0 = x0 >= 0 && x0 <= w - 1;
      const bool vx1 = x0 >= -1 && x0 <= w - 2;
      const bool vy0 = y0 >= 0 && y0 <= h - 1;
      const bool vy1 = y0 >= -1 && y0 <= h - 2;
      const float wx0 = vx0 ? 1.0f - lx : 0.0f;
      const float wx1 = vx1 ? lx : 0.0f;
      const float wy0 = vy0 ? 1.0f - ly : 0.0f;
      const float wy1 = vy1 ? ly : 0.0f;
      const float* plane = level + (int64_t)p * plane_size;
      const float g00 = (vy0 && vx0) ? plane[(int64_t)y0 * w + x0] : 0.0f;
      const float g01 = (vy0 && vx1) ? plane[(int64_t)y0 * w + x0 + 1] : 0.0f;
      const float g10 = (vy1 && vx0) ? plane[(int64_t)(y0 + 1) * w + x0] : 0.0f;
      const float g11 =
          (vy1 && vx1) ? plane[(int64_t)(y0 + 1) * w + x0 + 1] : 0.0f;
      v = g00 * (wy0 * wx0) + g01 * (wy0 * wx1) + g10 * (wy1 * wx0) +
          g11 * (wy1 * wx1);
    }
    tile[tx * kK + ty][q] = v;
  }
  __syncthreads();

  float* o = out + ((int64_t)b * n_levels + l) * kTaps * P;
  for (int i = threadIdx.x; i < kTaps * kTileP; i += kThreads) {
    const int c = i / kTileP;
    const int q = i % kTileP;
    if (p0 + q < P) o[(int64_t)c * P + p0 + q] = tile[c][q];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int corr_lookup_f32(const void* l0, const void* l1, const void* l2,
                               const void* l3, int h0, int w0, int h1, int w1,
                               int h2, int w2, int h3, int w3, int n_levels,
                               const void* coords, void* out, int B, int P,
                               void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  const void* ptrs[kMaxLevels] = {l0, l1, l2, l3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = static_cast<const float*>(ptrs[i]);
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
  }
  const dim3 grid((P + kTileP - 1) / kTileP, n_levels, B);
  corr_lookup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(coords), static_cast<float*>(out), P,
      n_levels);
  return (int)cudaGetLastError();
}
