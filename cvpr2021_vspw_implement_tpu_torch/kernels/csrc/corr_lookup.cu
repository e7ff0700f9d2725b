// RAFT correlation-pyramid window lookup for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel cvpr2021_vspw_implement_tpu/ops/pallas/corr.py::
// lookup_corr_pyramid_fused (kernel _corr_lookup_pyr_kernel; with one level
// also _lookup_level_pallas).  For every query pixel p and pyramid level l it
// bilinearly samples a 9x9 (r = 4) window of the level plane around
// coords(p) / 2^l.  Taps outside [0, Hl-1] x [0, Wl-1] read zero.  Output
// channel l*81 + tx*9 + ty holds the tap at (x + tx - 4, y + ty - 4): x is
// the outer tap, y the inner one, the reference's channel order
// (models/raft/corr.py::_lookup_level).
//
// Layout: level l is [B, P, Hl, Wl] contiguous (P = H1*W1 query pixels);
// coords are [B, 2, P] (x plane, then y plane); the output is
// [B, L*81, P], i.e. NCHW for the motion encoder that consumes it.
//
// Bound on this card: bytes.  A query touches at most (2r+2)^2 = 100
// distinct values of each level, so at the TC shape (B=1, P=60*107=6420,
// 4 levels) one call must move about 6420*(4*100*4 + 324*4) B = 18.6 MB:
// 5.6 us at 3.35 TB/s.  Read in 32-byte sectors, a 10-float row segment
// costs 2-3 of them, about 22 a patch: with the output, about 26 MB, 8 us.
// The arithmetic (a few FMAs per tap) is negligible.
//
// Design: the TPU kernel turned the gather into one-hot mask-reductions
// because the TPU has no fast gather.  Here every query's window is one
// integer-aligned 10x10 patch of its own plane, read once: a warp loads it
// as row segments, lanes on neighbouring columns (4 load instructions a
// patch, out-of-level values zero-filled), for all 8 of its queries before
// it uses any, so 32 loads a lane are in flight.  The blend stays in
// registers: a tap's four values are its lane's and, by shuffles, those of
// lanes + 1, + 10 and + 11.  A query whose patch lies wholly outside the
// level reads nothing and writes zeros.  The 81 outputs of 32 consecutive
// queries are staged in shared memory and stored as channel rows of 32
// queries, coalesced.  Blocks of 4 warps, 7 on an SM, so the TC shape's 804
// blocks run in one wave.
//
// The arithmetic is the earlier kernel's (one thread a tap), bit for bit.
// RAFT feeds each lookup through 20 refinements, which amplify any rounding
// change into the flow and the TC metric: at 480x853 with seeded random
// weights the plain version's order and a separable x-then-y blend each
// moved bucketed TC more than 1e-3 from exact TC.  chip_smoke.py's TC check
// compares the flows after the first refinement, where rounding noise stays
// under its limit, so another order is open to this kernel; this one keeps
// the earlier order: each tap takes the fraction of its own coordinate,
// (c + d) - floor(c + d) in f32 (c + d rounds where it crosses a power of
// two), and sums g00 w00 + g01 w01 + g10 w10 + g11 w11 (w = wy wx) with the
// same fused multiply-adds, within 2.4e-7 of the plain version.  Where c + d rounds up onto an integer, the plain version's
// lower tap moves one column on with weight 1; the same value comes from
// the patch's pair (t, t + 1) with fraction 1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kR = 4;
constexpr int kK = 2 * kR + 1;      // taps per axis
constexpr int kTaps = kK * kK;      // channels per level
constexpr int kSide = kK + 1;       // the patch: 10 x 10
constexpr int kSteps = 4;           // 32-lane steps over a patch's 100 values
constexpr int kTileP = 32;          // queries per block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPerWarp = kTileP / kWarps;  // queries per warp, all in flight
constexpr int kMaxLevels = 4;

struct Levels {
  const float* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// The fraction of tap d's coordinate c + d as the plain version takes it,
// against the patch pair whose lower member is floor(c) + d.
__device__ __forceinline__ float tap_fraction(float c, float c0, int d) {
  const float s = c + (float)d;
  const float f = floorf(s);
  return f == c0 + (float)d ? s - f : 1.0f;
}

// Whether a query's patch (columns x0-4 .. x0+5, rows y0-4 .. y0+5) holds
// a value of the level; tested in float, so coords of any size never reach
// an int cast.
__device__ __forceinline__ bool patch_inside(float x0, float y0, int h,
                                             int w) {
  return x0 >= -5.0f && x0 <= (float)(w + 3) && y0 >= -5.0f &&
         y0 <= (float)(h + 3);
}

__global__ void __launch_bounds__(kThreads, 7)
corr_lookup_kernel(Levels lv, const float* __restrict__ coords,
                   float* __restrict__ out, int P, int n_levels) {
  __shared__ float tile[kTaps][kTileP + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * kTileP;
  const int q0 = warp * kPerWarp;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int h = lv.h[l];
  const int w = lv.w[l];
  const float scale = 1.0f / (float)(1 << l);  // exact: a power of two

  // lane j < kPerWarp reads the coords of the warp's query j once
  float cx = 0.0f, cy = 0.0f;
  if (lane < kPerWarp && p0 + q0 + lane < P) {
    const float* c = coords + (int64_t)b * 2 * P + p0 + q0 + lane;
    cx = c[0] * scale;
    cy = c[P] * scale;
  }

  // patch value e = 32 s + lane sits at row e / 10, column e % 10
  int er[kSteps], ec[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    er[s] = (s * 32 + lane) / kSide;
    ec[s] = (s * 32 + lane) % kSide;
  }

  // every patch of the warp's queries in flight before any is used
  float v[kPerWarp][kSteps];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const float x0 = floorf(__shfl_sync(kFull, cx, j));
    const float y0 = floorf(__shfl_sync(kFull, cy, j));
    const int p = p0 + q0 + j;
    const bool in = p < P && patch_inside(x0, y0, h, w);
    const int xb = in ? (int)x0 - kR : 0;
    const int yb = in ? (int)y0 - kR : 0;
    const float* plane =
        lv.ptr[l] + ((int64_t)b * P + (in ? p : 0)) * h * w;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int y = yb + er[s];
      const int x = xb + ec[s];
      v[j][s] = in && s * 32 + lane < kSide * kSide &&
                        (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w
                    ? __ldg(plane + y * w + x)
                    : 0.0f;
    }
  }

  // the blend in registers; value e's
  // neighbours e + 1, e + 10 and e + 11 are lanes + 1, + 10 and + 11 of
  // its step, or of the next step where the lane passes 31
  const int right = (lane + 1) & 31;
  const int down = (lane + kSide) & 31;
  const int diag = (lane + kSide + 1) & 31;
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const float fx = __shfl_sync(kFull, cx, j);
    const float fy = __shfl_sync(kFull, cy, j);
    const float x0 = floorf(fx);
    const float y0 = floorf(fy);
#pragma unroll
    for (int s = 0; s + 1 < kSteps; ++s) {  // rows 0-8: values e < 90
      // every lane takes part in every shuffle; each then keeps its own
      const float* vs = v[j];
      const float r0 = __shfl_sync(kFull, vs[s], right);
      const float r1 = __shfl_sync(kFull, vs[s + 1], right);
      const float d0 = __shfl_sync(kFull, vs[s], down);
      const float d1 = __shfl_sync(kFull, vs[s + 1], down);
      const float e0 = __shfl_sync(kFull, vs[s], diag);
      const float e1 = __shfl_sync(kFull, vs[s + 1], diag);
      const float g00 = vs[s];
      const float g01 = lane + 1 < 32 ? r0 : r1;
      const float g10 = lane + kSide < 32 ? d0 : d1;
      const float g11 = lane + kSide + 1 < 32 ? e0 : e1;
      const float lx = tap_fraction(fx, x0, ec[s] - kR);
      const float ly = tap_fraction(fy, y0, er[s] - kR);
      const float wx0 = 1.0f - lx, wy0 = 1.0f - ly;
      // g00 w00 + g01 w01 + g10 w10 + g11 w11 with w = wy wx, fused as the
      // earlier kernel's compiled sum: bitwise its output.  Where c + d
      // rounded up onto the next row, it read that row with weights wx0, lx
      // and the row after with weight 0.
      float o;
      if (floorf(fy + (float)(er[s] - kR)) != y0 + (float)(er[s] - kR)) {
        o = __fmaf_rn(g10, wx0, __fmul_rn(g11, lx));
      } else {
        o = __fmaf_rn(g00, __fmul_rn(wy0, wx0),
                      __fmul_rn(g01, __fmul_rn(wy0, lx)));
        o = __fmaf_rn(g10, __fmul_rn(ly, wx0), o);
        o = __fmaf_rn(g11, __fmul_rn(ly, lx), o);
      }
      if (er[s] < kK && ec[s] < kK) tile[ec[s] * kK + er[s]][q0 + j] = o;
    }
  }
  __syncthreads();

  float* o = out + ((int64_t)b * n_levels + l) * kTaps * P + p0;
  const int n = min(kTileP, P - p0);
  for (int i = threadIdx.x; i < kTaps * kTileP; i += kThreads) {
    const int c = i / kTileP;
    const int q = i % kTileP;
    if (q < n) o[(int64_t)c * P + q] = tile[c][q];
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
