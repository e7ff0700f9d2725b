// Local cost-volume window aggregation for Hopper (sm_90a), f32: the three
// modes of our_warp's warping head.
//
// Replaces the TPU kernels of cvpr2021_vspw_implement_tpu/ops/pallas/
// local_agg.py: local_sigmoid_aggregate (:229), local_softmax_aggregate
// (:121) and local_nearest_aggregate (:197).  For every pixel p of the
// query embedding x and every position q of the (2r+1)^2 window around p
// (dy the outer offset, dx the inner one):
//
//   dist(p, q) = (|x_p|^2 + |y_q|^2) - 2 <x_p, y_q>,   y = y_dist,
//
// with y = 0 and |y|^2 = 1e20 outside the image (the reference's padding).
//   sigmoid: out_p = sum_q 2 (1 - sigmoid(dist)) y_val(q) / k^2
//   softmax: out_p = sum_q softmax_q(1 / (dist * temp + 1e-5)) y_val(q) / k^2,
//            out-of-image positions (score ~3e-21) kept in the denominator
//   nearest: out_p = y_val at the first (dy, dx) of the window's maximum
//            dist (the reference's argmax quirk: out-of-image wins, gives 0)
//
// Layout: x, y_dist [B, Cd, H, W], y_val and out [B, Cv, H, W], all NCHW
// contiguous, as the warping head's convolutions produce them.
//
// Bound on this card: operations.  At our_warp's eval shape (B = 1, 60x107
// = 6420 positions, Cd 128, Cv 256, r = 10, k^2 = 441) the distances take
// 6420 * 441 * 128 * 2 = 0.72 GFLOP and the aggregation 1.45 GFLOP: 0.032
// ms for sigmoid and softmax, 0.011 ms for nearest, at 67 TFLOP/s (f32
// outside the tensor cores); the 19.7 MB of inputs and output take 0.006 ms
// at 3.35 TB/s.
//
// Design.  The TPU kernel computed each dy step as a dense [W, W+2r]
// product masked down to the k-wide band, because the MXU wants dense
// tiles: at W = 107, r = 10 that is 127 columns for 21 used.  Here only the
// band is computed.  One block takes 32 positions of one row (a warp's
// lanes) of one image, and for Cv > 256 one chunk of 256 value channels.
// The x tile [Cd, 32] is staged in shared memory once; for each dy, the
// y_dist row segment [Cd, 32 + 2r] and the y_val segment [256, 32 + 2r] are
// staged (zero outside the image), read straight from NCHW where a
// channel's row segment is contiguous.  Each thread computes up to four dx
// distances of one position, reusing its x value across them; warp 0 turns
// the row's distances into weights (softmax: one pass, with a running max
// and sum per position in place of the TPU kernel's three passes); then each
// thread accumulates 32 channels of one position in registers, lanes on
// consecutive positions so shared-memory reads and the final stores are
// conflict-free and coalesced.  Out-of-image rows are skipped by sigmoid
// (weight x 0), and for softmax only enter the denominator.  Nearest keeps
// the running maximum and its index per position and gathers the chosen
// y_val column from device memory at the end: it stages no values.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kTileW = 32;                  // positions of a row per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 31;                   // window side: r <= 15
constexpr int kDxPerThread = (kMaxK + kWarps - 1) / kWarps;
constexpr int kChunk = 256;                 // value channels per block
constexpr int kAcc = kChunk / kWarps;       // accumulators per thread
constexpr int kMaxSmem = 232448;            // 227 KB a block may use
constexpr float kOutOfImage = 1e20f;

enum Mode { kSigmoid = 0, kSoftmax = 1, kNearest = 2 };

size_t smem_bytes(int mode, int cd, int r) {
  const size_t sw = kTileW + 2 * r;
  const size_t k = 2 * r + 1;
  size_t n = cd * kTileW + cd * sw + sw + kTileW + k * kTileW + kTileW;
  if (mode != kNearest) n += kChunk * sw;
  return n * sizeof(float);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
local_agg_kernel(const float* __restrict__ x, const float* __restrict__ yd,
                 const float* __restrict__ yv, float* __restrict__ out,
                 int Cd, int Cv, int H, int W, int r, float temp,
                 int n_chunks) {
  extern __shared__ float smem[];
  const int k = 2 * r + 1;
  const int sw = kTileW + 2 * r;
  const int w0 = blockIdx.x * kTileW;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks;
  const int c0 = (blockIdx.z % n_chunks) * kChunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t plane = (int64_t)H * W;

  float* xs = smem;                  // [Cd][kTileW]
  float* yds = xs + Cd * kTileW;     // [Cd][sw]
  float* y2s = yds + Cd * sw;        // [sw]
  float* x2s = y2s + sw;             // [kTileW]
  float* ds = x2s + kTileW;          // [k][kTileW]: distances, then weights
  float* lane_f = ds + k * kTileW;   // [kTileW]: softmax rescale, then sum
  float* yvs = lane_f + kTileW;      // [kChunk][sw] (not for nearest)

  const float* xb = x + (int64_t)b * Cd * plane + (int64_t)h * W;
  for (int i = threadIdx.x; i < Cd * kTileW; i += kThreads) {
    const int c = i / kTileW;
    const int q = i % kTileW;
    xs[i] = (w0 + q < W) ? xb[c * plane + w0 + q] : 0.0f;
  }
  __syncthreads();
  if (warp == 0) {
    float s = 0.0f;
    for (int c = 0; c < Cd; ++c) {
      const float v = xs[c * kTileW + lane];
      s += v * v;
    }
    x2s[lane] = s;
  }

  // per-position running state, kept in warp 0's registers
  float run_max = -CUDART_INF_F, run_sum = 0.0f;  // softmax
  float best = -CUDART_INF_F;                      // nearest
  int best_at = 0;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;

  const float* ydb = yd + (int64_t)b * Cd * plane;
  const float* yvb = yv + (int64_t)b * Cv * plane;
  for (int dy = 0; dy < k; ++dy) {
    const int hy = h + dy - r;
    const bool row_in = hy >= 0 && hy < H;
    if (kMode == kSigmoid && !row_in) continue;  // zero values, weight 0
    if (row_in) {
      const float* ydr = ydb + (int64_t)hy * W;
      for (int i = threadIdx.x; i < Cd * sw; i += kThreads) {
        const int c = i / sw;
        const int gw = w0 - r + i % sw;
        yds[i] = (gw >= 0 && gw < W) ? ydr[c * plane + gw] : 0.0f;
      }
      for (int col = threadIdx.x; col < sw; col += kThreads) {
        const int gw = w0 - r + col;
        float s = kOutOfImage;
        if (gw >= 0 && gw < W) {
          s = 0.0f;
          for (int c = 0; c < Cd; ++c) {
            const float v = ydr[c * plane + gw];
            s += v * v;
          }
        }
        y2s[col] = s;
      }
      if (kMode != kNearest) {
        const float* yvr = yvb + (int64_t)hy * W;
        for (int i = threadIdx.x; i < kChunk * sw; i += kThreads) {
          const int c = c0 + i / sw;
          const int gw = w0 - r + i % sw;
          yvs[i] = (c < Cv && gw >= 0 && gw < W) ? yvr[c * plane + gw] : 0.0f;
        }
      }
    }
    __syncthreads();

    // the row's k distances of each of the 32 positions
    if (row_in) {
      float dot[kDxPerThread];
#pragma unroll
      for (int i = 0; i < kDxPerThread; ++i) dot[i] = 0.0f;
      for (int c = 0; c < Cd; ++c) {
        const float xv = xs[c * kTileW + lane];
        const float* yc = yds + c * sw + lane;
#pragma unroll
        for (int i = 0; i < kDxPerThread; ++i) {
          const int dx = warp + kWarps * i;
          if (dx < k) dot[i] = fmaf(xv, yc[dx], dot[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kDxPerThread; ++i) {
        const int dx = warp + kWarps * i;
        if (dx < k)
          ds[dx * kTileW + lane] = (x2s[lane] + y2s[lane + dx]) - 2.0f * dot[i];
      }
    } else {
      for (int i = threadIdx.x; i < k * kTileW; i += kThreads)
        ds[i] = x2s[i % kTileW] + kOutOfImage;
    }
    __syncthreads();

    // distances → weights
    if (kMode == kSigmoid) {
      for (int i = threadIdx.x; i < k * kTileW; i += kThreads) {
        const float s = 1.0f / (1.0f + expf(-ds[i]));
        ds[i] = 1.0f - (s - 0.5f) * 2.0f;
      }
    } else if (warp == 0) {
      if (kMode == kSoftmax) {
        float row_max = -CUDART_INF_F;
        for (int dx = 0; dx < k; ++dx) {
          const float d = ds[dx * kTileW + lane];
          const float s = 1.0f / __fadd_rn(__fmul_rn(d, temp), 1e-5f);
          ds[dx * kTileW + lane] = s;
          row_max = fmaxf(row_max, s);
        }
        const float new_max = fmaxf(run_max, row_max);
        const float rescale = expf(run_max - new_max);
        float row_sum = 0.0f;
        for (int dx = 0; dx < k; ++dx) {
          const float e = expf(ds[dx * kTileW + lane] - new_max);
          ds[dx * kTileW + lane] = e;
          row_sum += e;
        }
        run_sum = run_sum * rescale + row_sum;
        run_max = new_max;
        lane_f[lane] = rescale;
      } else {
        for (int dx = 0; dx < k; ++dx) {
          const float d = ds[dx * kTileW + lane];
          if (d > best) {  // strict: the first maximum in (dy, dx) order
            best = d;
            best_at = dy * k + dx;
          }
        }
      }
    }
    __syncthreads();

    // weighted accumulation of the value segment
    if (kMode != kNearest) {
      if (kMode == kSoftmax) {
        const float rescale = lane_f[lane];
#pragma unroll
        for (int j = 0; j < kAcc; ++j) acc[j] *= rescale;
      }
      if (row_in) {
        for (int dx = 0; dx < k; ++dx) {
          const float wgt = ds[dx * kTileW + lane];
          const float* v = yvs + warp * sw + lane + dx;
#pragma unroll
          for (int j = 0; j < kAcc; ++j)
            acc[j] = fmaf(wgt, v[j * kWarps * sw], acc[j]);
        }
      }
      __syncthreads();  // before the next row's staging overwrites
    }
  }

  const int wq = w0 + lane;
  if (kMode == kNearest) {
    int* chosen = reinterpret_cast<int*>(lane_f);
    if (warp == 0) chosen[lane] = best_at;
    __syncthreads();
    for (int i = threadIdx.x; i < Cv * kTileW; i += kThreads) {
      const int c = i / kTileW;
      const int q = i % kTileW;
      if (w0 + q >= W) continue;
      const int hy = h + chosen[q] / k - r;
      const int wx = w0 + q + chosen[q] % k - r;
      const bool in = hy >= 0 && hy < H && wx >= 0 && wx < W;
      out[(int64_t)(b * Cv + c) * plane + (int64_t)h * W + w0 + q] =
          in ? yvb[c * plane + (int64_t)hy * W + wx] : 0.0f;
    }
    return;
  }
  if (kMode == kSoftmax) {
    if (warp == 0) lane_f[lane] = run_sum;
    __syncthreads();
  }
  if (wq >= W) return;
  const float denom = kMode == kSoftmax ? lane_f[lane] : 1.0f;
  const float kk = (float)(k * k);
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int c = c0 + warp + kWarps * j;
    if (c < Cv)
      out[(int64_t)(b * Cv + c) * plane + (int64_t)h * W + wq] =
          (kMode == kSoftmax ? acc[j] / denom : acc[j]) / kk;
  }
}

template <int kMode>
int launch(const void* x, const void* yd, const void* yv, void* out, int B,
           int Cd, int Cv, int H, int W, int r, float temp, void* stream) {
  if (B < 1 || Cd < 1 || Cv < 1 || H < 1 || W < 1 || r < 0 ||
      2 * r + 1 > kMaxK)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(kMode, Cd, r);
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaFuncSetAttribute(
      local_agg_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (set != cudaSuccess) return (int)set;
  const int n_chunks = kMode == kNearest ? 1 : (Cv + kChunk - 1) / kChunk;
  const dim3 grid((W + kTileW - 1) / kTileW, H, B * n_chunks);
  local_agg_kernel<kMode>
      <<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(yd),
          static_cast<const float*>(yv), static_cast<float*>(out), Cd, Cv, H,
          W, r, temp, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 on success).
extern "C" int local_sigmoid_agg_f32(const void* x, const void* y_dist,
                                     const void* y_val, void* out, int B,
                                     int Cd, int Cv, int H, int W, int r,
                                     void* stream) {
  return launch<kSigmoid>(x, y_dist, y_val, out, B, Cd, Cv, H, W, r, 0.0f,
                          stream);
}

extern "C" int local_softmax_agg_f32(const void* x, const void* y_dist,
                                     const void* y_val, void* out, int B,
                                     int Cd, int Cv, int H, int W, int r,
                                     float temp, void* stream) {
  return launch<kSoftmax>(x, y_dist, y_val, out, B, Cd, Cv, H, W, r, temp,
                          stream);
}

extern "C" int local_nearest_agg_f32(const void* x, const void* y_dist,
                                     const void* y_val, void* out, int B,
                                     int Cd, int Cv, int H, int W, int r,
                                     void* stream) {
  return launch<kNearest>(x, y_dist, y_val, out, B, Cd, Cv, H, W, r, 0.0f,
                          stream);
}
