// The backward of the local cost-volume window aggregation (B5) for Hopper
// (sm_90a), f32 on the CUDA cores: the gradients that train our_warp and
// our_warp_merge.
//
// Replaces no TPU kernel.  The Pallas kernels of
// cvpr2021_vspw_implement_tpu/ops/pallas/local_agg.py define no VJP; the JAX
// package trains through the XLA formulation of models/warp_our.py::
// warp_one_scale over ops/local_pairwise.py, which in the port is the plain
// version and stays off the card.  So these kernels were added to train the
// window methods on the card at all.
//
// Forward (local_agg.cu), for every pixel p of x and every position q of
// the (2r+1)^2 window around p (k = 2r + 1, offset o = dy * k + dx):
//   d(p, q) = |x_p|^2 + |y_q|^2 - 2 <x_p, y_q>,  y = y_dist, y = 0 and
//             |y|^2 = 1e20 outside the image
//   sigmoid: out_p = sum_q w(p, q) y_val(q) / k^2, w = 2 (1 - sigmoid(d))
//   softmax: w = softmax_q(s), s = 1 / (d temp + 1e-5), out-of-image
//            positions kept in the denominator
//   nearest: out_p = y_val at the window's argmax of d
// Backward, g the upstream gradient [B, Cv, H, W], A(p, q) = <g_p,
// y_val(q)> / k^2:
//   sigmoid: G(p, q) = A * (-2 sigmoid(d) (1 - sigmoid(d)))
//   softmax: G(p, q) = -temp s^2 w (A - sum_q' w A)
//   dx_p      = 2 x_p sum_q G - 2 sum_q G y_dist(q)
//   dy_dist_q = 2 y_q sum_p G - 2 sum_p G x_p
//   dy_val_q  = sum_p w(p, q) g_p / k^2
//   nearest:   dy_val_q = sum of g_p over the p whose argmax (the forward's
//              index buffer) is q; no gradient to x or y_dist.
//
// Three kernels:
//   (a) query side, one block a 32-column segment of a query row: recomputes
//       the window's distances over Cd and its dots with g over Cv, turns
//       them into w and G (softmax: the row's maximum, sum and sum w A
//       reduced across the block), writes both as [B, k^2, H, W] scratch,
//       and produces dx from G and y_dist;
//   (b) key side, one block a 32-column segment of a key row: reads w and G
//       at the mirrored offsets (the query p = q - (dy - r, dx - r) of
//       offset o) and produces dy_dist and dy_val.  Each output element is
//       one thread's sum in a fixed order: no atomics, deterministic;
//   (c) nearest: the key side's gather of g through the index, the matching
//       offsets of a key found once as a bit mask, summed in ascending
//       offset order (the plain version's order, so the two are equal).
//
// Bound on this card: operations.  At the training shape (B = 2, 60x60,
// Cd 128, Cv 256, r = 10, k^2 = 441) (a) and (b) do 441 * (128 + 256 + 128
// + 128 + 256) multiply-adds a position, 5.69 GFLOP: 0.034 ms at the
// f32-accurate tensor-core rate (3xTF32, 165 TFLOP/s), 0.085 ms at f32 on
// the CUDA cores; the scratch (2 x 12.7 MB written and read) 0.015 ms.
//
// Design: simple first.  The products run on the CUDA cores in f32 from
// shared memory: a block stages its 32 query (or key) positions' x and g
// columns once and one neighbouring row's 64 columns (32 + 2r) in chunks of
// 32 channels at a time; thread (tx, j) of 32 x 8 owns position tx and
// window columns dx = j + 8n (the dots), or channels j + 8m of a chunk (the
// weighted sums).  Every shared-memory read of a warp is 32 consecutive
// floats, so none has a bank conflict; each product costs about one
// shared-memory load, so the kernels run at about a quarter of the CUDA
// cores' rate at best.  The tensor cores (the forward's 3xTF32 mma.sync,
// or wgmma) are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kTileW = 32;                  // positions of a row a block
constexpr int kGroups = 8;                  // thread rows: j
constexpr int kThreads = kTileW * kGroups;  // 256
constexpr int kMaxR = 15;
constexpr int kSeg = 64;                    // staged columns: 32 + 2r <= 62
constexpr int kChunk = 32;                  // channels staged at a time
constexpr int kPer = kChunk / kGroups;      // channels of a thread a chunk
constexpr int kMaxSmem = 232448;            // 227 KB a block may use
constexpr float kOutOfImage = 1e20f;

enum Mode { kSigmoid = 0, kSoftmax = 1 };

struct Shape {
  int Cd, Cv, H, W, r;
  float temp;
};

// one chunk of channels [c0, c0 + 32) of row hy of src [C, H, W] (one
// image), columns w0 - r .. w0 - r + 63, into seg [32][64]; zeros outside
// the image and beyond C
__device__ __forceinline__ void stage_row(float* seg, const float* src, int C,
                                          int c0, int hy, int w0, int r,
                                          int H, int W) {
  const int64_t plane = (int64_t)H * W;
  for (int e = threadIdx.x; e < kChunk * kSeg; e += kThreads) {
    const int cc = e / kSeg, col = e % kSeg;
    const int ch = c0 + cc, gw = w0 - r + col;
    seg[e] = ch < C && gw >= 0 && gw < W && hy >= 0 && hy < H
                 ? src[ch * plane + (int64_t)hy * W + gw]
                 : 0.0f;
  }
}

// the sum over the 8 thread rows of v at column tx (every thread gets it)
__device__ __forceinline__ float block_sum(float* red, float v, int tx,
                                           int j) {
  __syncthreads();
  red[j * kTileW + tx] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) s += red[i * kTileW + tx];
  return s;
}

__device__ __forceinline__ float block_max(float* red, float v, int tx,
                                           int j) {
  __syncthreads();
  red[j * kTileW + tx] = v;
  __syncthreads();
  float m = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) m = fmaxf(m, red[i * kTileW + tx]);
  return m;
}

__device__ __forceinline__ float softmax_score(float d, float temp) {
  return __frcp_rn(__fadd_rn(__fmul_rn(d, temp), 1e-5f));
}

// (a) ND: the window columns a thread owns, dx = j + 8n for n < ND, at
// least k / 8 rounded up
template <int kMode, int ND>
__global__ void __launch_bounds__(kThreads)
    query_kernel(const float* __restrict__ x, const float* __restrict__ yd,
                 const float* __restrict__ yv, const float* __restrict__ g,
                 float* wbuf, float* gbuf, float* __restrict__ dx,
                 const Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int Cd = s.Cd, Cv = s.Cv, H = s.H, W = s.W, r = s.r;
  const int k = 2 * r + 1, kk = k * k;
  const int w0 = blockIdx.x * kTileW, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % kTileW, j = threadIdx.x / kTileW;
  const int64_t plane = (int64_t)H * W;
  const int wq = w0 + tx;
  const bool q_ok = wq < W;
  const float* const xb = x + (int64_t)b * Cd * plane;
  const float* const ydb = yd + (int64_t)b * Cd * plane;
  const float* const yvb = yv + (int64_t)b * Cv * plane;
  const float* const gb = g + (int64_t)b * Cv * plane;
  // scratch of this image at offset o and this block's position
  const auto at = [&](int o) {
    return ((int64_t)b * kk + o) * plane + (int64_t)h * W + wq;
  };

  float* const xs = smem;                // [Cd][32]
  float* const gs = xs + Cd * kTileW;    // [Cv][32]
  float* const seg = gs + Cv * kTileW;   // [32][64]
  float* const y2s = seg + kChunk * kSeg;  // [64]
  float* const red = y2s + kSeg;         // [8][32]
  float* const rowg = red + kGroups * kTileW;  // [k][32]

  for (int e = threadIdx.x; e < Cd * kTileW; e += kThreads) {
    const int c = e / kTileW, t = e % kTileW;
    xs[e] = w0 + t < W ? xb[c * plane + (int64_t)h * W + w0 + t] : 0.0f;
  }
  for (int e = threadIdx.x; e < Cv * kTileW; e += kThreads) {
    const int c = e / kTileW, t = e % kTileW;
    gs[e] = w0 + t < W ? gb[c * plane + (int64_t)h * W + w0 + t] : 0.0f;
  }
  __syncthreads();
  float x2 = 0.0f;
  for (int c = j; c < Cd; c += kGroups) {
    const float v = xs[c * kTileW + tx];
    x2 = fmaf(v, v, x2);
  }
  x2 = block_sum(red, x2, tx, j);

  // 1. every window entry of the position: distance, dot with g; sigmoid
  // turns them into w and G at once, softmax keeps the score and A
  const float inv_kk = 1.0f / (float)kk;
  float sum_g = 0.0f, run_max = -CUDART_INF_F;
  for (int dy = 0; dy < k; ++dy) {
    const int hy = h + dy - r;
    const bool row_in = hy >= 0 && hy < H;  // the same for the whole block
    float dot[ND], av[ND];
#pragma unroll
    for (int n = 0; n < ND; ++n) dot[n] = av[n] = 0.0f;
    if (row_in) {
      for (int c0 = 0; c0 < Cd; c0 += kChunk) {
        __syncthreads();  // seg and y2s are free
        stage_row(seg, ydb, Cd, c0, hy, w0, r, H, W);
        __syncthreads();
        if (threadIdx.x < kSeg) {
          float a = c0 == 0 ? 0.0f : y2s[threadIdx.x];
          for (int cc = 0; cc < kChunk; ++cc) {
            const float v = seg[cc * kSeg + threadIdx.x];
            a = fmaf(v, v, a);
          }
          y2s[threadIdx.x] = a;
        }
        const int nc = min(kChunk, Cd - c0);
        for (int cc = 0; cc < nc; ++cc) {
          const float xv = xs[(c0 + cc) * kTileW + tx];
          const float* const yc = seg + cc * kSeg + tx + j;
#pragma unroll
          for (int n = 0; n < ND; ++n) dot[n] = fmaf(xv, yc[8 * n], dot[n]);
        }
      }
      for (int c0 = 0; c0 < Cv; c0 += kChunk) {
        __syncthreads();
        stage_row(seg, yvb, Cv, c0, hy, w0, r, H, W);
        __syncthreads();
        const int nc = min(kChunk, Cv - c0);
        for (int cc = 0; cc < nc; ++cc) {
          const float gv = gs[(c0 + cc) * kTileW + tx];
          const float* const vc = seg + cc * kSeg + tx + j;
#pragma unroll
          for (int n = 0; n < ND; ++n) av[n] = fmaf(gv, vc[8 * n], av[n]);
        }
      }
      __syncthreads();  // y2s complete
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int ox = j + 8 * n;
      if (ox >= k) continue;
      const int kx = wq + ox - r;
      const bool in = row_in && kx >= 0 && kx < W;
      const float d =
          in ? (x2 + y2s[tx + ox]) - 2.0f * dot[n] : x2 + kOutOfImage;
      const float a = av[n] * inv_kk;  // 0 outside the image
      const int o = dy * k + ox;
      if (kMode == kSigmoid) {
        const float sg = __frcp_rn(1.0f + expf(-d));
        const float gr = a * (-2.0f * sg * (1.0f - sg));
        sum_g += gr;
        if (q_ok) {
          wbuf[at(o)] = 1.0f - (sg - 0.5f) * 2.0f;
          gbuf[at(o)] = gr;
        }
      } else {
        const float sc = softmax_score(d, s.temp);
        run_max = fmaxf(run_max, sc);
        if (q_ok) {
          wbuf[at(o)] = sc;
          gbuf[at(o)] = a;
        }
      }
    }
  }

  // 2. softmax: the row's maximum, sum and sum of e A, then w and G from
  // this thread's own entries (written above by this thread)
  if (kMode == kSoftmax) {
    const float m = block_max(red, run_max, tx, j);
    float z = 0.0f, za = 0.0f;
    for (int dy = 0; dy < k; ++dy)
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int ox = j + 8 * n;
        if (ox >= k || !q_ok) continue;
        const int o = dy * k + ox;
        const float e = expf(wbuf[at(o)] - m);
        z += e;
        za = fmaf(e, gbuf[at(o)], za);
      }
    z = block_sum(red, z, tx, j);
    const float wa = block_sum(red, za, tx, j) / z;
    for (int dy = 0; dy < k; ++dy)
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int ox = j + 8 * n;
        if (ox >= k || !q_ok) continue;
        const int o = dy * k + ox;
        const float sc = wbuf[at(o)];
        const float w = expf(sc - m) / z;
        const float gr = -s.temp * sc * sc * w * (gbuf[at(o)] - wa);
        wbuf[at(o)] = w;
        gbuf[at(o)] = gr;
        sum_g += gr;
      }
  }
  sum_g = block_sum(red, sum_g, tx, j);  // also orders the scratch writes

  // 3. dx_p = 2 x_p sum_q G - 2 sum_q G y_dist(q), channels j + 8m of each
  // chunk; out-of-image keys have y = 0
  for (int c0 = 0; c0 < Cd; c0 += kChunk) {
    float acc[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) acc[m] = 0.0f;
    for (int dy = 0; dy < k; ++dy) {
      const int hy = h + dy - r;
      if (hy < 0 || hy >= H) continue;
      __syncthreads();
      stage_row(seg, ydb, Cd, c0, hy, w0, r, H, W);
      for (int e = threadIdx.x; e < k * kTileW; e += kThreads) {
        const int ox = e / kTileW, t = e % kTileW;
        rowg[e] = w0 + t < W ? gbuf[((int64_t)b * kk + dy * k + ox) * plane +
                                    (int64_t)h * W + w0 + t]
                             : 0.0f;
      }
      __syncthreads();
      for (int ox = 0; ox < k; ++ox) {
        const float gr = rowg[ox * kTileW + tx];
        const float* const yc = seg + j * kSeg + tx + ox;
#pragma unroll
        for (int m = 0; m < kPer; ++m)
          acc[m] = fmaf(gr, yc[8 * m * kSeg], acc[m]);
      }
    }
    if (q_ok) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int c = c0 + j + 8 * m;
        if (c < Cd)
          dx[((int64_t)b * Cd + c) * plane + (int64_t)h * W + wq] =
              2.0f * xs[c * kTileW + tx] * sum_g - 2.0f * acc[m];
      }
    }
  }
}

// (b) the key side: for key q and offset o the query is p = q - (dy - r,
// dx - r); its column sits at seg column tx + 2r - dx
__global__ void __launch_bounds__(kThreads)
    key_kernel(const float* __restrict__ x, const float* __restrict__ yd,
               const float* __restrict__ g, const float* __restrict__ wbuf,
               const float* __restrict__ gbuf, float* __restrict__ dyd,
               float* __restrict__ dyv, const Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int Cd = s.Cd, Cv = s.Cv, H = s.H, W = s.W, r = s.r;
  const int k = 2 * r + 1, kk = k * k;
  const int w0 = blockIdx.x * kTileW, hk = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % kTileW, j = threadIdx.x / kTileW;
  const int64_t plane = (int64_t)H * W;
  const int wk = w0 + tx;
  const bool k_ok = wk < W;
  const float* const xb = x + (int64_t)b * Cd * plane;
  const float* const gb = g + (int64_t)b * Cv * plane;

  float* const seg = smem;                   // [32][64]
  float* const red = seg + kChunk * kSeg;    // [8][32]
  float* const roww = red + kGroups * kTileW;  // [k][32]

  // the row of weights (w or G) of query row ph at every offset of window
  // row dy that reaches this block's keys
  const auto stage_weights = [&](const float* buf, int dy, int ph) {
    for (int e = threadIdx.x; e < k * kTileW; e += kThreads) {
      const int ox = e / kTileW, t = e % kTileW;
      const int pw = w0 + t - ox + r;
      roww[e] = w0 + t < W && pw >= 0 && pw < W
                    ? buf[((int64_t)b * kk + dy * k + ox) * plane +
                          (int64_t)ph * W + pw]
                    : 0.0f;
    }
  };

  // sum_p G(p, q): thread (tx, j) takes window rows dy = j, j + 8, ...
  float sum_g = 0.0f;
  if (k_ok)
    for (int dy = j; dy < k; dy += kGroups) {
      const int ph = hk - dy + r;
      if (ph < 0 || ph >= H) continue;
      for (int ox = 0; ox < k; ++ox) {
        const int pw = wk - ox + r;
        if (pw >= 0 && pw < W)
          sum_g += gbuf[((int64_t)b * kk + dy * k + ox) * plane +
                        (int64_t)ph * W + pw];
      }
    }
  sum_g = block_sum(red, sum_g, tx, j);

  // one weighted sum over the window: out[c] = scale * sum_o buf(o) src_p[c]
  const auto window_sum = [&](const float* buf, const float* src, int C,
                              int c0, float* acc) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) acc[m] = 0.0f;
    for (int dy = 0; dy < k; ++dy) {
      const int ph = hk - dy + r;
      if (ph < 0 || ph >= H) continue;
      __syncthreads();
      stage_row(seg, src, C, c0, ph, w0, r, H, W);
      stage_weights(buf, dy, ph);
      __syncthreads();
      for (int ox = 0; ox < k; ++ox) {
        const float wv = roww[ox * kTileW + tx];
        const float* const pc = seg + j * kSeg + tx + 2 * r - ox;
#pragma unroll
        for (int m = 0; m < kPer; ++m)
          acc[m] = fmaf(wv, pc[8 * m * kSeg], acc[m]);
      }
    }
  };

  for (int c0 = 0; c0 < Cd; c0 += kChunk) {
    float acc[kPer];
    window_sum(gbuf, xb, Cd, c0, acc);
    if (k_ok) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int c = c0 + j + 8 * m;
        if (c >= Cd) continue;
        const int64_t e = ((int64_t)b * Cd + c) * plane + (int64_t)hk * W + wk;
        dyd[e] = 2.0f * yd[e] * sum_g - 2.0f * acc[m];
      }
    }
  }
  const float inv_kk = 1.0f / (float)kk;
  for (int c0 = 0; c0 < Cv; c0 += kChunk) {
    float acc[kPer];
    window_sum(wbuf, gb, Cv, c0, acc);
    if (k_ok) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int c = c0 + j + 8 * m;
        if (c < Cv)
          dyv[((int64_t)b * Cv + c) * plane + (int64_t)hk * W + wk] =
              acc[m] * inv_kk;
      }
    }
  }
}

// (c) nearest: bit o of a key's mask says that the query at offset o chose
// it; NW words a key
__global__ void __launch_bounds__(kThreads)
    nearest_kernel(const int* __restrict__ idx, const float* __restrict__ g,
                   float* __restrict__ dyv, const Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int Cv = s.Cv, H = s.H, W = s.W, r = s.r;
  const int k = 2 * r + 1, kk = k * k, nw = (kk + 31) / 32;
  const int w0 = blockIdx.x * kTileW, hk = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % kTileW, j = threadIdx.x / kTileW;
  const int64_t plane = (int64_t)H * W;
  const int wk = w0 + tx;
  const bool k_ok = wk < W;
  unsigned* const mask = reinterpret_cast<unsigned*>(smem);  // [nw][32]

  for (int e = threadIdx.x; e < nw * kTileW; e += kThreads) mask[e] = 0u;
  __syncthreads();
  if (k_ok)
    for (int o = j; o < kk; o += kGroups) {
      const int ph = hk - o / k + r, pw = wk - o % k + r;
      if (ph >= 0 && ph < H && pw >= 0 && pw < W &&
          idx[(int64_t)b * plane + (int64_t)ph * W + pw] == o)
        atomicOr(&mask[(o / 32) * kTileW + tx], 1u << (o % 32));
    }
  __syncthreads();
  if (!k_ok) return;
  for (int c = j; c < Cv; c += kGroups) {
    const float* const gc = g + ((int64_t)b * Cv + c) * plane;
    float acc = 0.0f;
    for (int word = 0; word < nw; ++word) {
      unsigned bits = mask[word * kTileW + tx];
      while (bits) {
        const int o = word * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        acc += gc[(int64_t)(hk - o / k + r) * W + (wk - o % k + r)];
      }
    }
    dyv[((int64_t)b * Cv + c) * plane + (int64_t)hk * W + wk] = acc;
  }
}

bool bad_shape(int B, int Cd, int Cv, int H, int W, int r) {
  return B < 1 || Cd < 1 || Cv < 1 || H < 1 || W < 1 || r < 0 || r > kMaxR;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int kMode>
int launch_smooth(const void* x, const void* yd, const void* yv,
                  const void* g, void* wbuf, void* gbuf, void* dx, void* dyd,
                  void* dyv, int B, int Cd, int Cv, int H, int W, int r,
                  float temp, void* stream) {
  if (bad_shape(B, Cd, Cv, H, W, r)) return (int)cudaErrorInvalidValue;
  const Shape s{Cd, Cv, H, W, r, temp};
  const int k = 2 * r + 1;
  const dim3 grid((W + kTileW - 1) / kTileW, H, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t qbytes = sizeof(float) * ((size_t)(Cd + Cv) * kTileW +
                                         kChunk * kSeg + kSeg +
                                         kGroups * kTileW + k * kTileW);
  // the window columns a thread owns: 3 cover k <= 24 (r <= 11), 4 k <= 31
  const auto qk = k <= 3 * kGroups ? query_kernel<kMode, 3>
                                   : query_kernel<kMode, 4>;
  cudaError_t err = prepare(qk, qbytes);
  if (err != cudaSuccess) return (int)err;
  qk<<<grid, kThreads, qbytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(yd),
      static_cast<const float*>(yv), static_cast<const float*>(g),
      static_cast<float*>(wbuf), static_cast<float*>(gbuf),
      static_cast<float*>(dx), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t kbytes =
      sizeof(float) * (kChunk * kSeg + kGroups * kTileW + k * kTileW);
  err = prepare(key_kernel, kbytes);
  if (err != cudaSuccess) return (int)err;
  key_kernel<<<grid, kThreads, kbytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(yd),
      static_cast<const float*>(g), static_cast<const float*>(wbuf),
      static_cast<const float*>(gbuf), static_cast<float*>(dyd),
      static_cast<float*>(dyv), s);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns cudaGetLastError() after its launches (0 on success), or
// cudaErrorInvalidValue outside r <= 15 or the shared memory a block may use.
// wbuf and gbuf: [B, (2r+1)^2, H, W] f32 scratch; x, y_dist, dx, dy_dist
// [B, Cd, H, W]; y_val, g, dy_val [B, Cv, H, W]; idx int32 [B, H, W].
extern "C" int local_sigmoid_agg_bwd_f32(const void* x, const void* y_dist,
                                         const void* y_val, const void* g,
                                         void* wbuf, void* gbuf, void* dx,
                                         void* dy_dist, void* dy_val, int B,
                                         int Cd, int Cv, int H, int W, int r,
                                         void* stream) {
  return launch_smooth<kSigmoid>(x, y_dist, y_val, g, wbuf, gbuf, dx, dy_dist,
                                 dy_val, B, Cd, Cv, H, W, r, 0.0f, stream);
}

extern "C" int local_softmax_agg_bwd_f32(const void* x, const void* y_dist,
                                         const void* y_val, const void* g,
                                         void* wbuf, void* gbuf, void* dx,
                                         void* dy_dist, void* dy_val, int B,
                                         int Cd, int Cv, int H, int W, int r,
                                         float temp, void* stream) {
  return launch_smooth<kSoftmax>(x, y_dist, y_val, g, wbuf, gbuf, dx, dy_dist,
                                 dy_val, B, Cd, Cv, H, W, r, temp, stream);
}

extern "C" int local_nearest_agg_bwd_f32(const void* idx, const void* g,
                                         void* dy_val, int B, int Cv, int H,
                                         int W, int r, void* stream) {
  if (bad_shape(B, 1, Cv, H, W, r)) return (int)cudaErrorInvalidValue;
  const Shape s{1, Cv, H, W, r, 0.0f};
  const int kk = (2 * r + 1) * (2 * r + 1);
  const size_t bytes = sizeof(unsigned) * (size_t)((kk + 31) / 32) * kTileW;
  const cudaError_t err = prepare(nearest_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTileW - 1) / kTileW, H, B);
  nearest_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(g),
      static_cast<float*>(dy_val), s);
  return (int)cudaGetLastError();
}
