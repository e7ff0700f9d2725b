// Local cost-volume window aggregation for Hopper (sm_90a), f32-accurate on
// the tensor cores: the three modes of our_warp's warping head.
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
//            dist (the reference's argmax quirk: out-of-image wins, gives 0);
//            with an index buffer (int32 [B, H, W], training) it also
//            writes the chosen offset dy * k + dx of each position, which
//            the backward (local_agg_bwd.cu) gathers through, so that both
//            use one argmax.  Eval passes none and is unchanged.
//
// Layout: x, y_dist [B, Cd, H, W], y_val and out [B, Cv, H, W], all NCHW
// contiguous, as the warping head's convolutions produce them.
//
// Valid size.  Width-bucketed eval pads the feature maps bottom/right and
// passes the true size (Hv, Wv) <= (H, W) beside them: the kernel computes
// the Hv x Wv image in the buffer's top-left corner, whose rows and planes
// keep the buffer's strides.  Key rows and columns at or beyond the valid
// size are out of image, as they are beyond the edge of an unpadded map,
// and the outputs beyond it are written as zeros (a NaN there would reach
// the valid region through the bilinear resize's matrix product).  A block
// keeps its tile origins, and no arithmetic of a valid position depends on
// (H, W), so the valid region equals bit for bit the launch on the
// contiguous Hv x Wv crop.  (Hv, Wv) = (H, W) is the unpadded kernel.
//
// Bound on this card: operations.  At our_warp's eval shape (B = 1, 60x107
// = 6420 positions, Cd 128, Cv 256, r = 10, k^2 = 441) the distances take
// 6420 * 441 * 128 * 2 = 0.72 GFLOP and the aggregation 1.45 GFLOP: 0.013
// ms for sigmoid and softmax, 0.0044 ms for nearest, at the 165 TFLOP/s of
// f32-accurate products on the tensor cores (3xTF32: 495 / 3); the 19.7 MB
// of inputs and output take 0.006 ms at 3.35 TB/s.
//
// Design.  A block owns a tile of TR = 2 query rows (1 where Cd > 128 and
// the x tile would not fit) by 32 columns of one image, and for Cv > 256
// one chunk of 256 value channels.  It stages its x tile in shared memory
// once, then walks the key rows of its halo once, top to bottom, so that
// each key row serves every query row of the tile that it reaches.  A key
// row's y_dist segment [Cd, 64] (in stages of 128 channels) and y_val
// segment [256, 64] land by cp.async: the y_val row while the row's
// distances run, the next y_dist row while its weighted sum runs, two
// barriers a key row (nearest: one, on two y_dist stages).  Out-of-image
// key rows are never staged: sigmoid skips them, softmax and nearest take
// their known distance (1e20) analytically, in dy order.
//
// Four warps share an m-tile (16 positions) of a query row, each a quarter
// of the distance channels and of the value channels (kQ; 16 warps a block,
// 128 registers a thread), and for a key row run:
//   1. the distance product of their quarter: x [16 positions, 32 channels]
//      by y_dist [32 channels, keys], on the tensor cores (mma.sync m16n8k8
//      TF32, 3xTF32 with the split of mma_tf32.cuh) into a fresh tile, over
//      the 8-key tiles that the positions' windows reach (5 for r = 10);
//      |y|^2 of the keys from the same fragments;
//   2. the quarters summed through shared memory; each warp turns one of
//      the tile's two position rows into weights, in registers: the k band
//      entries (0 <= dx <= 2r) and zeros elsewhere; softmax as an online
//      pass (a running maximum and sum per position, rescaled per key row,
//      reduced over the 4 lanes of a quad that hold a position's keys);
//      nearest as the strict first maximum in (dy, dx) order; the other
//      row's weights come from a warp of the other parity;
//   3. the weighted sum of its 64 value channels: weights [16, keys] by
//      y_val [keys, 64], 3xTF32, the key row's products in a fresh tile that
//      the f32 accumulator takes (after the softmax rescale).
// Which key a K slot of step 3 stands for is free: slots tig and tig + 4 of
// K step n are keys 8n + 2tig and 8n + 2tig + 1, the two columns that a
// lane's distance tile n holds, so that tile is already step 3's A fragment.
// Rows in shared memory are padded to 8 mod 32 floats, so no fragment load
// has a bank conflict.  Nearest gathers the chosen y_val columns from device
// memory at the end.
//
// What bounds it: instruction issue.  mma.sync is the only tensor-core path
// without warpgroup MMA, and on this card each 3xTF32 split in registers
// costs about as much issue time as the MMA it feeds
// (tools/mma_split_bench.cu), while shared memory cannot hold split copies
// of the staged rows beside the x tile.  Every warp runs every key row: a
// row outside its windows gets zero weights and leaves its state alone,
// because a branch on the warp's role around an MMA makes the compiler fence
// each mma.sync with a warp synchronisation.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "mma_tf32.cuh"

namespace {

using mmatf32::cp_async4;
using mmatf32::cp_async_commit;
using mmatf32::cp_async_wait;
using mmatf32::mma_tf32;
using mmatf32::mma_tf32_fresh;
using mmatf32::smem_addr;
using mmatf32::split_tf32;

constexpr int kTileW = 32;        // query positions of a row per block
constexpr int kMaxR = 15;         // window radius
constexpr int kMaxCd = 256;       // distance channels
constexpr int kSeg = 64;          // key columns staged: 32 + 2r <= 62
constexpr int kLD = kSeg + 8;     // staged rows padded to 8 mod 32 floats
constexpr int kLDX = kTileW + 8;  // x tile rows, likewise
constexpr int kSub = 128;         // y_dist channels a stage holds
constexpr int kQ = 4;             // warps an m-tile: they split the channels
constexpr int kKSplit = kSub / kQ;  // y_dist channels of a warp a stage: 32
constexpr int kChunk = 256;       // value channels a block
constexpr int kWarpCv = kChunk / kQ;  // value channels a warp
constexpr int kKeyTiles = 6;      // 8-key tiles of a window: (15+2r)/8 + 1
constexpr int kNT = kWarpCv / 8;  // value n-tiles of a warp
constexpr int kNJ = 4;            // value n-tiles a fresh tile covers
constexpr int kMaxThreads = 512;  // 2 query rows x 2 m-tiles x kQ warps
// what a lane hands the other warps of its m-tile each key row (floats, 32
// lanes apart): its partial dots of both rows and partial |y|^2; then, in
// the same place, its row's weights and that row's new softmax maximum and
// sum
constexpr int kXchDots = 0, kXchY2 = 4 * kKeyTiles;
constexpr int kXchW = 0, kXchMax = 2 * kKeyTiles, kXchSum = kXchMax + 1;
constexpr int kXch = 32 * (kXchY2 + kKeyTiles);  // floats a warp
constexpr int kMaxSmem = 232448;  // 227 KB a block may use
constexpr float kOutOfImage = 1e20f;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kSigmoid = 0, kSoftmax = 1, kNearest = 2 };

struct Shape {
  int Cd, Cv, H, W, r;
  int Hv, Wv;   // the valid size inside the H x W buffer
  int cd_pad;   // Cd rounded up to kSub: kQ quarters of 32-channel K steps
  int tr;       // query rows of a block
  int n_chunks;
  float temp;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// the kQ warps of an m-tile (barrier 1 + group; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(32 * kQ) : "memory");
}

__device__ __forceinline__ float softmax_score(float d, float temp) {
  return __frcp_rn(__fadd_rn(__fmul_rn(d, temp), 1e-5f));
}

// NKT: the 8-key tiles that the register arrays hold and the products
// cover, at least the (15 + 2r) / 8 + 1 that the windows of an m-tile reach
// (keys past the band get zero weights)
template <int kMode, int NKT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    local_agg_kernel(const float* __restrict__ x, const float* __restrict__ yd,
                     const float* __restrict__ yv, float* __restrict__ out,
                     int* __restrict__ idx, const Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int Cd = s.Cd, Cv = s.Cv, H = s.H, W = s.W, r = s.r;
  const int Hv = s.Hv, Wv = s.Wv;
  const int k = 2 * r + 1;
  const int TR = s.tr, cd_pad = s.cd_pad;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int w0 = blockIdx.x * kTileW;
  const int h0 = blockIdx.y * TR;
  const int b = blockIdx.z / s.n_chunks;
  const int c0v = blockIdx.z % s.n_chunks * kChunk;
  const int64_t plane = (int64_t)H * W;
  const float* const xb = x + (int64_t)b * Cd * plane;
  const float* const ydb = yd + (int64_t)b * Cd * plane;
  const float* const yvb = yv + (int64_t)b * Cv * plane;

  // a tile wholly beyond the valid size: zeros, its chunk's channels
  if (w0 >= Wv || h0 >= Hv) {
    const int nc = kMode == kNearest ? Cv : min(Cv - c0v, kChunk);
    for (int e = tid; e < nc * TR * kTileW; e += nthreads) {
      const int hq = h0 + e / kTileW % TR, wq = w0 + e % kTileW;
      const int c = c0v + e / (kTileW * TR);
      if (hq < H && wq < W)
        out[(int64_t)(b * Cv + c) * plane + (int64_t)hq * W + wq] = 0.0f;
    }
    return;
  }

  // shared memory: the x tile, the y_dist stage (two for nearest), the
  // y_val stage, and each warp's exchange with the others of its m-tile
  constexpr int kYdStages = kMode == kNearest ? 2 : 1;
  constexpr int ydp = kSub * kLD;
  float* const xs = smem;                          // [TR][cd_pad][kLDX]
  float* const ydst = xs + TR * cd_pad * kLDX;     // [stages][kSub][kLD]
  float* const yvst = ydst + kYdStages * ydp;      // [kChunk][kLD]
  float* const xch =
      yvst + (kMode == kNearest ? 0 : kChunk * kLD);  // [warps][kXch]

  // the key rows staged: the halo's rows inside the image, each in nsub
  // y_dist steps of kSub channels
  const int ky0 = max(0, h0 - r), ky1 = min(Hv - 1, h0 + TR - 1 + r);
  const int nsub = (cd_pad + kSub - 1) / kSub;
  const int steps = (ky1 - ky0 + 1) * nsub;

  // copies: one key column (64 a row) a thread, every cstep-th channel row
  // from crow; the x tile one position (32 a row)
  const int col = tid % kSeg, gw = w0 - r + col;
  const bool col_in = gw >= 0 && gw < Wv;
  const int crow = tid / kSeg, cstep = nthreads / kSeg;
  const auto load_yd = [&](int stage, int step) {
    const int hy = ky0 + step / nsub, sub = step % nsub;
    float* const dst = ydst + stage * ydp + col;
    const float* const src = ydb + (int64_t)hy * W + (col_in ? gw : 0);
    for (int c = crow; c < kSub; c += cstep) {
      const int ch = sub * kSub + c;
      cp_async4(smem_addr(dst + c * kLD), src + (ch < Cd ? ch : 0) * plane,
                col_in && ch < Cd);
    }
    cp_async_commit();
  };
  const auto load_yv = [&](int hy) {
    float* const dst = yvst + col;
    const float* const src = yvb + (int64_t)hy * W + (col_in ? gw : 0);
    for (int c = crow; c < kChunk; c += cstep) {
      const int ch = c0v + c;
      cp_async4(smem_addr(dst + c * kLD), src + (ch < Cv ? ch : 0) * plane,
                col_in && ch < Cv);
    }
    cp_async_commit();
  };
  {
    const int xc = tid % kTileW, xrow = tid / kTileW, xstep = nthreads / kTileW;
    for (int t = 0; t < TR; ++t) {
      const bool ok = h0 + t < Hv && w0 + xc < Wv;
      const float* const src = xb + (ok ? (int64_t)(h0 + t) * W + w0 + xc : 0);
      for (int c = xrow; c < cd_pad; c += xstep)
        cp_async4(smem_addr(xs + (t * cd_pad + c) * kLDX + xc),
                  src + (c < Cd ? c : 0) * plane, ok && c < Cd);
    }
  }
  load_yd(0, 0);

  // warp (t, i, h): m-tile i of query row t; the group (t, i) of kQ warps
  // splits the distance channels and the value channels in quarters h.  Its
  // MMA rows gid and gid + 8 are the positions p0 and p0 + 1 of the tile (so
  // x fragments are 64-bit loads); column g of key tile n is key 16i + 8n +
  // g of the staged segment, so a lane's distance tile n holds keys 16i + 8n
  // + 2tig + {0, 1}.  Warp h turns row ro = h % 2 (position p0 + ro) into
  // weights (two warps a row, the same ones).
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int group = warp / kQ, h = warp % kQ, ro = h % 2;
  const int t = group / 2, i = group % 2;
  const int hq = h0 + t;
  const bool q_ok = hq < Hv;  // a query row of the image
  const int p0 = 16 * i + 2 * gid;
  const float* const xw = xs + t * cd_pad * kLDX + p0;
  float* const my_xch = xch + warp * kXch + lane;
  // warp h + q of the group (q = 1 .. kQ - 1), and the one of the other row
  const auto xch_of = [&](int q) {
    return xch + (group * kQ + (h + q) % kQ) * kXch + lane;
  };
  const float* const other_row_xch = xch_of(1);

  cp_async_wait<0>();
  __syncthreads();
  float x2[2] = {0.0f, 0.0f};
  for (int c = tig; c < cd_pad; c += 4) {
    const float2 v = *reinterpret_cast<const float2*>(xw + c * kLDX);
    x2[0] = fmaf(v.x, v.x, x2[0]);
    x2[1] = fmaf(v.y, v.y, x2[1]);
  }
  x2[0] = quad_sum(x2[0]);
  x2[1] = quad_sum(x2[1]);

  // per-position running state (rows gid and gid + 8); nearest keeps row
  // ro's only
  const float x2ro = ro ? x2[1] : x2[0];
  float run_max[2] = {-CUDART_INF_F, -CUDART_INF_F};  // softmax
  float run_sum[2] = {0.0f, 0.0f};
  float best = -CUDART_INF_F;                         // nearest, row ro
  int best_at = 0;
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  // key rows of this group's windows outside the image, above and below:
  // each of their k positions has dist |x|^2 + 1e20 and a zero value.
  // Softmax and nearest take them in dy order: the rows above before the
  // staged ones, those below after them.
  const int n_above = q_ok ? max(0, r - hq) : 0;
  const int n_below = q_ok ? max(0, hq + r - (Hv - 1)) : 0;
  if (n_above > 0) {
    if (kMode == kSoftmax) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        run_max[q] = softmax_score(x2[q] + kOutOfImage, s.temp);
        run_sum[q] = (float)(n_above * k);
      }
    } else if (kMode == kNearest) {
      best = x2ro + kOutOfImage;  // dy = 0, dx = 0
      best_at = 0;
    }
  }

  // dacc[n][2ro + e]: row ro (position p0 + ro), key 16i + 8n + 2tig + e;
  // dots, then distances, then weights.  Every warp runs every key row: a
  // row outside its windows gets zero weights and leaves its state alone,
  // so no branch on the warp's role surrounds an MMA (the compiler would
  // fence each one with a warp synchronisation).
  float dacc[NKT][4];
  float y2p[NKT];  // |y|^2 of key 16i + 8n + gid over this quarter
  for (int step = 0; step < steps; ++step) {
    const int stage = kMode == kNearest ? step % 2 : 0;
    const int hy = ky0 + step / nsub, sub = step % nsub;
    if (step > 0) {
      cp_async_wait<0>();
      __syncthreads();  // this step's y_dist landed; the other stage is free
    }
    if (kMode == kNearest) {
      if (step + 1 < steps) load_yd(1 - stage, step + 1);
    } else if (sub == 0) {
      load_yv(hy);  // the previous row's weighted sums are done
    }
    const bool active = q_ok && abs(hy - hq) <= r;

    // 1. this quarter's distance products over the step's channels (one
    // 32-channel K step), 3xTF32
    if (sub == 0) {
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        y2p[n] = 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) dacc[n][e] = 0.0f;
      }
    }
    {
      const float* const yc =
          ydst + stage * ydp + h * kKSplit * kLD + 16 * i + gid;
      const float* const xc = xw + (sub * kSub + h * kKSplit) * kLDX;
      float tf[NKT][4];
#pragma unroll
      for (int kk = 0; kk < kKSplit; kk += 8) {
        const int c = kk + tig;
        const float2 xa = *reinterpret_cast<const float2*>(xc + c * kLDX);
        const float2 xa4 = *reinterpret_cast<const float2*>(xc + (c + 4) * kLDX);
        uint32_t ah[4], al[4];
        split_tf32(xa.x, ah[0], al[0]);
        split_tf32(xa.y, ah[1], al[1]);
        split_tf32(xa4.x, ah[2], al[2]);
        split_tf32(xa4.y, ah[3], al[3]);
        uint32_t bh[NKT][2], bl[NKT][2];
#pragma unroll
        for (int n = 0; n < NKT; ++n) {
          const float v0 = yc[c * kLD + 8 * n];
          const float v4 = yc[(c + 4) * kLD + 8 * n];
          y2p[n] = fmaf(v0, v0, fmaf(v4, v4, y2p[n]));
          split_tf32(v0, bh[n][0], bl[n][0]);
          split_tf32(v4, bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NKT; ++n) {
          if (kk == 0)
            mma_tf32_fresh(tf[n], al, bh[n]);
          else
            mma_tf32(tf[n], al, bh[n]);
        }
#pragma unroll
        for (int n = 0; n < NKT; ++n) mma_tf32(tf[n], ah, bl[n]);
#pragma unroll
        for (int n = 0; n < NKT; ++n) mma_tf32(tf[n], ah, bh[n]);
      }
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dacc[n][e] += tf[n][e];
    }
    if (sub != nsub - 1) {
      if (kMode != kNearest) {
        __syncthreads();  // every warp is done with the y_dist stage
        load_yd(0, step + 1);
      }
      continue;
    }

    // 2. the group's quarters summed, and row ro's distances -> weights
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        my_xch[32 * (kXchDots + 4 * n + e)] = dacc[n][e];
      y2p[n] = quad_sum(y2p[n]);
      my_xch[32 * (kXchY2 + n)] = y2p[n];
    }
    group_sync(group);
    float dot[NKT][2];
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) dot[n][e] = ro ? dacc[n][2 + e] : dacc[n][e];
    }
#pragma unroll
    for (int q = 1; q < kQ; ++q) {
      const float* const o = xch_of(q);
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dot[n][e] += o[32 * (kXchDots + 4 * n + 2 * ro + e)];
        y2p[n] += o[32 * (kXchY2 + n)];
      }
    }
    const int dy = hy - hq + r;
    float row_best = -CUDART_INF_F, row_max = -CUDART_INF_F, row_sum = 0.0f;
    int row_at = 0;
    float w[NKT][2];
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      // |y|^2 of keys 16i + 8n + gid, then moved to the lanes whose tiles
      // hold keys 16i + 8n + 2tig + e
      const float y2g = y2p[n];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 16 * i + 8 * n + 2 * tig + e;
        const float y2 = __shfl_sync(kFull, y2g, 4 * (2 * tig + e));
        const int kx = w0 - r + key;
        const float y2v = kx >= 0 && kx < Wv ? y2 : kOutOfImage;
        const float d = (x2ro + y2v) - 2.0f * dot[n][e];
        const int dx = key - (p0 + ro);
        const bool band = active && dx >= 0 && dx <= 2 * r;
        if (kMode == kSigmoid) {
          const float sg = __frcp_rn(1.0f + expf(-d));
          w[n][e] = band ? 1.0f - (sg - 0.5f) * 2.0f : 0.0f;
        } else if (kMode == kSoftmax) {
          w[n][e] = softmax_score(d, s.temp);
          if (band) row_max = fmaxf(row_max, w[n][e]);
        } else if (band && d > row_best) {  // keys ascend in a lane
          row_best = d;
          row_at = dx;
        }
      }
    }
    float new_max_ro = 0.0f;
    if (kMode == kSoftmax) {
      // an inactive row keeps the maximum: its weights are all zero
      new_max_ro = fmaxf(ro ? run_max[1] : run_max[0], quad_max(row_max));
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int dx = 16 * i + 8 * n + 2 * tig + e - (p0 + ro);
          w[n][e] = active && dx >= 0 && dx <= 2 * r
                        ? expf(w[n][e] - new_max_ro)
                        : 0.0f;
          row_sum += w[n][e];
        }
      row_sum = quad_sum(row_sum);
    } else if (kMode == kNearest) {
      // the quad's first maximum: larger, or equal and further left
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        const float ob = __shfl_xor_sync(kFull, row_best, m);
        const int oa = __shfl_xor_sync(kFull, row_at, m);
        if (ob > row_best || (ob == row_best && oa < row_at)) {
          row_best = ob;
          row_at = oa;
        }
      }
      if (row_best > best) {  // strict: earlier rows win ties
        best = row_best;
        best_at = dy * k + row_at;
      }
      continue;
    }
    group_sync(group);  // the group has read the partial dots
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) my_xch[32 * (kXchW + 2 * n + e)] = w[n][e];
    if (kMode == kSoftmax) {
      my_xch[32 * kXchMax] = new_max_ro;
      my_xch[32 * kXchSum] = row_sum;
    }
    group_sync(group);
    // both rows' weights in tile layout: row ro from here, the other from
    // warp h + 1; both rows' softmax state
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float theirs = other_row_xch[32 * (kXchW + 2 * n + e)];
        dacc[n][e] = ro ? theirs : w[n][e];
        dacc[n][2 + e] = ro ? w[n][e] : theirs;
      }
    float rescale[2] = {1.0f, 1.0f};
    if (kMode == kSoftmax) {
      const float their_max = other_row_xch[32 * kXchMax];
      const float their_sum = other_row_xch[32 * kXchSum];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float nm = (q == ro) ? new_max_ro : their_max;
        const float rs = (q == ro) ? row_sum : their_sum;
        // unchanged (a row outside the window, or before any in it): 1
        rescale[q] = nm == run_max[q] ? 1.0f : expf(run_max[q] - nm);
        run_sum[q] = run_sum[q] * rescale[q] + rs;
        run_max[q] = nm;
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // y_val landed; every warp is done with the y_dist stage
    if (step + 1 < steps) load_yd(0, step + 1);

    // 3. weighted sum of the key row's values over this quarter's channels,
    // 3xTF32.  The A fragment of K step n is weight tile n reordered; column
    // g of value n-tile jn is channel 64h + 8jn + g, whose keys 16i + 8n +
    // 2tig + {0, 1} are one 64-bit load.
    uint32_t wh[NKT][4], wl[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      split_tf32(dacc[n][0], wh[n][0], wl[n][0]);
      split_tf32(dacc[n][2], wh[n][1], wl[n][1]);
      split_tf32(dacc[n][1], wh[n][2], wl[n][2]);
      split_tf32(dacc[n][3], wh[n][3], wl[n][3]);
    }
    const float* const vs =
        yvst + (kWarpCv * h + gid) * kLD + 16 * i + 2 * tig;
#pragma unroll
    for (int jg = 0; jg < kNT; jg += kNJ) {
      float tf[kNJ][4];
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        uint32_t bh[kNJ][2], bl[kNJ][2];
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
          const float2 v = *reinterpret_cast<const float2*>(
              vs + 8 * (jg + jj) * kLD + 8 * n);
          split_tf32(v.x, bh[jj][0], bl[jj][0]);
          split_tf32(v.y, bh[jj][1], bl[jj][1]);
        }
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
          if (n == 0)
            mma_tf32_fresh(tf[jj], wl[n], bh[jj]);
          else
            mma_tf32(tf[jj], wl[n], bh[jj]);
        }
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) mma_tf32(tf[jj], wh[n], bl[jj]);
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) mma_tf32(tf[jj], wh[n], bh[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[jg + jj][e] = kMode == kSoftmax
                                ? fmaf(acc[jg + jj][e], rescale[e / 2],
                                       tf[jj][e])
                                : acc[jg + jj][e] + tf[jj][e];
    }
  }
  cp_async_wait<0>();
  if (n_below > 0) {
    if (kMode == kSoftmax) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float sc = softmax_score(x2[q] + kOutOfImage, s.temp);
        const float new_max = fmaxf(run_max[q], sc);
        const float rescale = expf(run_max[q] - new_max);
        run_sum[q] = run_sum[q] * rescale +
                     (float)(n_below * k) * expf(sc - new_max);
        run_max[q] = new_max;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          acc[j][2 * q] *= rescale;
          acc[j][2 * q + 1] *= rescale;
        }
      }
    } else if (kMode == kNearest) {
      const float d = x2ro + kOutOfImage;
      if (d > best) {  // the first row below the image, dx = 0
        best = d;
        best_at = (Hv - hq + r) * k;
      }
    }
  }

  if (kMode == kNearest) {
    __syncthreads();  // every warp is done with the x tile
    int* const chosen = reinterpret_cast<int*>(xs) + group * 16;
    if (h < 2 && tig == 0) chosen[2 * gid + ro] = best_at;
    group_sync(group);
    if (hq >= H) return;
    if (idx != nullptr && h == 0 && lane < 16 && w0 + 16 * i + lane < W)
      idx[(int64_t)b * plane + (int64_t)hq * W + w0 + 16 * i + lane] =
          chosen[lane];
    // the group gathers its 16 positions' values, each warp a quarter of
    // the channels; zeros beyond the valid size
#pragma unroll 4
    for (int e = lane; e < 16 * ((Cv + kQ - 1 - h) / kQ); e += 32) {
      const int q = e % 16, c = kQ * (e / 16) + h;
      const int wq = w0 + 16 * i + q;
      if (wq >= W) continue;
      const int hy = hq + chosen[q] / k - r;
      const int wx = wq + chosen[q] % k - r;
      const bool in = q_ok && wq < Wv && hy >= 0 && hy < Hv && wx >= 0 &&
                      wx < Wv;
      out[(int64_t)(b * Cv + c) * plane + (int64_t)hq * W + wq] =
          in ? yvb[c * plane + (int64_t)hy * W + wx] : 0.0f;
    }
    return;
  }
  if (hq >= H) return;
  const float kk = (float)(k * k);
#pragma unroll
  for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ro = e / 2;
      const int wq = w0 + p0 + ro;
      const int c = c0v + kWarpCv * h + 8 * jn + 2 * tig + e % 2;
      if (wq < W && c < Cv)
        out[(int64_t)(b * Cv + c) * plane + (int64_t)hq * W + wq] =
            q_ok && wq < Wv ? (kMode == kSoftmax ? acc[jn][e] / run_sum[ro]
                                                 : acc[jn][e]) /
                                  kk
                            : 0.0f;
    }
}

template <int kMode>
int launch(const void* x, const void* yd, const void* yv, void* out,
           void* idx, int B, int Cd, int Cv, int H, int W, int Hv, int Wv,
           int r, float temp, void* stream) {
  if (B < 1 || Cd < 1 || Cd > kMaxCd || Cv < 1 || H < 1 || W < 1 || r < 0 ||
      r > kMaxR || Hv < 1 || Hv > H || Wv < 1 || Wv > W)
    return (int)cudaErrorInvalidValue;
  Shape s{Cd, Cv, H, W, r, Hv, Wv, (Cd + kSub - 1) / kSub * kSub, 0, 0, temp};
  s.tr = s.cd_pad <= kSub ? 2 : 1;
  s.n_chunks = kMode == kNearest ? 1 : (Cv + kChunk - 1) / kChunk;
  const int threads = 32 * kQ * 2 * s.tr;
  const size_t floats = (size_t)s.tr * s.cd_pad * kLDX +
                        (kMode == kNearest ? 2 : 1) * kSub * kLD +
                        (kMode == kNearest ? 0 : kChunk * kLD) +
                        (size_t)(threads / 32) * kXch;
  const size_t bytes = sizeof(float) * floats;
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + s.tr - 1) / s.tr,
                  B * s.n_chunks);
  // the register arrays hold the 8-key tiles that the windows reach: 5 up
  // to r = 12 (our_warp's r = 10 reaches exactly 5), 6 beyond
  const auto kernel = (15 + 2 * r) / 8 + 1 <= 5
                          ? local_agg_kernel<kMode, 5>
                          : local_agg_kernel<kMode, kKeyTiles>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (set != cudaSuccess) return (int)set;
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(yd),
      static_cast<const float*>(yv), static_cast<float*>(out),
      static_cast<int*>(idx), s);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue outside r <= 15, Cd <= 256, 1 <= Hv <= H,
// 1 <= Wv <= W.
extern "C" int local_sigmoid_agg_f32(const void* x, const void* y_dist,
                                     const void* y_val, void* out, int B,
                                     int Cd, int Cv, int H, int W, int Hv,
                                     int Wv, int r, void* stream) {
  return launch<kSigmoid>(x, y_dist, y_val, out, nullptr, B, Cd, Cv, H, W, Hv,
                          Wv, r, 0.0f, stream);
}

extern "C" int local_softmax_agg_f32(const void* x, const void* y_dist,
                                     const void* y_val, void* out, int B,
                                     int Cd, int Cv, int H, int W, int Hv,
                                     int Wv, int r, float temp,
                                     void* stream) {
  return launch<kSoftmax>(x, y_dist, y_val, out, nullptr, B, Cd, Cv, H, W, Hv,
                          Wv, r, temp, stream);
}

// idx: null, or int32 [B, H, W] for each position's chosen offset
extern "C" int local_nearest_agg_f32(const void* x, const void* y_dist,
                                     const void* y_val, void* out, void* idx,
                                     int B, int Cd, int Cv, int H, int W,
                                     int Hv, int Wv, int r, void* stream) {
  return launch<kNearest>(x, y_dist, y_val, out, idx, B, Cd, Cv, H, W, Hv, Wv,
                          r, 0.0f, stream);
}
