// The backward of the local cost-volume window aggregation (B5) for Hopper
// (sm_90a), its window products on the tensor cores at f32 accuracy: the
// gradients that train our_warp and our_warp_merge.
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
// Bound on this card: operations.  At the training shape (B = 2, 60x60,
// Cd 128, Cv 256, r = 10, k^2 = 441) the two smooth-mode kernels do 441 *
// (128 + 256 + 128 + 128 + 256) multiply-adds a position, 5.69 GFLOP: 0.034
// ms at the f32-accurate tensor-core rate (3xTF32, 165 TFLOP/s); the w and
// G scratch (2 x 12.7 MB written and read) 0.015 ms at 3.35 TB/s.
//
// Design.  Two kernels a smooth mode, as 16 x 8 x 8 TF32 mma.sync tiles in
// 3xTF32 (mma_tf32.cuh: an operand split into hi + lo, products lo*hi +
// hi*lo + hi*hi, each k8 step's products in a fresh tile added to the
// accumulator in f32).  Positions p0 = 16i + 2 gid and p0 + 1 of an m-tile
// are MMA rows gid and gid + 8, so a lane's C fragment of a key tile holds
// positions p0, p0 + 1 at keys 2 tig, 2 tig + 1; the K slots tig and tig +
// 4 of a step over keys (or queries) stand for keys 2 tig and 2 tig + 1, so
// that fragment is already the A operand of the next product (the forward's
// trick).
//
// (a) query side, one block a row of 32 query positions (two m-tiles of
//     16): its x and g columns stay in shared memory; it walks the key rows
//     of the halo once.  Each key row's y_val segment (all Cv channels, in
//     stages when they do not fit) and y_dist segment land by cp.async: the
//     next row's y_val while this row's distances, weights and dx run, the
//     next row's y_dist while the next row's dots with g run.  Warp (i, n)
//     of the 2 x NKT owns key tile n (8 keys) of m-tile i: over all
//     channels it takes A = g . y_val^T and the distances D = x . y_dist^T
//     (four k8 steps in flight), turns its four entries into w and G in
//     registers and writes them to a band tile in shared memory [key
//     column][position] (zeros off the band).  Then dx += G . y_dist from
//     the same staged y_dist row: each warp a fixed set of 8-channel tiles
//     (n, n + NKT, ...), A fragments read from the band tile.  So y_dist is
//     read once a key row, and the band tile is stored as one coalesced row
//     of scratch [B, k^2, H, W] an offset.  Softmax needs the whole window
//     before its weights: pass 1 writes the scores and A to the scratch and
//     keeps each position's running maximum, sum and sum e A (the lanes'
//     partials merged across the quad and the warps at the end); pass 2
//     walks the key rows again, stages y_dist and the pass-1 band, turns it
//     into w and G and runs dx.  Softmax's distance product runs on the CUDA
//     cores in f32: its G carries s^2 (up to 1e3) times the rounding of
//     near-match distances, and 3xTF32 rounds a 128-term dot product about
//     ten times coarser than an f32 fma chain, which would take softmax past
//     1e-4 of a float64 backward.  Its other products are on the tensor
//     cores.
// (b) key side, one block a row of 32 keys and a chunk of 128 output
//     channels (of dy_dist with G and x, or of dy_val with w and g): it walks
//     the query rows of the halo, double-buffered by cp.async, each row's x
//     or g segment and its band of G or w gathered from scratch at the
//     mirrored offsets (the query p = q - (dy - r, dx - r) of offset o) into a
//     band tile [query column][key].  dy += G^T . x (or w^T . g): warp (i, c)
//     owns key m-tile i and 32 channels, a fresh tile a query row.  No
//     atomics: each output is one lane's fixed-order sum.
// (c) nearest: the key side's gather of g through the index, summed in
//     ascending offset order (the plain version's order, so the two are
//     equal).  Bound: bytes, the index and the g of the picks inside the
//     image read once, dy_val written once (0.0032 ms at 2x60x60, Cv 256,
//     on the smoke's index).  The argmax quirk crowds the picks: a key with
//     a large |y|^2 is picked by every query whose window holds it, up to
//     (2r + 1)^2, and g's NCHW planes put a pick's channels 14 KB apart, so
//     each (pick, channel) is a sector of its own unless neighbouring
//     queries are picked.  So a block of 8 x 32 keys and 32 channels reads
//     its halo's index once, coalesced, gives each picking query a slot in
//     position order and lists each key's picks in offset order (bit masks,
//     ballots and scans); it stages g by slot, the lanes along neighbouring
//     picked queries, by cp.async two stages deep; a warp adds up a key's
//     picks in order, a lane a channel, many loads before their adds; the
//     sums leave through a [channel][key] tile as coalesced rows.
//
// Rows in shared memory are padded (8 or 24 mod 32 floats for the staged
// segments and resident tiles, 4 mod 32 for the band tiles), so no fragment
// load has a bank conflict.

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

constexpr int kTileW = 32;           // positions (or keys) of a row a block
constexpr int kMaxR = 15;
constexpr int kMaxCd = 256;
constexpr int kLDX = kTileW + 8;     // resident x and g tiles [channel][position]
constexpr int kLDT = kTileW + 4;     // band tiles [column][position or key]
constexpr int kStageCols = 64;       // staging threads a channel row
constexpr int kKC = 128;             // key side: output channels a block
constexpr int kKeyThreads = 256;     // key side: 2 m-tiles x 4 x 32 channels
constexpr int kMaxSmem = 232448;     // 227 KB a block may use
constexpr float kOutOfImage = 1e20f;
constexpr unsigned kFull = 0xffffffffu;

// the staged key (or query) columns of a block, 16 + 8 NKT, and their
// padded row length
__host__ __device__ constexpr int seg_cols(int nkt) { return 16 + 8 * nkt; }
__host__ __device__ constexpr int seg_ld(int nkt) { return nkt == 5 ? 56 : 72; }

enum Mode { kSigmoid = 0, kSoftmax = 1 };

struct Shape {
  int Cd, Cv, H, W, r;
  int cd32, cv32;  // channels rounded up to 32: zero-filled tile rows
  int kvc, nvc;    // query side: y_val channels a stage, stages a key row
  int nzd, nz;     // key side: channel chunks of dy_dist, of both
  float temp;
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ float softmax_score(float d, float temp) {
  return __frcp_rn(__fadd_rn(__fmul_rn(d, temp), 1e-5f));
}

// softmax statistics of a set of scores: their maximum m, sum of e^(s - m)
// z and sum of e^(s - m) A za; merge() adds another set's
__device__ __forceinline__ void merge(float& m, float& z, float& za, float m2,
                                      float z2, float za2) {
  const float nm = fmaxf(m, m2);
  if (nm == -CUDART_INF_F) return;
  const float f = expf(m - nm), f2 = expf(m2 - nm);
  z = z * f + z2 * f2;
  za = za * f + za2 * f2;
  m = nm;
}

__device__ __forceinline__ void online(float& m, float& z, float& za, float s,
                                       float a) {
  if (s > m) {
    const float f = expf(m - s);
    z *= f;
    za *= f;
    m = s;
  }
  const float e = expf(s - m);
  z += e;
  za = fmaf(e, a, za);
}

// channel rows [c0, c1) of src (C channels, channel-major) at image row hy,
// the kCols columns from w0 - r, into dst [c - c0][LD]: one column a thread
// (kStageCols a row; those past kCols idle), every kStep-th row; zeros
// beyond C and outside the image
template <int kCols, int LD, int kStep>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int C,
                                           int c0, int c1, int hy, int w0,
                                           int r, int W, int64_t plane) {
  const int col = threadIdx.x % kStageCols;
  if (col >= kCols) return;
  const int gw = w0 - r + col;
  const bool in = gw >= 0 && gw < W;
  const float* const from = src + (int64_t)hy * W + (in ? gw : 0);
  for (int c = c0 + (int)threadIdx.x / kStageCols; c < c1; c += kStep)
    cp_async4(smem_addr(dst + (c - c0) * LD + col),
              from + (int64_t)(c < C ? c : 0) * plane, in && c < C);
}

// acc (+)= a [16 positions x nk] . b [nk x 8 keys] over channels [0, nk), nk
// a multiple of 32.  a: a resident tile [channel][kLDX] at column p0 (a
// float2: positions p0, p0 + 1, MMA rows gid and gid + 8); bcol: a staged
// segment [channel][LDB] at this lane's key column (MMA column gid).  Four
// k8 steps in flight, each in a fresh tile.  kY2: y2 also sums the squares
// of the b values (channels tig, tig + 4 of each step).
template <int LDB, bool kY2>
__device__ __forceinline__ void window_dots(float (&acc)[4], float& y2,
                                            const float* a, const float* bcol,
                                            int nk, int tig) {
  for (int c0 = 0; c0 < nk; c0 += 32) {
    float tf[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + 8 * q + tig;
      const float2 a0 = *reinterpret_cast<const float2*>(a + c * kLDX);
      const float2 a4 = *reinterpret_cast<const float2*>(a + (c + 4) * kLDX);
      uint32_t ah[4], al[4];
      split_tf32(a0.x, ah[0], al[0]);
      split_tf32(a0.y, ah[1], al[1]);
      split_tf32(a4.x, ah[2], al[2]);
      split_tf32(a4.y, ah[3], al[3]);
      const float b0 = bcol[c * LDB], b4 = bcol[(c + 4) * LDB];
      if (kY2) y2 = fmaf(b0, b0, fmaf(b4, b4, y2));
      uint32_t bh[2], bl[2];
      split_tf32(b0, bh[0], bl[0]);
      split_tf32(b4, bh[1], bl[1]);
      mma_tf32_fresh(tf[q], al, bh);
      mma_tf32(tf[q], ah, bl);
      mma_tf32(tf[q], ah, bh);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += tf[q][e];
  }
}

// a lane's four entries of a band tile: key columns col, col + 1 at
// positions p0, p0 + 1, in C-fragment order (e = 2 * position + key)
__device__ __forceinline__ void tile_put(float* t, int col, int p0,
                                         const float (&v)[4]) {
  *reinterpret_cast<float2*>(t + col * kLDT + p0) = make_float2(v[0], v[2]);
  *reinterpret_cast<float2*>(t + (col + 1) * kLDT + p0) =
      make_float2(v[1], v[3]);
}

__device__ __forceinline__ void tile_get(const float* t, int col, int p0,
                                         float (&v)[4]) {
  const float2 a = *reinterpret_cast<const float2*>(t + col * kLDT + p0);
  const float2 c = *reinterpret_cast<const float2*>(t + (col + 1) * kLDT + p0);
  v[0] = a.x;
  v[1] = c.x;
  v[2] = a.y;
  v[3] = c.y;
}

// dxa[u] (+)= G [16 positions x keys of m-tile mi] . y_dist [keys x 8
// channels of tile nt + NKT u]: the A fragments from the band tile tg, the B
// fragments from the staged y_dist row; a fresh tile a key row.  Tiles past
// the last (cd8 - 1) repeat it and are not stored.
template <int NKT, int kDXT>
__device__ __forceinline__ void dx_product(float (&dxa)[kDXT][4],
                                           const float* tg, const float* yds,
                                           int mi, int nt, int p0, int cd8,
                                           int gid, int tig) {
  constexpr int kLD = seg_ld(NKT);
  float tf[kDXT][4];
#pragma unroll
  for (int n = 0; n < NKT; ++n) {
    const int col = 16 * mi + 8 * n + 2 * tig;
    const float2 g0 = *reinterpret_cast<const float2*>(tg + col * kLDT + p0);
    const float2 g1 =
        *reinterpret_cast<const float2*>(tg + (col + 1) * kLDT + p0);
    uint32_t ah[4], al[4];
    split_tf32(g0.x, ah[0], al[0]);
    split_tf32(g0.y, ah[1], al[1]);
    split_tf32(g1.x, ah[2], al[2]);
    split_tf32(g1.y, ah[3], al[3]);
#pragma unroll
    for (int u = 0; u < kDXT; ++u) {
      const int jt = min(nt + NKT * u, cd8 - 1);
      const float2 v = *reinterpret_cast<const float2*>(
          yds + (8 * jt + gid) * kLD + col);
      uint32_t bh[2], bl[2];
      split_tf32(v.x, bh[0], bl[0]);
      split_tf32(v.y, bh[1], bl[1]);
      if (n == 0)
        mma_tf32_fresh(tf[u], al, bh);
      else
        mma_tf32(tf[u], al, bh);
      mma_tf32(tf[u], ah, bl);
      mma_tf32(tf[u], ah, bh);
    }
  }
#pragma unroll
  for (int u = 0; u < kDXT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[u][e] += tf[u][e];
}

// (a) NKT: the 8-key tiles of an m-tile's windows, (15 + 2r) / 8 + 1 or
// more (keys past the band get zero weights), and the warps of an m-tile;
// kCD: Cd rounded up to 128 or 256, which sets the dx tiles of a warp
template <int kMode, int NKT, int kCD>
__global__ void __launch_bounds__(64 * NKT, 1)
    query_kernel(const float* __restrict__ x, const float* __restrict__ yd,
                 const float* __restrict__ yv, const float* __restrict__ g,
                 float* wbuf, float* gbuf, float* __restrict__ dx,
                 const Shape s) {
  constexpr int kCols = seg_cols(NKT), kLD = seg_ld(NKT);
  constexpr int kThreads = 64 * NKT;
  constexpr int kDXT = (kCD / 8 + NKT - 1) / NKT;  // dx channel tiles a warp
  extern __shared__ __align__(16) float smem[];
  const int Cd = s.Cd, Cv = s.Cv, H = s.H, W = s.W, r = s.r;
  const int k = 2 * r + 1, kk = k * k;
  const int cd32 = s.cd32, cv32 = s.cv32, cd8 = (Cd + 7) / 8;
  const int w0 = blockIdx.x * kTileW, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int64_t plane = (int64_t)H * W;
  const float* const xb = x + (int64_t)b * Cd * plane;
  const float* const ydb = yd + (int64_t)b * Cd * plane;
  const float* const yvb = yv + (int64_t)b * Cv * plane;
  const float* const gb = g + (int64_t)b * Cv * plane;

  float* const xs = smem;                // [cd32][kLDX]
  float* const gs = xs + cd32 * kLDX;    // [cv32][kLDX]
  float* const yds = gs + cv32 * kLDX;   // [cd32][kLD]
  float* const yvs = yds + cd32 * kLD;   // [kvc][kLD]
  float* const tw = yvs + s.kvc * kLD;   // [kCols][kLDT]: w (softmax pass 1: s)
  float* const tg = tw + kCols * kLDT;   // [kCols][kLDT]: G (softmax pass 1: A)

  // the key rows of the halo inside the image
  const int ky0 = max(0, h - r), ky1 = min(H - 1, h + r);
  const int nrows = ky1 - ky0 + 1;

  {
    const int t = tid % kTileW;
    const bool ok = w0 + t < W;
    const int64_t at = (int64_t)h * W + (ok ? w0 + t : 0);
    for (int c = tid / kTileW; c < cd32; c += kThreads / kTileW)
      cp_async4(smem_addr(xs + c * kLDX + t),
                xb + (int64_t)(c < Cd ? c : 0) * plane + at, ok && c < Cd);
    for (int c = tid / kTileW; c < cv32; c += kThreads / kTileW)
      cp_async4(smem_addr(gs + c * kLDX + t),
                gb + (int64_t)(c < Cv ? c : 0) * plane + at, ok && c < Cv);
    cp_async_commit();
  }
  const auto load_yv = [&](int hy, int stage) {
    const int c0 = stage * s.kvc;
    stage_rows<kCols, kLD, NKT>(yvs, yvb, Cv, c0, min(cv32, c0 + s.kvc), hy,
                                w0, r, W, plane);
    cp_async_commit();
  };
  const auto load_yd = [&](int hy) {
    stage_rows<kCols, kLD, NKT>(yds, ydb, Cd, 0, cd32, hy, w0, r, W, plane);
    cp_async_commit();
  };
  // band tiles <-> scratch: entry (offset dx, position p) at tile column p +
  // dx; rows of positions beyond W are zeros in the tile and not stored
  const auto store_band = [&](int dyo) {
    for (int e = tid; e < k * kTileW; e += kThreads) {
      const int off = e / kTileW, p = e % kTileW;
      if (w0 + p >= W) continue;
      const int64_t at =
          ((int64_t)(b * kk + dyo * k + off) * H + h) * W + w0 + p;
      wbuf[at] = tw[(p + off) * kLDT + p];
      gbuf[at] = tg[(p + off) * kLDT + p];
    }
  };
  const auto load_band = [&](int dyo) {
    for (int e = tid; e < k * kTileW; e += kThreads) {
      const int off = e / kTileW, p = e % kTileW;
      const bool ok = w0 + p < W;
      const int64_t at =
          ((int64_t)(b * kk + dyo * k + off) * H + h) * W + (ok ? w0 + p : 0);
      cp_async4(smem_addr(tw + (p + off) * kLDT + p), wbuf + at, ok);
      cp_async4(smem_addr(tg + (p + off) * kLDT + p), gbuf + at, ok);
    }
  };
  load_yv(ky0, 0);
  load_yd(ky0);

  // warp (mi, nt): m-tile mi, key tile nt (segment columns kc .. kc + 7) of
  // the dots and weights, and dx channel tiles nt, nt + NKT, ...
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int mi = warp / NKT, nt = warp % NKT;
  const int p0 = 16 * mi + 2 * gid;  // positions p0, p0 + 1
  const int kc = 16 * mi + 8 * nt;
  const int col = kc + 2 * tig;      // this lane's key columns col, col + 1

  cp_async_wait<2>();
  __syncthreads();  // the x and g tiles landed
  float x2[2] = {0.0f, 0.0f};
  for (int c = tig; c < cd32; c += 4) {
    const float2 v = *reinterpret_cast<const float2*>(xs + c * kLDX + p0);
    x2[0] = fmaf(v.x, v.x, x2[0]);
    x2[1] = fmaf(v.y, v.y, x2[1]);
  }
  x2[0] = quad_sum(x2[0]);
  x2[1] = quad_sum(x2[1]);

  const float inv_kk = 1.0f / (float)kk;
  float sum_g[2] = {0.0f, 0.0f};  // this lane's part of sum_q G, p0 and p0 + 1
  float run_m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // softmax statistics
  float run_z[2] = {0.0f, 0.0f}, run_za[2] = {0.0f, 0.0f};
  float dxa[kDXT][4];
#pragma unroll
  for (int u = 0; u < kDXT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[u][e] = 0.0f;

  for (int t = 0; t < nrows; ++t) {
    const int hy = ky0 + t, dyo = hy - h + r;
    // 1. A = g . y_val^T over the y_val stages (the first landed already)
    float av[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float unused = 0.0f;
    for (int st = 0; st < s.nvc; ++st) {
      if (st == 0) {
        cp_async_wait<1>();  // this row's y_dist may still be in flight
      } else {
        __syncthreads();  // every warp is done with the previous stage
        load_yv(hy, st);
        cp_async_wait<0>();
      }
      __syncthreads();
      const int c0 = st * s.kvc;
      window_dots<kLD, false>(av, unused, gs + c0 * kLDX + p0,
                              yvs + kc + gid, min(s.kvc, cv32 - c0), tig);
    }
    cp_async_wait<0>();
    __syncthreads();  // y_dist landed; every warp is done with y_val
    if (t + 1 < nrows) load_yv(hy + 1, 0);

    // 2. the distances D = x . y_dist^T and |y|^2 of this lane's keys
    float dv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, y2k[2] = {0.0f, 0.0f};
    if (kMode == kSigmoid) {
      float y2p = 0.0f;  // of key column kc + gid
      window_dots<kLD, true>(dv, y2p, xs + p0, yds + kc + gid, cd32, tig);
      y2p = quad_sum(y2p);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        y2k[e] = __shfl_sync(kFull, y2p, 4 * (2 * tig + e));
    } else {
      // f32 on the CUDA cores (see the head of the file)
#pragma unroll 4
      for (int c = 0; c < cd32; ++c) {
        const float2 xv =
            *reinterpret_cast<const float2*>(xs + c * kLDX + p0);
        const float2 yc =
            *reinterpret_cast<const float2*>(yds + c * kLD + col);
        dv[0] = fmaf(xv.x, yc.x, dv[0]);
        dv[1] = fmaf(xv.x, yc.y, dv[1]);
        dv[2] = fmaf(xv.y, yc.x, dv[2]);
        dv[3] = fmaf(xv.y, yc.y, dv[3]);
        y2k[0] = fmaf(yc.x, yc.x, y2k[0]);
        y2k[1] = fmaf(yc.y, yc.y, y2k[1]);
      }
    }

    // 3. this lane's entries (positions p0 + e / 2, key columns col + e % 2):
    // sigmoid's w and G, or softmax's score and A; zeros off the band
    float wv[4], gv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ro = e / 2, kcol = col + e % 2;
      const int off = kcol - (p0 + ro);
      const bool band = off >= 0 && off <= 2 * r;
      const int kx = w0 - r + kcol;
      const float d = kx >= 0 && kx < W ? (x2[ro] + y2k[e % 2]) - 2.0f * dv[e]
                                        : x2[ro] + kOutOfImage;
      const float a = av[e] * inv_kk;  // 0 outside the image
      if (kMode == kSigmoid) {
        const float sg = __frcp_rn(1.0f + expf(-d));
        const float gr = a * (-2.0f * sg * (1.0f - sg));
        wv[e] = band ? 1.0f - (sg - 0.5f) * 2.0f : 0.0f;
        gv[e] = band ? gr : 0.0f;
        sum_g[ro] += gv[e];
      } else {
        const float sc = softmax_score(d, s.temp);
        wv[e] = band ? sc : 0.0f;
        gv[e] = band ? a : 0.0f;
        if (band) online(run_m[ro], run_z[ro], run_za[ro], sc, a);
      }
    }
    tile_put(tw, col, p0, wv);
    tile_put(tg, col, p0, gv);
    __syncthreads();  // the band tiles are complete
    store_band(dyo);
    // 4. sigmoid: dx += G . y_dist from the same staged row
    if (kMode == kSigmoid)
      dx_product<NKT, kDXT>(dxa, tg, yds, mi, nt, p0, cd8, gid, tig);
    __syncthreads();  // every warp is done with y_dist and the band tiles
    if (t + 1 < nrows) load_yd(hy + 1);
  }

  float* const red = tw;  // cross-warp reductions, the band tiles free
  if (kMode == kSoftmax) {
    // each position's statistics: the quad's, then the m-tile's NKT warps'
    // in order, then the key rows outside the image (|y|^2 = 1e20, A = 0)
#pragma unroll
    for (int ro = 0; ro < 2; ++ro)
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        const float om = __shfl_xor_sync(kFull, run_m[ro], m);
        const float oz = __shfl_xor_sync(kFull, run_z[ro], m);
        const float oza = __shfl_xor_sync(kFull, run_za[ro], m);
        merge(run_m[ro], run_z[ro], run_za[ro], om, oz, oza);
      }
    if (tig == 0)
#pragma unroll
      for (int ro = 0; ro < 2; ++ro) {
        float* const at = red + ((mi * NKT + nt) * 16 + 2 * gid + ro) * 3;
        at[0] = run_m[ro];
        at[1] = run_z[ro];
        at[2] = run_za[ro];
      }
    __syncthreads();
    float wa[2];
#pragma unroll
    for (int ro = 0; ro < 2; ++ro) {
      float m = -CUDART_INF_F, z = 0.0f, za = 0.0f;
      for (int n = 0; n < NKT; ++n) {
        const float* const at = red + ((mi * NKT + n) * 16 + 2 * gid + ro) * 3;
        merge(m, z, za, at[0], at[1], at[2]);
      }
      const int n_out = k - nrows;
      if (n_out > 0)
        merge(m, z, za, softmax_score(x2[ro] + kOutOfImage, s.temp),
              (float)(n_out * k), 0.0f);
      run_m[ro] = m;
      run_z[ro] = z;
      wa[ro] = za / z;
    }
    __syncthreads();  // the statistics are read

    // pass 2: w and G from the stored scores and A, and dx
    for (int t = 0; t < nrows; ++t) {
      const int hy = ky0 + t, dyo = hy - h + r;
      stage_rows<kCols, kLD, NKT>(yds, ydb, Cd, 0, cd32, hy, w0, r, W, plane);
      load_band(dyo);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float sv[4], av[4], wv[4], gv[4];
      tile_get(tw, col, p0, sv);
      tile_get(tg, col, p0, av);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ro = e / 2;
        const int off = col + e % 2 - (p0 + ro);
        const bool band = off >= 0 && off <= 2 * r;
        const float sc = sv[e];
        const float w = expf(sc - run_m[ro]) / run_z[ro];
        const float gr = -s.temp * sc * sc * w * (av[e] - wa[ro]);
        wv[e] = band ? w : 0.0f;
        gv[e] = band ? gr : 0.0f;
        sum_g[ro] += gv[e];
      }
      // each entry is one lane's: read and written by it alone
      tile_put(tw, col, p0, wv);
      tile_put(tg, col, p0, gv);
      __syncthreads();
      store_band(dyo);
      dx_product<NKT, kDXT>(dxa, tg, yds, mi, nt, p0, cd8, gid, tig);
      __syncthreads();  // every warp is done with y_dist and the band tiles
    }
  }

  // sum_q G of each position: the quad's, then the m-tile's warps' in order
#pragma unroll
  for (int ro = 0; ro < 2; ++ro) sum_g[ro] = quad_sum(sum_g[ro]);
  if (tig == 0)
#pragma unroll
    for (int ro = 0; ro < 2; ++ro)
      red[(mi * NKT + nt) * 16 + 2 * gid + ro] = sum_g[ro];
  __syncthreads();
  float sg[2] = {0.0f, 0.0f};
  for (int n = 0; n < NKT; ++n)
#pragma unroll
    for (int ro = 0; ro < 2; ++ro)
      sg[ro] += red[(mi * NKT + n) * 16 + 2 * gid + ro];

  // dx_p = 2 x_p sum_q G - 2 sum_q G y_dist(q): C fragment (positions p0 +
  // e / 2, channels 8 jt + 2 tig + e % 2)
#pragma unroll
  for (int u = 0; u < kDXT; ++u) {
    const int jt = nt + NKT * u;
    if (jt >= cd8) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ro = e / 2, c = 8 * jt + 2 * tig + e % 2, p = p0 + ro;
      if (c < Cd && w0 + p < W)
        dx[((int64_t)b * Cd + c) * plane + (int64_t)h * W + w0 + p] =
            2.0f * xs[c * kLDX + p] * sg[ro] - 2.0f * dxa[u][e];
    }
  }
}

// (b) the key side, chunk z of the outputs: for key q and offset (dy, dx)
// the query is p = q - (dy - r, dx - r), at segment column kc - dx + 2r of
// the staged query row (kc the key's column in the block)
template <int NKT>
__global__ void __launch_bounds__(kKeyThreads, 2)
    key_kernel(const float* __restrict__ x, const float* __restrict__ yd,
               const float* __restrict__ g, const float* __restrict__ wbuf,
               const float* __restrict__ gbuf, float* __restrict__ dyd,
               float* __restrict__ dyv, const Shape s) {
  constexpr int kCols = seg_cols(NKT), kLD = seg_ld(NKT);
  constexpr int kStage = kKC * kLD + kCols * kLDT;  // floats a stage
  extern __shared__ __align__(16) float smem[];
  const int Cd = s.Cd, Cv = s.Cv, H = s.H, W = s.W, r = s.r;
  const int k = 2 * r + 1, kk = k * k;
  const int kw0 = blockIdx.x * kTileW, hk = blockIdx.y;
  const int b = blockIdx.z / s.nz, z = blockIdx.z % s.nz;
  const bool to_d = z < s.nzd;  // dy_dist (G with x), or dy_val (w with g)
  const int C = to_d ? Cd : Cv;
  const int c0 = (to_d ? z : z - s.nzd) * kKC;
  const int tid = threadIdx.x;
  const int64_t plane = (int64_t)H * W;
  const float* const src =
      to_d ? x + (int64_t)b * Cd * plane : g + (int64_t)b * Cv * plane;
  const float* const buf = to_d ? gbuf : wbuf;

  // the query rows of the halo inside the image
  const int ph0 = max(0, hk - r), ph1 = min(H - 1, hk + r);
  const int nrows = ph1 - ph0 + 1;
  // stage: the query row's channel chunk [kKC][kLD], then its band tile
  // [query column][key] of G or w
  const auto load = [&](int stage, int ph) {
    float* const rows = smem + stage * kStage;
    float* const tile = rows + kKC * kLD;
    stage_rows<kCols, kLD, kKeyThreads / kStageCols>(rows, src, C, c0,
                                                     c0 + kKC, ph, kw0, r, W,
                                                     plane);
    const int dyo = hk - ph + r;
    for (int e = tid; e < k * kTileW; e += kKeyThreads) {
      const int off = e / kTileW, kc = e % kTileW;
      const int qc = kw0 + kc - off + r;  // the query's column
      const bool ok = kw0 + kc < W && qc >= 0 && qc < W;
      cp_async4(smem_addr(tile + (kc - off + 2 * r) * kLDT + kc),
                buf + ((int64_t)(b * kk + dyo * k + off) * H + ph) * W +
                    (ok ? qc : 0),
                ok);
    }
    cp_async_commit();
  };

  // warp (mi, cq): keys kc0, kc0 + 1 (MMA rows gid, gid + 8) of m-tile mi,
  // chunk channels 32 cq .. 32 cq + 31
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int mi = warp / 4, cq = warp % 4;
  const int kc0 = 16 * mi + 2 * gid;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float sum_g[2] = {0.0f, 0.0f};  // sum_p G of keys kc0, kc0 + 1

  load(0, ph0);
  for (int t = 0; t < nrows; ++t) {
    if (t + 1 < nrows) {
      load((t + 1) % 2, ph0 + t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // row t landed
    const float* const rows = smem + (t % 2) * kStage;
    const float* const tile = rows + kKC * kLD;
    float tf[4][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      // queries q, q + 1 (K slots tig, tig + 4); the band: kc <= q <= kc + 2r
      const int q = 16 * mi + 8 * n + 2 * tig;
      const float2 t0 = *reinterpret_cast<const float2*>(tile + q * kLDT + kc0);
      const float2 t1 =
          *reinterpret_cast<const float2*>(tile + (q + 1) * kLDT + kc0);
      float a[4];
      a[0] = q >= kc0 && q <= kc0 + 2 * r ? t0.x : 0.0f;
      a[1] = q >= kc0 + 1 && q <= kc0 + 1 + 2 * r ? t0.y : 0.0f;
      a[2] = q + 1 >= kc0 && q + 1 <= kc0 + 2 * r ? t1.x : 0.0f;
      a[3] = q + 1 >= kc0 + 1 && q + 1 <= kc0 + 1 + 2 * r ? t1.y : 0.0f;
      sum_g[0] += a[0] + a[2];
      sum_g[1] += a[1] + a[3];
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const float2 v = *reinterpret_cast<const float2*>(
            rows + (32 * cq + 8 * jn + gid) * kLD + q);
        uint32_t bh[2], bl[2];
        split_tf32(v.x, bh[0], bl[0]);
        split_tf32(v.y, bh[1], bl[1]);
        if (n == 0)
          mma_tf32_fresh(tf[jn], al, bh);
        else
          mma_tf32(tf[jn], al, bh);
        mma_tf32(tf[jn], ah, bl);
        mma_tf32(tf[jn], ah, bh);
      }
    }
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jn][e] += tf[jn][e];
    __syncthreads();  // every warp is done with this stage
  }

  sum_g[0] = quad_sum(sum_g[0]);
  sum_g[1] = quad_sum(sum_g[1]);
  const float inv_kk = 1.0f / (float)kk;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kc0 + e / 2;
      const int ch = c0 + 32 * cq + 8 * jn + 2 * tig + e % 2;
      if (kw0 + key >= W || ch >= C) continue;
      const int64_t at =
          ((int64_t)b * C + ch) * plane + (int64_t)hk * W + kw0 + key;
      if (to_d)
        dyd[at] = 2.0f * yd[at] * sum_g[e / 2] - 2.0f * acc[jn][e];
      else
        dyv[at] = acc[jn][e] * inv_kk;
    }
}

// (c) nearest, one block kNearKR rows of 32 keys and 32 channels (the
// channels split over blocks, so that a crowded key's work runs on several
// SMs).  A key's picks in ascending offset order are its picking queries in
// descending position (query = key - (dy - r, dx - r)), so:
// (1) each query of the halo that can pick one of the keys (rows hk0 - r ..
// hk0 + kNearKR - 1 + r, columns w0 - r .. w0 + 31 + r: a warp a row, a lane
// a column) is read once, coalesced, sets bit o of its key's mask (an OR:
// no order) and, if it picked one, takes a slot: its rank among the picking
// queries in position order (ballots, and a scan of their counts).
// (2) Warp i counts the picks of key row i a mask word and scans them over
// the keys, so each picking query writes its slot to its place in a list
// that holds every key's picks in ascending offset order, that is, in
// descending slot order.  (3) g is staged kNearE slots at a time, highest
// slots first, by cp.async into kNearBufs buffers (the next stage's copies
// fly while this one is added up), a warp a channel, the lanes along the
// slots: neighbouring slots are neighbouring picked queries, so the loads
// coalesce as far as the picks are dense.  (4) A warp a key with picks, a
// lane a channel, adds the staged values from 0.0f in list order (the plain
// version's order, so the two are equal), 8 or 32 slots at a time, their
// loads before their adds, resuming where the last stage left it: a running
// sum in a [channel][key] tile.  (5) The tile leaves as rows over 32 keys
// (zeros for a key without picks).
constexpr int kNearThreads = 512;
constexpr int kNearWarps = kNearThreads / 32;
constexpr int kNearKR = 8;                       // key rows a block
constexpr int kNearKeys = kNearKR * kTileW;      // keys a block
constexpr int kNearRows =                        // halo rows a warp
    (kNearKR + 2 * kMaxR + kNearWarps - 1) / kNearWarps;
constexpr int kNearCols = (kTileW + 2 * kMaxR + 31) / 32;  // columns a lane
constexpr int kNearGroups = kNearRows * kNearWarps * kNearCols;  // ballots
constexpr int kNearWords = ((2 * kMaxR + 1) * (2 * kMaxR + 1) + 31) / 32;
constexpr int kNearCh = 32;                // channels a block: a lane each
constexpr int kNearE = 128;                // slots a stage
constexpr int kNearBufs = 2;               // stages in flight, this one too
constexpr int kNearLD = kNearE + 1;        // stage row: odd, no bank conflict
constexpr int kNearTLD = kNearKeys + 1;    // tile row
static_assert(kNearKR < kNearWarps && kNearKeys <= 1 << 15 &&
                  kNearGroups <= 4 * 32,
              "a warp scans a key row and one more the ballots' counts; a "
              "pick packs its key in 15 bits");

__host__ __device__ constexpr int near_list_len(int r) {
  return (kNearKR + 2 * r) * (kTileW + 2 * r);
}

// acc plus the staged values at the first n of the slots that lanes 0..N-1
// hold in ``at``, in lane order: all N loads before the adds (a key with a
// few picks takes the short batch)
template <int N>
__device__ __forceinline__ float add_slots(float acc, const float* row,
                                           int at, int n) {
  float v[N];
#pragma unroll
  for (int u = 0; u < N; ++u) v[u] = row[__shfl_sync(kFull, at, u)];
#pragma unroll
  for (int u = 0; u < N; ++u)
    if (u < n) acc += v[u];
  return acc;
}

__global__ void __launch_bounds__(kNearThreads)
    nearest_kernel(const int* __restrict__ idx, const float* __restrict__ g,
                   float* __restrict__ dyv, const Shape s) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int n_keys, row_picks[kNearKR], row_keys[kNearKR];
  __shared__ int group_at[kNearGroups];  // the first slot of each ballot
  const int Cv = s.Cv, H = s.H, W = s.W, r = s.r;
  const int k = 2 * r + 1, kk = k * k, nw = (kk + 31) / 32;
  const float inv_k = 1.0f / (float)k;
  const int groups = (Cv + kNearCh - 1) / kNearCh;
  const int w0 = blockIdx.x * kTileW, hk0 = blockIdx.y * kNearKR;
  const int n_kr = min(kNearKR, H - hk0);
  const int b = blockIdx.z / groups, c0 = blockIdx.z % groups * kNearCh;
  const int n_ch = min(kNearCh, Cv - c0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const int64_t plane = (int64_t)H * W;
  float* const tile = smem;                        // [kNearCh][kNearTLD]
  // [kNearBufs][kNearCh][kNearLD]
  float* const stage = tile + kNearCh * kNearTLD;
  // [nw][kNearKeys]: bit o of a key's mask says the query at offset o
  // picked it
  unsigned* const mask =
      reinterpret_cast<unsigned*>(stage + kNearBufs * kNearCh * kNearLD);
  // [nw][kNearKeys]: a key's picks in the mask words before this one
  int* const before = reinterpret_cast<int*>(mask + nw * kNearKeys);
  int* const keys = before + nw * kNearKeys;  // the keys with picks
  int* const start = keys + kNearKeys;  // key kt's list: start[kt..kt+1)
  int* const next = start + kNearKeys + 1;  // its first entry not yet added
  int* const list = next + kNearKeys;       // [near_list_len(r)]: slots
  int* const where = list + near_list_len(s.r);  // a slot's plane offset

  // (1) the halo's picks of this block's keys, and their slots
  for (int e = threadIdx.x; e < nw * kNearKeys; e += kNearThreads)
    mask[e] = 0u;
  const int q_h0 = max(hk0 - r, 0), q_h1 = min(hk0 + n_kr - 1 + r, H - 1);
  const int q_w0 = max(w0 - r, 0), q_w1 = min(w0 + kTileW - 1 + r, W - 1);
  const int* const idx_b = idx + (int64_t)b * plane;
  int pick[kNearRows][kNearCols];  // (key << 16) | offset, or -1: none here
  int slot[kNearRows][kNearCols];  // rank within its ballot, then its slot
#pragma unroll
  for (int i = 0; i < kNearRows; ++i)
#pragma unroll
    for (int j = 0; j < kNearCols; ++j) {
      const int qh = q_h0 + warp + kNearWarps * i, qw = q_w0 + lane + 32 * j;
      pick[i][j] = qh <= q_h1 && qw <= q_w1 ? idx_b[(int64_t)qh * W + qw] : -1;
    }
  __syncthreads();  // the masks are zero
#pragma unroll
  for (int i = 0; i < kNearRows; ++i)
#pragma unroll
    for (int j = 0; j < kNearCols; ++j) {
      const int qh = q_h0 + warp + kNearWarps * i, qw = q_w0 + lane + 32 * j;
      const int o = pick[i][j];
      // o / k exactly: (o + 0.5) / k lies at least 0.5 / k from an integer
      const int dy = __float2int_rz(((float)o + 0.5f) * inv_k);
      const int kr = qh + dy - r - hk0, t = qw + o - dy * k - r - w0;
      const bool mine = o >= 0 && o < kk && kr >= 0 && kr < n_kr && t >= 0 &&
                        t < kTileW && w0 + t < W;
      const unsigned ballot = __ballot_sync(kFull, mine);
      if (lane == 0)
        group_at[(i * kNearWarps + warp) * kNearCols + j] = __popc(ballot);
      slot[i][j] = __popc(ballot & below);
      pick[i][j] = -1;
      if (!mine) continue;
      const int kt = kr * kTileW + t;
      pick[i][j] = (kt << 16) | o;
      atomicOr(&mask[(o / 32) * kNearKeys + kt], 1u << (o % 32));
    }
  __syncthreads();

  // (2) each key's place in the list and the keys with picks (warp i: key
  // row i), and the first slot of each ballot (warp kNearKR)
  int n = 0, upto = 0;
  unsigned has = 0u;
  if (warp < kNearKR) {
    const int kt = warp * kTileW + lane;
#pragma unroll
    for (int word = 0; word < kNearWords; ++word)
      if (word < nw) {
        before[word * kNearKeys + kt] = n;
        n += __popc(mask[word * kNearKeys + kt]);
      }
    upto = n;  // inclusive scan over the row's keys
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(kFull, upto, d);
      if (lane >= d) upto += v;
    }
    has = __ballot_sync(kFull, n > 0);
    if (lane == 31) {
      row_picks[warp] = upto;
      row_keys[warp] = __popc(has);
    }
  } else if (warp == kNearKR) {
    int c[4], sum = 0;  // a lane's 4 ballots, in position order
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c[e] = 4 * lane + e < kNearGroups ? group_at[4 * lane + e] : 0;
      sum += c[e];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    int at = incl - sum;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * lane + e < kNearGroups) {
        group_at[4 * lane + e] = at;
        at += c[e];
      }
  }
  __syncthreads();
  if (warp < kNearKR) {
    const int kt = warp * kTileW + lane;
    int picks_before = 0, keys_before = 0;
    for (int w = 0; w < warp; ++w) {
      picks_before += row_picks[w];
      keys_before += row_keys[w];
    }
    start[kt] = next[kt] = picks_before + upto - n;
    if (n > 0) keys[keys_before + __popc(has & below)] = kt;
    if (kt == kNearKeys - 1) {
      start[kNearKeys] = picks_before + upto;
      n_keys = keys_before + __popc(has);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kNearRows; ++i)
#pragma unroll
    for (int j = 0; j < kNearCols; ++j) {
      if (pick[i][j] < 0) continue;
      const int kt = pick[i][j] >> 16, o = pick[i][j] & 0xffff;
      const int at = (o / 32) * kNearKeys + kt;
      const int sl =
          group_at[(i * kNearWarps + warp) * kNearCols + j] + slot[i][j];
      // ascending offsets, descending slots: the later offsets first
      list[start[kt] + before[at] +
           __popc(mask[at] & ((1u << (o % 32)) - 1u))] = sl;
      where[sl] = (q_h0 + warp + kNearWarps * i) * W + q_w0 + lane + 32 * j;
    }
  __syncthreads();

  // (3) stage g, highest slots first, by cp.async into kNearBufs buffers:
  // the next stages' copies fly while this one is added up; (4) add it up
  // in list order
  const float* const g_b = g + ((int64_t)b * Cv + c0) * plane;
  const int n_slots = start[kNearKeys];
  // the stage of slots [hi - kNearE, hi) into its buffer (none: an empty
  // group, so that every stage counts one)
  auto fetch = [&](int hi, int q) {
    float* const buf = stage + q % kNearBufs * kNearCh * kNearLD;
    const int lo = max(hi - kNearE, 0);
    for (int c = warp; c < n_ch && hi > 0; c += kNearWarps)
      for (int e = lane; e < hi - lo; e += 32)
        cp_async4(smem_addr(buf + c * kNearLD + e),
                  g_b + c * plane + where[lo + e], true);
    cp_async_commit();
  };
  for (int q = 0; q < kNearBufs - 1; ++q) fetch(n_slots - q * kNearE, q);
  for (int hi = n_slots, q = 0; hi > 0; hi -= kNearE, ++q) {
    const int lo = max(hi - kNearE, 0);
    fetch(hi - (kNearBufs - 1) * kNearE, q + kNearBufs - 1);
    cp_async_wait<kNearBufs - 1>();
    __syncthreads();
    const float* const row =
        stage + q % kNearBufs * kNearCh * kNearLD + lane * kNearLD - lo;
    for (int item = warp; item < n_keys; item += kNearWarps) {
      const int kt = keys[item], top = start[kt + 1];
      int e = next[kt];
      if (e == top) continue;
      float acc = e == start[kt] ? 0.0f : tile[lane * kNearTLD + kt];
      // batches of 32 slots, one a lane, handed round by shuffles; a key's
      // slots descend, so this stage's are a prefix of what is left
      int mine = e + lane < top ? list[e + lane] : -1;
      for (;;) {
        const int n_e = __popc(__ballot_sync(kFull, mine >= lo));
        const int later =
            n_e == 32 && e + 32 + lane < top ? list[e + 32 + lane] : -1;
        const int at = max(mine, lo);
        acc = n_e <= 8 ? add_slots<8>(acc, row, at, n_e)
                       : add_slots<32>(acc, row, at, n_e);
        e += n_e;
        if (n_e < 32) break;
        mine = later;
      }
      tile[lane * kNearTLD + kt] = acc;
      if (lane == 0) next[kt] = e;
    }
    __syncthreads();  // this buffer is free for a later stage
  }

  // (5) the rows of dy_val
  if (w0 + lane < W)
    for (int kr = 0; kr < n_kr; ++kr) {
      const int kt = kr * kTileW + lane;
      const bool picked = start[kt + 1] > start[kt];
      for (int c = warp; c < n_ch; c += kNearWarps)
        dyv[((int64_t)b * Cv + c0 + c) * plane + (int64_t)(hk0 + kr) * W +
            w0 + lane] = picked ? tile[c * kNearTLD + kt] : 0.0f;
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

// the query side: the resident tiles, the y_dist row and the band tiles
// first; the y_val stage takes what is left of the shared memory, in
// multiples of 32 channels (all of Cv when it fits)
template <int kMode, int NKT, int kCD>
cudaError_t launch_query(const float* x, const float* yd, const float* yv,
                         const float* g, float* wbuf, float* gbuf, float* dx,
                         Shape s, dim3 grid, cudaStream_t st) {
  constexpr int kLD = seg_ld(NKT);
  const long fixed = (long)(s.cd32 + s.cv32) * kLDX + (long)s.cd32 * kLD +
                     2L * seg_cols(NKT) * kLDT;
  const long left = kMaxSmem / (long)sizeof(float) - fixed;
  const int kvc = (int)(left > 0 ? left / kLD / 32 * 32 : 0);
  if (kvc < 32) return cudaErrorInvalidValue;
  s.kvc = kvc < s.cv32 ? kvc : s.cv32;
  s.nvc = (s.cv32 + s.kvc - 1) / s.kvc;
  const size_t bytes = sizeof(float) * (size_t)(fixed + (long)s.kvc * kLD);
  const auto kernel = query_kernel<kMode, NKT, kCD>;
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 64 * NKT, bytes, st>>>(x, yd, yv, g, wbuf, gbuf, dx, s);
  return cudaGetLastError();
}

template <int NKT>
cudaError_t launch_key(const float* x, const float* yd, const float* g,
                       const float* wbuf, const float* gbuf, float* dyd,
                       float* dyv, const Shape s, dim3 grid,
                       cudaStream_t st) {
  const size_t bytes = sizeof(float) * 2 *
                       (size_t)(kKC * seg_ld(NKT) + seg_cols(NKT) * kLDT);
  const cudaError_t err = prepare(key_kernel<NKT>, bytes);
  if (err != cudaSuccess) return err;
  key_kernel<NKT><<<grid, kKeyThreads, bytes, st>>>(x, yd, g, wbuf, gbuf, dyd,
                                                     dyv, s);
  return cudaGetLastError();
}

template <int kMode>
int launch_smooth(const void* x, const void* yd, const void* yv,
                  const void* g, void* wbuf, void* gbuf, void* dx, void* dyd,
                  void* dyv, int B, int Cd, int Cv, int H, int W, int r,
                  float temp, void* stream) {
  if (bad_shape(B, Cd, Cv, H, W, r) || Cd > kMaxCd)
    return (int)cudaErrorInvalidValue;
  Shape s{Cd, Cv, H, W, r, 0, 0, 0, 0, 0, 0, temp};
  s.cd32 = (Cd + 31) / 32 * 32;
  s.cv32 = (Cv + 31) / 32 * 32;
  s.nzd = (Cd + kKC - 1) / kKC;
  s.nz = s.nzd + (Cv + kKC - 1) / kKC;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* ydf = static_cast<const float*>(yd);
  const auto* yvf = static_cast<const float*>(yv);
  const auto* gf = static_cast<const float*>(g);
  auto* wf = static_cast<float*>(wbuf);
  auto* gbf = static_cast<float*>(gbuf);
  // an m-tile's windows reach (15 + 2r) / 8 + 1 key tiles: 5 up to r = 12
  // (our_warp's r = 10), 6 beyond
  const bool wide = (15 + 2 * r) / 8 + 1 > 5;
  const bool narrow_cd = s.cd32 <= 128;
  const dim3 qgrid((W + kTileW - 1) / kTileW, H, B);
  cudaError_t err;
  auto* dxf = static_cast<float*>(dx);
  if (wide)
    err = narrow_cd ? launch_query<kMode, 6, 128>(xf, ydf, yvf, gf, wf, gbf,
                                                  dxf, s, qgrid, st)
                    : launch_query<kMode, 6, 256>(xf, ydf, yvf, gf, wf, gbf,
                                                  dxf, s, qgrid, st);
  else
    err = narrow_cd ? launch_query<kMode, 5, 128>(xf, ydf, yvf, gf, wf, gbf,
                                                  dxf, s, qgrid, st)
                    : launch_query<kMode, 5, 256>(xf, ydf, yvf, gf, wf, gbf,
                                                  dxf, s, qgrid, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 kgrid((W + kTileW - 1) / kTileW, H, B * s.nz);
  auto* dydf = static_cast<float*>(dyd);
  auto* dyvf = static_cast<float*>(dyv);
  err = wide ? launch_key<6>(xf, ydf, gf, wf, gbf, dydf, dyvf, s, kgrid, st)
             : launch_key<5>(xf, ydf, gf, wf, gbf, dydf, dyvf, s, kgrid, st);
  return (int)err;
}

}  // namespace

// Each returns cudaGetLastError() after its launches (0 on success), or
// cudaErrorInvalidValue outside r <= 15, Cd <= 256 or the shared memory a
// block may use (the query side holds g's Cv x 32 columns: Cv up to about
// 500 at Cd 256, r <= 12).  wbuf and gbuf: [B, (2r+1)^2, H, W] f32 scratch;
// x, y_dist, dx, dy_dist [B, Cd, H, W]; y_val, g, dy_val [B, Cv, H, W]; idx
// int32 [B, H, W].
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
  const Shape s{1, Cv, H, W, r, 0, 0, 0, 0, 0, 0, 0.0f};
  const int nw = ((2 * r + 1) * (2 * r + 1) + 31) / 32;
  // the tile and the stage; the masks and their counts; the keys, their
  // starts and where they resume; the list and the slots' offsets
  const size_t bytes =
      sizeof(float) * kNearCh * (kNearTLD + kNearBufs * kNearLD) +
      sizeof(int) *
          (size_t)((2 * nw + 3) * kNearKeys + 1 + 2 * near_list_len(r));
  const cudaError_t err = prepare(nearest_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kNearKR - 1) / kNearKR,
                  B * ((Cv + kNearCh - 1) / kNearCh));
  nearest_kernel<<<grid, kNearThreads, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(g),
      static_cast<float*>(dy_val), s);
  return (int)cudaGetLastError();
}
