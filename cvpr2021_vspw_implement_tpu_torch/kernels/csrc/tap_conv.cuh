// Tiled f32 tap-convolution for Hopper (sm_90a): the device routine shared by
// the RAFT update-block kernels (sep_gru.cu, motion_encoder.cu,
// gru_flowhead.cu).
//
// A stride-1, zero-padded KH x KW convolution of an NCHW input is a matrix
// product over K = taps x input channels.  The input may be the channel
// concat of two tensors a [B, ca, H, W] and b [B, cb, H, W] (so [h | x],
// [r*h | x] and cat(cor, flo) are never materialised); weights are
// [KH*KW, ca + cb, cout] (tap row-major, input channel, output channel).  The
// output goes to channels [out_coff, out_coff + cout) of a [B, out_ctotal, H,
// W] tensor, so a concat of two convolutions' outputs costs nothing either.
//
// A block computes 64 x-consecutive positions of one row (fixed b, y) by 64
// output channels.  Each step stages 16 input channels of the 64 positions
// shifted by one tap, and the matching 16x64 weight block, in shared memory;
// every thread accumulates a 4x4 register tile with f32 FMAs (the precision
// of the plain PyTorch version; no tensor cores yet).  Every tap shape reads
// rows of x-consecutive positions, so loads and stores are coalesced for
// 1x5, 5x1, 3x3 and 1x1 alike.  Taps outside the image, channels past ca +
// cb and output channels past cout are predicated to zero, so no size needs
// to be a multiple of the tile.
//
// Epilogues (all after the bias): relu; the GRU gate (sigmoid, z to its own
// buffer and r*h to out); the GRU blend (tanh, h' = (1-z)*h + z*q).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tapconv {

constexpr int kTM = 64;   // positions per tile (along x)
constexpr int kTN = 64;   // output channels per tile
constexpr int kTK = 16;   // input channels per step
constexpr int kThreads = 256;

enum Epilogue { kRelu = 0, kGate = 1, kBlend = 2 };

struct Args {
  const float* a;  // first input  [B, ca, H, W]
  int ca;
  const float* b;  // second input [B, cb, H, W], channel-concatenated after a
  int cb;
  const float* wgt;   // [KH*KW, ca + cb, cout]
  const float* bias;  // [cout]
  int cout;           // kGate: 2*hd (z then r); kBlend: hd
  float* out;         // [B, out_ctotal, H, W]; kGate: r*h; kBlend: h'
  int out_ctotal;
  int out_coff;
  const float* h;  // kGate, kBlend: the old hidden state [B, hd, H, W]
  float* z;        // kGate: written; kBlend: read          [B, hd, H, W]
  int H;
  int W;
};

template <int KH, int KW, int EPI>
__global__ void __launch_bounds__(kThreads) tap_conv_kernel(const Args p) {
  __shared__ float As[kTK][kTM];
  __shared__ float Bs[kTK][kTN];

  const int cin = p.ca + p.cb;
  const int cout = p.cout;
  const int H = p.H, W = p.W;
  const int n_tiles = (cout + kTN - 1) / kTN;
  const int x0 = blockIdx.x * kTM;
  const int y = blockIdx.y;
  const int b = blockIdx.z / n_tiles;
  const int n0 = (blockIdx.z % n_tiles) * kTN;
  const int tid = threadIdx.x;
  const int tm = tid % 16;  // positions tm + 16*i
  const int tn = tid / 16;  // channels n0 + 4*tn + j
  const int64_t plane = (int64_t)H * W;
  const float* ab = p.a + (int64_t)b * p.ca * plane;
  const float* bb = p.cb > 0 ? p.b + (int64_t)b * p.cb * plane : nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < KH * KW; ++k) {
    const int dy = k / KW - KH / 2;
    const int dx = k % KW - KW / 2;
    const int yy = y + dy;
    const bool row_ok = yy >= 0 && yy < H;
    for (int c0 = 0; c0 < cin; c0 += kTK) {
#pragma unroll
      for (int e = tid; e < kTK * kTM; e += kThreads) {
        const int c = c0 + e / kTM;
        const int xx = x0 + e % kTM + dx;
        float v = 0.0f;
        if (row_ok && xx >= 0 && xx < W && c < cin) {
          const int64_t off = (int64_t)yy * W + xx;
          v = c < p.ca ? ab[(int64_t)c * plane + off]
                       : bb[(int64_t)(c - p.ca) * plane + off];
        }
        As[e / kTM][e % kTM] = v;
      }
#pragma unroll
      for (int e = tid; e < kTK * kTN; e += kThreads) {
        const int c = c0 + e / kTN;
        const int n = n0 + e % kTN;
        Bs[e / kTN][e % kTN] =
            (c < cin && n < cout) ? p.wgt[((int64_t)k * cin + c) * cout + n]
                                  : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kTK; ++c) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[c][tm + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = Bs[c][4 * tn + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int hd = EPI == kGate ? cout / 2 : cout;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 4 * tn + j;
    if (n >= cout) continue;
    const float bn = p.bias[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int xx = x0 + tm + 16 * i;
      if (xx >= W) continue;
      const float v = acc[i][j] + bn;
      const int64_t pos = (int64_t)y * W + xx;
      if (EPI == kGate) {
        const float s = 1.0f / (1.0f + expf(-v));
        if (n < hd) {
          p.z[((int64_t)b * hd + n) * plane + pos] = s;
        } else {
          const int64_t idx = ((int64_t)b * hd + (n - hd)) * plane + pos;
          p.out[idx] = s * p.h[idx];
        }
      } else if (EPI == kBlend) {
        const int64_t idx = ((int64_t)b * hd + n) * plane + pos;
        const float zz = p.z[idx];
        p.out[idx] = (1.0f - zz) * p.h[idx] + zz * tanhf(v);
      } else {
        const int64_t idx =
            ((int64_t)b * p.out_ctotal + p.out_coff + n) * plane + pos;
        p.out[idx] = fmaxf(v, 0.0f);
      }
    }
  }
}

// Launches one convolution on ``stream``; returns cudaGetLastError().
template <int KH, int KW, int EPI>
inline cudaError_t launch(const Args& p, int B, cudaStream_t stream) {
  const int n_tiles = (p.cout + kTN - 1) / kTN;
  const dim3 grid((p.W + kTM - 1) / kTM, p.H, B * n_tiles);
  tap_conv_kernel<KH, KW, EPI><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// One separable GRU pass (KH x KW = 1x5 or 5x1): the gate launch writes z and
// r*h, the blend launch reads r*h in place of h (it needs r*h at all 5
// neighbours, hence the launch boundary) and writes the new hidden state.
template <int KH, int KW>
inline cudaError_t gru_pass(const float* h, const float* x, const float* wzr,
                            const float* bzr, const float* wq,
                            const float* bq, float* z, float* rh, float* out,
                            int B, int H, int W, int HD, int CX,
                            cudaStream_t stream) {
  Args g{h, HD, x, CX, wzr, bzr, 2 * HD, rh, HD, 0, h, z, H, W};
  cudaError_t rc = launch<KH, KW, kGate>(g, B, stream);
  if (rc != cudaSuccess) return rc;
  Args q{rh, HD, x, CX, wq, bq, HD, out, HD, 0, h, z, H, W};
  return launch<KH, KW, kBlend>(q, B, stream);
}

}  // namespace tapconv
