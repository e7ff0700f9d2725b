// One separable ConvGRU pass of RAFT's update block for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel cvpr2021_vspw_implement_tpu/ops/pallas/gru.py::
// sep_conv_gru_pass (kernel _gru_pass_kernel).  With [h | x] the channel
// concat of the hidden state h [B, HD, H, W] and the input x [B, CX, H, W]
// (NCHW, contiguous), one pass computes
//     z|r = sigmoid(conv5([h | x]) + bzr)
//     q   = tanh(conv5([r*h | x]) + bq)
//     h'  = (1 - z) * h + z * q
// where conv5 is a 5-tap convolution along W (axis 0, the 1x5 pass) or along
// H (axis 1, the 5x1 pass), zero padded by 2.  Weights are [5, CIN, COUT]
// (tap, input channel, output channel), CIN = HD + CX.
//
// Bound on this card: operations.  At the TC shape (P = 60*107 = 6420
// positions, HD = 128, CX = 256) a pass is 2*P*5*384*(256+128) = 9.5 GFLOP
// against about 16 MB of traffic, so the floor is 0.14 ms at the 67 TFLOP/s
// float32 rate of the CUDA cores (f32 FMA, the precision of the plain
// version; tensor cores are for a later version).
//
// Design: q needs r*h at the 5 neighbours of each position, so the pass is
// two launches of one tiled kernel.  The gate launch writes z and r*h to
// scratch that the caller allocates; the q launch reads r*h in place of h
// and fuses tanh and the blend into its epilogue.  A block computes a tile
// of 64 consecutive positions of one row (fixed b, y) by 64 output
// channels as a small matrix product over K = 5 taps x CIN channels.  Each
// step stages 16 input channels of the 64 shifted positions of one tap and
// the matching 16x64 weight block in shared memory; every thread then
// accumulates a 4x4 register tile.  Both axes read rows of x-consecutive
// positions (the 5x1 pass shifts the row, the 1x5 pass the column), so
// loads and stores are coalesced and neither pass needs a transpose.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTM = 64;   // positions per tile (along x)
constexpr int kTN = 64;   // output channels per tile
constexpr int kTK = 16;   // input channels per step
constexpr int kTaps = 5;
constexpr int kThreads = 256;

template <bool kGate>
__global__ void __launch_bounds__(kThreads)
sep_gru_kernel(const float* __restrict__ hpart,  // h (gate) or r*h (q)
               const float* __restrict__ x, const float* __restrict__ wgt,
               const float* __restrict__ bias,
               const float* __restrict__ h,  // q launch: the old hidden state
               float* __restrict__ z,        // gate: written; q: read
               float* __restrict__ out,      // gate: r*h; q: the new h
               int H, int W, int HD, int CX, int axis) {
  __shared__ float As[kTK][kTM];
  __shared__ float Bs[kTK][kTN];

  const int cin = HD + CX;
  const int cout = kGate ? 2 * HD : HD;
  const int n_tiles = cout / kTN;
  const int x0 = blockIdx.x * kTM;
  const int y = blockIdx.y;
  const int b = blockIdx.z / n_tiles;
  const int n0 = (blockIdx.z % n_tiles) * kTN;
  const int tid = threadIdx.x;
  const int tm = tid % 16;  // positions tm + 16*i
  const int tn = tid / 16;  // channels n0 + 4*tn + j
  const int64_t plane = (int64_t)H * W;
  const float* hb = hpart + (int64_t)b * HD * plane;
  const float* xb = x + (int64_t)b * CX * plane;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < kTaps; ++k) {
    const int dy = axis == 1 ? k - 2 : 0;
    const int dx = axis == 0 ? k - 2 : 0;
    const int yy = y + dy;
    const bool row_ok = yy >= 0 && yy < H;
    for (int c0 = 0; c0 < cin; c0 += kTK) {
#pragma unroll
      for (int e = tid; e < kTK * kTM; e += kThreads) {
        const int c = c0 + e / kTM;
        const int xx = x0 + e % kTM + dx;
        float v = 0.0f;
        if (row_ok && xx >= 0 && xx < W) {
          const int64_t off = (int64_t)yy * W + xx;
          v = c < HD ? hb[(int64_t)c * plane + off]
                     : xb[(int64_t)(c - HD) * plane + off];
        }
        As[e / kTM][e % kTM] = v;
      }
#pragma unroll
      for (int e = tid; e < kTK * kTN; e += kThreads) {
        const int c = c0 + e / kTN;
        Bs[e / kTN][e % kTN] =
            wgt[((int64_t)k * cin + c) * cout + n0 + e % kTN];
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

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 4 * tn + j;
    const float bn = bias[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int xx = x0 + tm + 16 * i;
      if (xx >= W) continue;
      const float v = acc[i][j] + bn;
      const int64_t pos = (int64_t)y * W + xx;
      if (kGate) {
        const float s = 1.0f / (1.0f + expf(-v));
        if (n < HD) {
          z[((int64_t)b * HD + n) * plane + pos] = s;
        } else {
          const int64_t idx = ((int64_t)b * HD + (n - HD)) * plane + pos;
          out[idx] = s * h[idx];
        }
      } else {
        const int64_t idx = ((int64_t)b * HD + n) * plane + pos;
        const float zz = z[idx];
        out[idx] = (1.0f - zz) * h[idx] + zz * tanhf(v);
      }
    }
  }
}

bool shapes_ok(int HD, int CX) {
  return HD > 0 && HD % kTN == 0 && (HD + CX) % kTK == 0 && CX >= 0;
}

}  // namespace

// Gate launch: z = sigmoid(conv_z), rh = sigmoid(conv_r) * h.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sep_gru_gate_f32(const void* h, const void* x, const void* wzr,
                                const void* bzr, void* z, void* rh, int B,
                                int H, int W, int HD, int CX, int axis,
                                void* stream) {
  if (!shapes_ok(HD, CX) || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTM - 1) / kTM, H, B * (2 * HD / kTN));
  sep_gru_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(x),
      static_cast<const float*>(wzr), static_cast<const float*>(bzr),
      static_cast<const float*>(h), static_cast<float*>(z),
      static_cast<float*>(rh), H, W, HD, CX, axis);
  return (int)cudaGetLastError();
}

// q launch: out = (1 - z) * h + z * tanh(conv_q([rh | x])).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sep_gru_q_f32(const void* rh, const void* x, const void* wq,
                             const void* bq, const void* h, const void* z,
                             void* out, int B, int H, int W, int HD, int CX,
                             int axis, void* stream) {
  if (!shapes_ok(HD, CX) || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTM - 1) / kTM, H, B * (HD / kTN));
  sep_gru_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rh), static_cast<const float*>(x),
      static_cast<const float*>(wq), static_cast<const float*>(bq),
      static_cast<const float*>(h),
      const_cast<float*>(static_cast<const float*>(z)),
      static_cast<float*>(out), H, W, HD, CX, axis);
  return (int)cudaGetLastError();
}
