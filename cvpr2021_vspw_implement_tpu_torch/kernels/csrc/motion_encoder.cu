// RAFT's BasicMotionEncoder for Hopper (sm_90a), f32, one C entry point.
//
// Replaces the TPU kernel cvpr2021_vspw_implement_tpu/ops/pallas/
// raft_update.py::motion_encoder_fused (kernel _motion_kernel).  NCHW:
//     cor = relu(convc2_3x3(relu(convc1_1x1(corr))))        CK -> 256 -> 192
//     flo = relu(convf2_3x3(relu(convf1_7x7(flow))))         2 -> 128 -> 64
//     out = cat(relu(conv_3x3(cat(cor, flo))), flow)       256 -> 126 (+2)
// Weights are [taps, cin, cout] (tap row-major).
//
// Bound on this card: operations.  At the training shape (P = 60*60
// positions, CK = 324) the chain is 2*P*(324*256 + 9*256*192 + 98*128 +
// 9*128*64 + 9*256*126) = 6.49 GFLOP per image against about 12 MB of
// traffic: 0.097 ms at the 67 TFLOP/s float32 rate of the CUDA cores.
//
// Design.  The TPU kernel keeps the whole [H*W, C] tile of every stage in
// on-chip memory; a thread block here has 227 KB of shared memory and each
// 3x3 stage needs its neighbours' outputs from across the image, so no one
// block can own the chain.  The chain is five launches on the caller's
// stream, one per convolution, with the intermediates in caller-allocated
// scratch that stays in the 50 MB L2 (3.7 MB per 256-channel stage and
// image).  Four stages are the tiled f32 tap-convolution of tap_conv.cuh; its
// channel-offset writes put cor and flo side by side, so neither concat is a
// copy.  convf1 has K = 49 taps x 2 channels = 98: not a matrix-product
// shape, so it is an outer-product accumulation from a 7-row patch of the
// flow staged once in shared memory.  The same kernel copies the flow into
// the last two output channels.

#include "tap_conv.cuh"

namespace {

using tapconv::kThreads;
using tapconv::kTM;
using tapconv::kTN;

constexpr int kF1Out = 128;      // convf1 output channels
constexpr int kF1Taps = 7;
constexpr int kPatchW = kTM + kF1Taps - 1;

// relu(conv7x7(flow)) -> flo1 [B, 128, H, W]; block = 64 positions of a row
// by 64 of the 128 output channels.  Blocks of the first channel half also
// write flow to channels [mot_c - 2, mot_c) of mot [B, mot_c, H, W].
__global__ void __launch_bounds__(kThreads)
flow_conv7_kernel(const float* __restrict__ flow, const float* __restrict__ wgt,
                  const float* __restrict__ bias, float* __restrict__ flo1,
                  float* __restrict__ mot, int mot_c, int H, int W) {
  __shared__ float patch[2][kF1Taps][kPatchW];
  __shared__ float Ws[2 * kF1Taps * kF1Taps][kTN];

  const int x0 = blockIdx.x * kTM;
  const int y = blockIdx.y;
  const int b = blockIdx.z / 2;
  const int n0 = (blockIdx.z % 2) * kTN;
  const int tid = threadIdx.x;
  const int tm = tid % 16;
  const int tn = tid / 16;
  const int64_t plane = (int64_t)H * W;
  const float* fb = flow + (int64_t)b * 2 * plane;

  for (int e = tid; e < 2 * kF1Taps * kPatchW; e += kThreads) {
    const int ch = e / (kF1Taps * kPatchW);
    const int r = e / kPatchW % kF1Taps;
    const int col = e % kPatchW;
    const int yy = y + r - kF1Taps / 2;
    const int xx = x0 + col - kF1Taps / 2;
    patch[ch][r][col] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                            ? fb[ch * plane + (int64_t)yy * W + xx]
                            : 0.0f;
  }
  for (int e = tid; e < 2 * kF1Taps * kF1Taps * kTN; e += kThreads)
    Ws[e / kTN][e % kTN] = wgt[(int64_t)(e / kTN) * kF1Out + n0 + e % kTN];
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k = 0; k < 2 * kF1Taps * kF1Taps; ++k) {  // k = tap*2 + channel
    const int ch = k % 2;
    const int r = k / 2 / kF1Taps;
    const int dx = k / 2 % kF1Taps;
    float a[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = patch[ch][r][tm + 16 * i + dx];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = Ws[k][4 * tn + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 4 * tn + j;
    const float bn = bias[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int xx = x0 + tm + 16 * i;
      if (xx < W)
        flo1[((int64_t)b * kF1Out + n) * plane + (int64_t)y * W + xx] =
            fmaxf(acc[i][j] + bn, 0.0f);
    }
  }
  if (n0 == 0 && tid < 2 * kTM) {
    const int ch = tid / kTM;
    const int xx = x0 + tid % kTM;
    if (xx < W)
      mot[((int64_t)b * mot_c + mot_c - 2 + ch) * plane + (int64_t)y * W + xx] =
          patch[ch][kF1Taps / 2][tid % kTM + kF1Taps / 2];
  }
}

}  // namespace

// corr [B, CK, H, W], flow [B, 2, H, W] -> out [B, 128, H, W].  scratch holds
// B*640*H*W floats (cor1 256, flo1 128, cat 256 channels).  Returns the first
// non-zero cudaGetLastError() of the five launches (0 on success).
extern "C" int motion_encoder_f32(
    const void* corr, const void* flow, const void* wc1, const void* bc1,
    const void* wc2, const void* bc2, const void* wf1, const void* bf1,
    const void* wf2, const void* bf2, const void* wm, const void* bm,
    void* scratch, void* out, int B, int H, int W, int CK, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || CK <= 0) return (int)cudaErrorInvalidValue;
  using namespace tapconv;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int64_t plane = (int64_t)H * W;
  float* cor1 = static_cast<float*>(scratch);
  float* flo1 = cor1 + B * 256 * plane;
  float* cat = flo1 + B * 128 * plane;
  float* o = static_cast<float*>(out);
  cudaError_t rc;

  Args c1{f(corr), CK, nullptr, 0, f(wc1), f(bc1), 256, cor1, 256, 0, H, W};
  if ((rc = launch<1, 1>(c1, B, s)) != cudaSuccess) return (int)rc;
  Args c2{cor1, 256, nullptr, 0, f(wc2), f(bc2), 192, cat, 256, 0, H, W};
  if ((rc = launch<3, 3>(c2, B, s)) != cudaSuccess) return (int)rc;

  const dim3 grid((W + kTM - 1) / kTM, H, B * 2);
  flow_conv7_kernel<<<grid, kThreads, 0, s>>>(f(flow), f(wf1), f(bf1), flo1, o,
                                              128, H, W);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  Args f2{flo1, 128, nullptr, 0, f(wf2), f(bf2), 64, cat, 256, 192, H, W};
  if ((rc = launch<3, 3>(f2, B, s)) != cudaSuccess) return (int)rc;

  Args m{cat, 256, nullptr, 0, f(wm), f(bm), 126, o, 128, 0, H, W};
  return (int)launch<3, 3>(m, B, s);
}
