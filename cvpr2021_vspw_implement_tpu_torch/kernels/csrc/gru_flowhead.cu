// RAFT's SepConvGRU (both passes) and FlowHead for Hopper (sm_90a),
// f32-accurate on the tensor cores, one C entry point.
//
// Replaces the TPU kernel cvpr2021_vspw_implement_tpu/ops/pallas/
// raft_update.py::gru_flowhead_fused (kernel _gru_flowhead_kernel).  NCHW,
// with h the hidden state [B, HD, H, W] and x the input [B, CX, H, W]:
//     pass 1 (1x5) then pass 2 (5x1):
//         z|r = sigmoid(conv5([h | x]) + bzr);  q = tanh(conv5([r*h | x]) + bq)
//         h   = (1 - z) * h + z * q
//     delta = conv2_3x3(relu(conv1_3x3(h)))                 HD -> CF -> 2
// and returns (h, delta).  Weights are [taps, cin, cout] (tap row-major).
//
// Bound on this card: operations.  At the training shape (P = 60*60
// positions, HD = 128, CX = 256, CF = 256) this is 2*P*(2*5*384*384 +
// 9*128*256 + 9*256*2) = 12.77 GFLOP per image against about 12 MB of
// traffic: 0.155 ms for both images at the 165 TFLOP/s of f32-accurate
// products on the tensor cores (3xTF32: 495 / 3), 0.381 ms at the 67 TFLOP/s
// of f32 FMA on the CUDA cores.
//
// Design.  As in motion_encoder.cu, no thread block can hold a stage of the
// whole image, and q must read r*h only after all of it is written, so the
// chain is six launches on the caller's stream with z, r*h, the hidden state
// between the passes and the flow head's hidden layer in caller-allocated
// scratch (L2-resident).  The GRU passes are the two launches of
// tap_mma.cuh::gru_pass (the device code of sep_gru.cu), conv1 its relu
// convolution: all on the tensor cores, 3xTF32.  conv2 has two output
// channels, 0.26% of the operations, and no tensor-core tile worth taking: it
// is a reduction kernel on the CUDA cores, 64 positions of a row per block,
// the input channels split over 4 thread groups that are summed through
// shared memory.

#include "tap_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 64;  // conv2: positions a block (along x)

constexpr int kGroups = kThreads / kTM;
constexpr int kMaxCF = 512;  // conv2's weights [9, CF, 2] in shared memory

__global__ void __launch_bounds__(kThreads)
flow_conv2_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int C, int H, int W) {
  __shared__ float Ws[9 * kMaxCF * 2];
  __shared__ float red[kGroups][kTM][2];

  const int tid = threadIdx.x;
  const int px = tid % kTM;
  const int g = tid / kTM;
  const int xc = blockIdx.x * kTM + px;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t plane = (int64_t)H * W;
  const float* xb = x + (int64_t)b * C * plane;
  const int per = C / kGroups;

  for (int e = tid; e < 9 * C * 2; e += kThreads) Ws[e] = wgt[e];
  __syncthreads();

  float acc0 = 0.0f, acc1 = 0.0f;
  for (int t = 0; t < 9; ++t) {
    const int yy = y + t / 3 - 1;
    const int xx = xc + t % 3 - 1;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    const float* src = xb + (int64_t)yy * W + xx;
    const float* w = Ws + (t * C + g * per) * 2;
#pragma unroll 8
    for (int c = 0; c < per; ++c) {
      const float v = src[(int64_t)(g * per + c) * plane];
      acc0 = fmaf(v, w[2 * c], acc0);
      acc1 = fmaf(v, w[2 * c + 1], acc1);
    }
  }
  red[g][px][0] = acc0;
  red[g][px][1] = acc1;
  __syncthreads();
  if (tid < 2 * kTM) {
    const int ch = tid / kTM;
    float v = bias[ch];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) v += red[k][px][ch];
    if (xc < W) out[((int64_t)b * 2 + ch) * plane + (int64_t)y * W + xc] = v;
  }
}

}  // namespace

// net [B, HD, H, W], x [B, CX, H, W] -> net_out [B, HD, H, W], delta [B, 2, H,
// W].  scratch holds B*(3*HD + CF)*H*W floats (z, r*h, the hidden state after
// pass 1, the flow head's hidden layer).  Returns the first non-zero
// cudaGetLastError() of the six launches (0 on success).
extern "C" int gru_flowhead_f32(
    const void* net, const void* x, const void* wzr1, const void* bzr1,
    const void* wq1, const void* bq1, const void* wzr2, const void* bzr2,
    const void* wq2, const void* bq2, const void* wfh1, const void* bfh1,
    const void* wfh2, const void* bfh2, void* scratch, void* net_out,
    void* delta, int B, int H, int W, int HD, int CX, int CF, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || HD <= 0 || CX < 0 || CF <= 0 ||
      CF > kMaxCF || CF % kGroups != 0)
    return (int)cudaErrorInvalidValue;
  using namespace tapmma;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int64_t n = (int64_t)B * HD * H * W;
  float* z = static_cast<float*>(scratch);
  float* rh = z + n;
  float* h1 = rh + n;
  float* fh = h1 + n;
  float* h2 = static_cast<float*>(net_out);
  cudaError_t rc;

  rc = gru_pass<1, 5>(f(net), f(x), f(wzr1), f(bzr1), f(wq1), f(bq1), z, rh,
                      h1, B, H, W, HD, CX, s);
  if (rc != cudaSuccess) return (int)rc;
  rc = gru_pass<5, 1>(h1, f(x), f(wzr2), f(bzr2), f(wq2), f(bq2), z, rh, h2,
                      B, H, W, HD, CX, s);
  if (rc != cudaSuccess) return (int)rc;

  Args c1{h2, HD, nullptr, 0, f(wfh1), f(bfh1), CF, fh, CF, 0, CF,
          nullptr, nullptr, H, W};
  if ((rc = launch<3, 3, kRelu>(c1, B, s)) != cudaSuccess) return (int)rc;
  const dim3 grid((W + kTM - 1) / kTM, H, B);
  flow_conv2_kernel<<<grid, kThreads, 0, s>>>(fh, f(wfh2), f(bfh2),
                                              static_cast<float*>(delta), CF,
                                              H, W);
  return (int)cudaGetLastError();
}
