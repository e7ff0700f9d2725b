// One separable ConvGRU pass of RAFT's update block for Hopper (sm_90a),
// f32-accurate on the tensor cores.
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
// positions, HD = 128, CX = 256) a pass is 2*P*5*384*(256+128) = 9.47 GFLOP
// against about 16 MB of traffic.  f32-accurate on the tensor cores (3xTF32,
// three TF32 products for each f32 one) the ceiling is 495 / 3 = 165 TFLOP/s:
// 0.0574 ms; on the CUDA cores' 67 TFLOP/s f32 FMA it would be 0.141 ms.
//
// Design: q needs r*h at the 5 neighbours of each position, so the pass is
// two launches of the tensor-core implicit GEMM of tap_mma.cuh (M = positions,
// N = output channels, K = 5 taps x 384 channels, 3xTF32).  The gate launch
// (N = 256) writes z and r*h to scratch that the caller allocates; the blend
// launch (N = 128) reads r*h in place of h and fuses tanh and the blend into
// its epilogue.  Both axes read x-consecutive runs of positions (the 5x1 pass
// shifts whole rows, in 16-byte copies where W % 4 == 0; the 1x5 pass shifts
// columns, in 4-byte copies), so neither needs a transpose.  At the TC shape
// the 64 x 128 tiles make 202 gate and 101 blend blocks for 132 SMs (two
// blocks fit on one): the last partial wave leaves about a quarter of the
// card idle, which a stream-K split of K would recover.

#include "tap_mma.cuh"

// z, rh: scratch [B, HD, H, W]; out: the new hidden state.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int sep_gru_pass_f32(const void* h, const void* x, const void* wzr,
                                const void* bzr, const void* wq,
                                const void* bq, void* z, void* rh, void* out,
                                int B, int H, int W, int HD, int CX, int axis,
                                void* stream) {
  if (HD <= 0 || CX < 0 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const auto pass = axis == 0 ? tapmma::gru_pass<1, 5> : tapmma::gru_pass<5, 1>;
  return (int)pass(static_cast<const float*>(h), static_cast<const float*>(x),
                   static_cast<const float*>(wzr),
                   static_cast<const float*>(bzr),
                   static_cast<const float*>(wq), static_cast<const float*>(bq),
                   static_cast<float*>(z), static_cast<float*>(rh),
                   static_cast<float*>(out), B, H, W, HD, CX,
                   static_cast<cudaStream_t>(stream));
}
