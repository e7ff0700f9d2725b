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
// two launches of the tiled tap-convolution of tap_conv.cuh.  The gate launch
// writes z and r*h to scratch that the caller allocates; the blend launch
// reads r*h in place of h and fuses tanh and the blend into its epilogue.
// Both axes read rows of x-consecutive positions (the 5x1 pass shifts the
// row, the 1x5 pass the column), so neither pass needs a transpose.

#include "tap_conv.cuh"

// z, rh: scratch [B, HD, H, W]; out: the new hidden state.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int sep_gru_pass_f32(const void* h, const void* x, const void* wzr,
                                const void* bzr, const void* wq,
                                const void* bq, void* z, void* rh, void* out,
                                int B, int H, int W, int HD, int CX, int axis,
                                void* stream) {
  if (HD <= 0 || CX < 0 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const auto pass = axis == 0 ? tapconv::gru_pass<1, 5> : tapconv::gru_pass<5, 1>;
  return (int)pass(static_cast<const float*>(h), static_cast<const float*>(x),
                   static_cast<const float*>(wzr),
                   static_cast<const float*>(bzr),
                   static_cast<const float*>(wq), static_cast<const float*>(bq),
                   static_cast<float*>(z), static_cast<float*>(rh),
                   static_cast<float*>(out), B, H, W, HD, CX,
                   static_cast<cudaStream_t>(stream));
}
