// Tensor-core f32-accurate tap-convolution for Hopper (sm_90a): the device
// routine of the separable GRU (sep_gru.cu) and of the GRU + flow head
// (gru_flowhead.cu).
//
// A stride-1, zero-padded KH x KW convolution of an NCHW input is an
// implicit matrix product: M = positions, N = output channels, K = taps x
// input channels.  The input may be the channel concat of two tensors a [B,
// ca, H, W] and b [B, cb, H, W] ([h | x] and [r*h | x] are never
// materialised); weights are [KH*KW, ca + cb, cout] (tap row-major, input
// channel, output channel).  The output goes to channels [out_coff, out_coff
// + cout) of a [B, out_ctotal, H, W] tensor.
//
// Precision: 3xTF32.  Every operand is split in registers, after its
// fragment is read from shared memory, into hi = tf32(v) and lo = tf32(v -
// hi), rounded as cvt.rna.tf32.f32 rounds, and each product is lo*hi + hi*lo
// + hi*hi on the tensor cores (mma.sync m16n8k8 TF32, f32 accumulators);
// lo*lo is dropped.  The result keeps about 21 of f32's 24 mantissa bits,
// where one TF32 product keeps 11: at K = 1920 that is the difference between
// about 1e-6 and 1e-3 of absolute error against the f32 convolution.  The
// tensor cores round their sums toward zero, so the products of each K step
// go to a fresh tile that an f32 add takes into the accumulator (see the
// kernel).  The rate ceiling is a third of dense TF32: 495 / 3 = 165 TFLOP/s
// on an H100 SXM.
//
// Design.  A block computes a BM x BN tile: BM flat positions of one image
// (a tile may run over row ends, so W = 107 leaves no idle slots but the
// image's last tile) by BN output channels; 4 warps of 32 x 64.  The K loop
// walks (32-input-channel chunk, tap) steps, taps inner, through a ring of 3
// shared-memory stages filled by cp.async, so copies run two steps ahead of
// the MMAs, with one barrier per step.  Activations are staged k-major
// (As[k][m]: a channel's positions are contiguous in NCHW) through L1, where
// the taps of a chunk find each other's lines; weights k-major (Bs[k][n]),
// around L1.  Taps outside the image, channels past ca + cb and positions
// past H*W are zero-filled by cp.async (src-size 0); the image test uses each
// element's own (y + dy, x + dx), so a 1x5 tap never wraps into the next row.
// A 16-byte copy serves 4 positions of one row only where rows are 16-byte
// aligned (W % 4 == 0) and the tap has dx = 0 (every tap of the 5x1 pass, the
// middle column of a 3x3); other taps copy 4 bytes an element.  TMA cannot
// describe these tensors: its global strides must be multiples of 16 bytes,
// and at W = 107 a row is 428.  Fragments are read with 128-bit shared loads
// (see the kernel for the row and column order that allows it).
//
// Epilogues (after the bias): relu; the GRU gate (sigmoid, z to its own
// buffer and r*h to out); the GRU blend (tanh, h' = (1-z)*h + z*q).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tapmma {

enum Epilogue { kRelu = 0, kGate = 1, kBlend = 2 };

struct Args {
  const float* a;  // first input  [B, ca, H, W]
  int ca;
  const float* b;  // second input [B, cb, H, W], channel-concatenated after a
  int cb;
  const float* wgt;   // [KH*KW, ca + cb, cout], 16-byte aligned
  const float* bias;  // [cout]
  int cout;           // a multiple of 4; kGate: 2*hd (z then r); kBlend: hd
  float* out;         // [B, out_ctotal, H, W]; kGate: r*h; kBlend: h'
  int out_ctotal;
  int out_coff;
  const float* h;  // kGate, kBlend: the old hidden state [B, hd, H, W]
  float* z;        // kGate: written; kBlend: read          [B, hd, H, W]
  int H;
  int W;
  int vec;  // set by launch: 16-byte activation copies allowed
};

// The block tile: BM positions x BN channels, WARPS_M x WARPS_N warps of WM
// x WN, BK input channels a K step, STAGES steps in flight.
namespace tile {
constexpr int BM = 64, BN = 128, WARPS_M = 2, WARPS_N = 2, BK = 32, STAGES = 3;
constexpr int kThreads = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
constexpr int MT = WM / 16, NT = WN / 8;  // MMA tiles of a warp
constexpr int LDA = BM + 8, LDB = BN + 8;  // rows padded to 8 mod 32 floats
constexpr int kSmemBytes = STAGES * BK * (LDA + LDB) * 4;  // 78 KiB
// thread layout of the copies: one position (4-byte) or four (16-byte) of
// kSK / kVK channel rows apart; four output channels, kBK rows apart
constexpr int kSK = kThreads / BM, kVK = kThreads / (BM / 4),
              kBK = kThreads / (BN / 4);
// the fragment loads take 32-wide groups; each copy loop covers BK rows
static_assert(WM % 32 == 0 && WN % 32 == 0 && BK % 8 == 0 && BK % kSK == 0 &&
                  BK % kVK == 0 && BK % kBK == 0,
              "tile layout");
}  // namespace tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 or 16 bytes; src-size 0 writes zeros and reads nothing.
// Activations go through L1 (.ca): the taps of one channel chunk are
// consecutive K steps and read nearly the same lines.  Weights are read once
// a block and bypass it (.cg).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const float* src,
                                              bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo + O(2^-22 |v|), both TF32, without cvt (which runs at the
// conversion unit's lower rate).  hi rounds as cvt.rna.tf32.f32 does (to
// nearest, ties away from zero): float bits are sign and magnitude, so
// adding half the weight of the 13 dropped bits to the magnitude and
// masking them rounds half away.  lo = v - hi is exact in f32 and skips the
// mask: the tensor cores read only the top 19 bits of a TF32 operand.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

// d (+)= a * b on a 16x8x8 tile (row-major A, column-major B, f32
// accumulate); mma_tf32 accumulates into d, mma_tf32_fresh starts from 0.
// Not volatile: the compiler may interleave independent tiles' MMAs.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

template <int KH, int KW, int EPI>
__global__ void __launch_bounds__(tile::kThreads)
    tap_mma_kernel(const Args p) {
  using namespace tile;
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;                      // [STAGES][BK][LDA]
  float* const Bs = smem + STAGES * BK * LDA;  // [STAGES][BK][LDB]

  const int cin = p.ca + p.cb;
  const int H = p.H, W = p.W, HW = H * W;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const float* const ab = p.a + (int64_t)blockIdx.z * p.ca * HW;
  const float* const bb =
      p.cb > 0 ? p.b + (int64_t)blockIdx.z * p.cb * HW : ab;
  constexpr int kTaps = KH * KW;
  const int steps = kTaps * ((cin + BK - 1) / BK);
  const int tid = threadIdx.x;

  // Per-thread copy coordinates, fixed over the K loop.  Offsets are 32-bit
  // within one image's input (at most 2^31 floats).
  const int sm = tid % BM, sk = tid / BM;                  // 4-byte
  const int sp = m0 + sm, sy = sp / W, sx = sp % W;
  const int vm = tid % (BM / 4) * 4, vk = tid / (BM / 4);  // 16-byte
  const int vp = m0 + vm, vy = vp / W;
  const int bn = tid % (BN / 4) * 4, bk = tid / (BN / 4);  // weights
  const bool bn_ok = n0 + bn < p.cout;
  const float* const wb = p.wgt + (bn_ok ? n0 + bn : 0) + bk * p.cout;
  const uint32_t a_dst = smem_addr(As + sk * LDA + sm);
  const uint32_t v_dst = smem_addr(As + vk * LDA + vm);
  const uint32_t b_dst = smem_addr(Bs + bk * LDB + bn);

  // Stage ``step`` = (chunk of BK channels, tap), taps inner, into ring slot
  // ``slot``.  A chunk lies in one input (the caller keeps ca a multiple of
  // BK when cb > 0).  Out-of-range rows are zero-filled with their source
  // clamped into the tensor; so are the channels past cin of a last, partial
  // chunk, which takes a slower path with a clamp for each copy.
  const auto load_step = [&](int slot, int step) {
    const int c0 = step / kTaps * BK;
    const int tap = step % kTaps;
    const int dy = tap / KW - KH / 2, dx = tap % KW - KW / 2;
    const int last = cin - 1 - c0;  // the chunk's last channel, from c0
    const bool full = last >= BK - 1;
    const float* const base =
        c0 < p.ca ? ab + c0 * HW : bb + (c0 - p.ca) * HW;
    // kn copies, rows k0 + i*kstep (i < kn) of the chunk, from src (row k0)
    const auto copy = [&](auto cp, uint32_t dst, int dst_step,
                          const float* src, int src_step, int k0, int kstep,
                          int kn, bool ok) {
      if (full) {
#pragma unroll
        for (int i = 0; i < kn; ++i)
          cp(dst + 4 * i * dst_step, src + (int64_t)i * src_step, ok);
      } else {
#pragma unroll
        for (int i = 0; i < kn; ++i) {
          const int k = min(k0 + i * kstep, last) - k0;
          cp(dst + 4 * i * dst_step, src + (int64_t)k * (src_step / kstep),
             ok && k0 + i * kstep <= last);
        }
      }
    };
    if (p.vec && dx == 0) {
      const bool ok = vp < HW && vy + dy >= 0 && vy + dy < H;
      copy([](uint32_t d, const float* s, bool v) { cp_async16_ca(d, s, v); },
           v_dst + 4 * slot * BK * LDA, kVK * LDA,
           base + (ok ? vp + dy * W : 0) + vk * HW, kVK * HW, vk, kVK,
           BK / kVK, ok);
    } else {
      const bool ok = sp < HW && sy + dy >= 0 && sy + dy < H &&
                      sx + dx >= 0 && sx + dx < W;
      copy([](uint32_t d, const float* s, bool v) { cp_async4(d, s, v); },
           a_dst + 4 * slot * BK * LDA, kSK * LDA,
           base + (ok ? sp + dy * W + dx : 0) + sk * HW, kSK * HW, sk,
           kSK, BK / kSK, ok);
    }
    copy([](uint32_t d, const float* s, bool v) { cp_async16(d, s, v); },
         b_dst + 4 * slot * BK * LDB, kBK * LDB,
         wb + (tap * cin + c0) * p.cout, kBK * p.cout, bk, kBK,
         BK / kBK, bn_ok);
  };

  // Which position and channel an MMA row and column stand for is free.  In
  // each 32-wide group of a warp's positions, a thread's 4 (rows gid and
  // gid + 8 of two m-tiles) are consecutive: row g of m-tile i is position
  // wm0 + 32(i/2) + 4(g%8) + 2(i%2) + g/8; likewise column g of n-tile j is
  // channel wn0 + 32(j/4) + 4g + j%4.  So each k row of a thread's fragments
  // is one 128-bit shared load per group, free of bank conflicts (rows are
  // padded to 8 mod 32 floats), while the copies stage positions and
  // channels in their natural order.
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm0 = warp % WARPS_M * WM;
  const int wn0 = warp / WARPS_M * WN;

  // The tensor cores round their f32 sums toward zero, so a chain of MMAs
  // into one accumulator drifts with the sign of the running sum (about 2e-5
  // of the output over K = 1920).  A K step's products (lo*hi, hi*lo, hi*hi
  // for each k8 slice) go to a fresh tile, whose rounding follows the sign of
  // that step's partial sum; an f32 add (round to nearest) takes it into acc.
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's stage landed; the slot refilled below is free
    const int next = step + STAGES - 1;
    if (next < steps) load_step(next % STAGES, next);
    cp_async_commit();

    const float* const as = As + step % STAGES * BK * LDA + wm0 +
                            4 * gid + tig * LDA;
    const float* const bs = Bs + step % STAGES * BK * LDB + wn0 +
                            4 * gid + tig * LDB;
    float t[MT][NT][4];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int g = 0; g < MT / 2; ++g) {
        const float4 v0 =
            *reinterpret_cast<const float4*>(as + kk * LDA + 32 * g);
        const float4 v4 =
            *reinterpret_cast<const float4*>(as + (kk + 4) * LDA + 32 * g);
        split_tf32(v0.x, ah[2 * g][0], al[2 * g][0]);
        split_tf32(v0.y, ah[2 * g][1], al[2 * g][1]);
        split_tf32(v4.x, ah[2 * g][2], al[2 * g][2]);
        split_tf32(v4.y, ah[2 * g][3], al[2 * g][3]);
        split_tf32(v0.z, ah[2 * g + 1][0], al[2 * g + 1][0]);
        split_tf32(v0.w, ah[2 * g + 1][1], al[2 * g + 1][1]);
        split_tf32(v4.z, ah[2 * g + 1][2], al[2 * g + 1][2]);
        split_tf32(v4.w, ah[2 * g + 1][3], al[2 * g + 1][3]);
      }
#pragma unroll
      for (int g = 0; g < NT / 4; ++g) {
        const float4 v0 =
            *reinterpret_cast<const float4*>(bs + kk * LDB + 32 * g);
        const float4 v4 =
            *reinterpret_cast<const float4*>(bs + (kk + 4) * LDB + 32 * g);
        split_tf32(v0.x, bh[4 * g][0], bl[4 * g][0]);
        split_tf32(v4.x, bh[4 * g][1], bl[4 * g][1]);
        split_tf32(v0.y, bh[4 * g + 1][0], bl[4 * g + 1][0]);
        split_tf32(v4.y, bh[4 * g + 1][1], bl[4 * g + 1][1]);
        split_tf32(v0.z, bh[4 * g + 2][0], bl[4 * g + 2][0]);
        split_tf32(v4.z, bh[4 * g + 2][1], bl[4 * g + 2][1]);
        split_tf32(v0.w, bh[4 * g + 3][0], bl[4 * g + 3][0]);
        split_tf32(v4.w, bh[4 * g + 3][1], bl[4 * g + 3][1]);
      }
      // each product over all tiles before the next, so that no MMA waits
      // on the one before it
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (kk == 0)
            mma_tf32_fresh(t[i][j], al[i], bh[j]);
          else
            mma_tf32(t[i][j], al[i], bh[j]);
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(t[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(t[i][j], ah[i], bh[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += t[i][j][r];
  }
  cp_async_wait<0>();

  // acc[i][j][r] is row gid + 8(r/2) of m-tile i and column 2tig + r%2 of
  // n-tile j
  const int64_t plane = HW;
  const int hd = EPI == kGate ? p.cout / 2 : p.cout;
  const int64_t b = blockIdx.z;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + wn0 + 32 * (j / 4) + 4 * (2 * tig + r % 2) + j % 4;
      if (n >= p.cout) continue;
      const float bn_ = p.bias[n];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int pos = m0 + wm0 + 32 * (i / 2) + 4 * gid + 2 * (i % 2) + r / 2;
        if (pos >= HW) continue;
        const float v = acc[i][j][r] + bn_;
        if (EPI == kGate) {
          const float s = 1.0f / (1.0f + expf(-v));
          if (n < hd) {
            p.z[(b * hd + n) * plane + pos] = s;
          } else {
            const int64_t idx = (b * hd + (n - hd)) * plane + pos;
            p.out[idx] = s * p.h[idx];
          }
        } else if (EPI == kBlend) {
          const int64_t idx = (b * hd + n) * plane + pos;
          const float zz = p.z[idx];
          p.out[idx] = (1.0f - zz) * p.h[idx] + zz * tanhf(v);
        } else {
          p.out[(b * p.out_ctotal + p.out_coff + n) * plane + pos] =
              fmaxf(v, 0.0f);
        }
      }
    }
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Launches one convolution on ``stream``; returns cudaGetLastError(), or
// cudaErrorInvalidValue for weights the 16-byte copies cannot take or a
// first input whose channels do not fill whole K steps.
template <int KH, int KW, int EPI>
inline cudaError_t launch(Args p, int B, cudaStream_t stream) {
  if (p.cout % 4 != 0 || !aligned16(p.wgt) ||
      (p.cb > 0 && p.ca % tile::BK != 0))
    return cudaErrorInvalidValue;
  p.vec = p.W % 4 == 0 && aligned16(p.a) && (p.cb == 0 || aligned16(p.b));
  const auto kernel = tap_mma_kernel<KH, KW, EPI>;
  // above the 48 KiB a block gets without asking
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tile::kSmemBytes);
  if (rc != cudaSuccess) return rc;
  const dim3 grid((p.cout + tile::BN - 1) / tile::BN,
                  (p.H * p.W + tile::BM - 1) / tile::BM, B);
  kernel<<<grid, tile::kThreads, tile::kSmemBytes, stream>>>(p);
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
  Args g{h, HD, x, CX, wzr, bzr, 2 * HD, rh, HD, 0, h, z, H, W, 0};
  cudaError_t rc = launch<KH, KW, kGate>(g, B, stream);
  if (rc != cudaSuccess) return rc;
  Args q{rh, HD, x, CX, wq, bq, HD, out, HD, 0, h, z, H, W, 0};
  return launch<KH, KW, kBlend>(q, B, stream);
}

}  // namespace tapmma
