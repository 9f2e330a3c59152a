// Grouped deformable bilinear sampler of the DAT levels, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   videoframeinterpolation_tpu/kernels/window_sample.py:windowed_deformable_sample
// (pl.pallas_call at :240). That kernel fetched one WIN x WIN window per
// query and resolved the taps with a lane gather, because the TPU pays per
// gathered row. This one is written from the function instead:
//
//   coords  = (qx, qy) + (residual[b, qy, qx, g, s] + flow[b, qy, qx])
//   out[b, s, q, g*Cg + c] = sum over the 4 bilinear taps of
//                            w_tap * m_tap * feat[b, yi, xi, g*Cg + c]
//
// with floor-based taps and a zeros mask per tap (0 <= xi <= W-1,
// 0 <= yi <= H-1), as in videoframeinterpolation_tpu/ops/interp.py:119-190.
// The association follows the JAX model: off = res + flow
// (nn/deformable_attn.py:256), then base + off (:115). The model casts off to
// fp32 right after the add, and XLA then takes the add itself in fp32, so for
// bf16 inputs too off is the fp32 sum of the two bf16 values. Products and
// sums use the _rn intrinsics so that nvcc contracts nothing into an FMA, and
// the fp32 result matches the plain version's tap for tap.
//
// bf16 semantics: the coordinates are exactly the plain version's; the taps'
// weights, products and sums are fp32, and the result is rounded to bf16 once.
// (The plain version, like JAX, rounds the weights and every product and sum
// to bf16, so the two may differ by a few bf16 ulps; the kernel is within one
// ulp of the fp32 sampling of its bf16 inputs.)
//
// Layout: feat (B2, H, W, C), flow (B2, H, W, 2), residual (B2, H, W, G, S, 2),
// out (B2, S, H*W, C), all contiguous; G divides C.
//
// Design: one warp per output row (b, s, q); the lanes stride over the C
// channels of a group, so every feature read and every output write is
// coalesced along NHWC. Weights and sums are fp32; bf16 is converted with
// the intrinsics.
//
// What bounds it on this card: bytes. The output write of B2*S*H*W*C
// elements dominates; each output element reads up to four feature
// elements, mostly from L2 (the 50 MB L2 holds a whole level's features).
// Making it fast (a row per thread block with the group's channels held in
// registers, vector loads, fusing the k/v projection) is a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deformable_sample_kernel(const T* __restrict__ feat, const T* __restrict__ flow,
                         const T* __restrict__ residual, T* __restrict__ out,
                         int B2, int H, int W, int C, int G, int S) {
  const long long HW = (long long)H * W;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)B2 * S * HW) return;
  const int lane = threadIdx.x & 31;

  const long long q = row % HW;
  const long long bs = row / HW;
  const int s = (int)(bs % S);
  const long long b = bs / S;
  const int qy = (int)(q / W);
  const int qx = (int)(q % W);
  const long long pix = b * HW + q;
  const T fx = flow[pix * 2];
  const T fy = flow[pix * 2 + 1];

  const int Cg = C / G;
  const T* fb = feat + b * HW * C;
  T* orow = out + row * C;

  for (int g = 0; g < G; ++g) {
    const T* r = residual + ((pix * G + g) * S + s) * 2;
    const float x = __fadd_rn((float)qx, __fadd_rn(to_f32(r[0]), to_f32(fx)));
    const float y = __fadd_rn((float)qy, __fadd_rn(to_f32(r[1]), to_f32(fy)));
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float wx = __fsub_rn(x, x0f);
    const float wy = __fsub_rn(y, y0f);

    // Tap validity from the float tap positions: exact for |x| < 2^24 and
    // safe for coordinates that would overflow an int.
    const bool vx0 = x0f >= 0.f && x0f <= (float)(W - 1);
    const bool vx1 = x0f >= -1.f && x0f <= (float)(W - 2);
    const bool vy0 = y0f >= 0.f && y0f <= (float)(H - 1);
    const bool vy1 = y0f >= -1.f && y0f <= (float)(H - 2);
    const bool v00 = vx0 && vy0, v01 = vx1 && vy0;
    const bool v10 = vx0 && vy1, v11 = vx1 && vy1;
    const int c0 = g * Cg;
    if (!(v00 || v01 || v10 || v11)) {
      for (int c = c0 + lane; c < c0 + Cg; c += 32) orow[c] = from_f32<T>(0.f);
      continue;
    }
    const long long x0 = (long long)x0f;  // in [-1, W-1] here
    const long long y0 = (long long)y0f;
    const long long p00 = (y0 * W + x0) * C;
    const long long p01 = p00 + C;
    const long long p10 = p00 + (long long)W * C;
    const long long p11 = p10 + C;

    const float ux = __fsub_rn(1.f, wx);
    const float uy = __fsub_rn(1.f, wy);
    const float w00 = __fmul_rn(ux, uy);
    const float w01 = __fmul_rn(wx, uy);
    const float w10 = __fmul_rn(ux, wy);
    const float w11 = __fmul_rn(wx, wy);

    for (int c = c0 + lane; c < c0 + Cg; c += 32) {
      // A masked tap adds an exact zero in the plain version; skipping it
      // gives the same sum.
      float acc = 0.f;
      if (v00) acc = __fmul_rn(w00, to_f32(fb[p00 + c]));
      if (v01) acc = __fadd_rn(acc, __fmul_rn(w01, to_f32(fb[p01 + c])));
      if (v10) acc = __fadd_rn(acc, __fmul_rn(w10, to_f32(fb[p10 + c])));
      if (v11) acc = __fadd_rn(acc, __fmul_rn(w11, to_f32(fb[p11 + c])));
      orow[c] = from_f32<T>(acc);
    }
  }
}

template <typename T>
int launch(const void* feat, const void* flow, const void* residual, void* out,
           int B2, int H, int W, int C, int G, int S, void* stream) {
  if (B2 <= 0 || H <= 0 || W <= 0 || C <= 0 || G <= 0 || S <= 0 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B2 * S * H * W;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  deformable_sample_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                (cudaStream_t)stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(flow),
      static_cast<const T*>(residual), static_cast<T*>(out), B2, H, W, C, G, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vfi_deformable_sample_f32(const void* feat, const void* flow,
                                         const void* residual, void* out, int B2,
                                         int H, int W, int C, int G, int S,
                                         void* stream) {
  return launch<float>(feat, flow, residual, out, B2, H, W, C, G, S, stream);
}

extern "C" int vfi_deformable_sample_bf16(const void* feat, const void* flow,
                                          const void* residual, void* out, int B2,
                                          int H, int W, int C, int G, int S,
                                          void* stream) {
  return launch<__nv_bfloat16>(feat, flow, residual, out, B2, H, W, C, G, S,
                               stream);
}
