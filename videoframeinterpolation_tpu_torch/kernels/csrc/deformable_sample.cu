// Grouped deformable bilinear sampler of the DAT levels, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   videoframeinterpolation_tpu/kernels/window_sample.py:windowed_deformable_sample
// (:158, pl.pallas_call at :240). That kernel fetched one WIN x WIN window
// per query and resolved the taps with a lane gather, because the TPU pays
// per gathered row. This one is written from the function instead:
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
// to bf16, so the two may differ by a few bf16 ulps; the kernel equals the
// fp32 sampling of its bf16 inputs rounded once.)
//
// Layout: feat (B2, H, W, C), flow (B2, H, W, 2), residual (B2, H, W, G, S, 2),
// out (B2, S, H*W, C), all contiguous; G divides C.
//
// What bounds it on this card: bytes. The output write of B2*S*H*W*C
// elements dominates; each output element reads four feature elements, from
// L2 (a level's features, at most 8.3 MB in bf16 at 448x256, stay in the
// 50 MB L2), so device memory sees the output, the residual and one read of
// the features.
//
// The first design (one warp per output row (b, s, q), lanes over the
// channels, one element per load and store, 64-bit index math) was row-bound,
// not byte-bound: every row paid six 64-bit divisions and the coordinate math
// in all 32 lanes, C = 72 took three passes of the lanes with 8 of 32 busy on
// the last, and a warp moved 64 (bf16) or 128 (fp32) bytes per request. It
// took about 0.45 ns per row at every DAT_fast level (14.4 / 51.3 / 51.6 us
// for 28,672 / 114,688 / 114,688 rows on the H100) and the same time in bf16
// as in fp32: 10-15% of the bytes bound.
//
// This design: one thread per (b, q, chunk), where a chunk is V contiguous
// bytes of one pixel's channels (V = 16, 8, 4 or 2, chosen per call by the
// wrapper from the group width and the alignment of feat and out; a chunk
// never crosses a group). The thread reads flow[b, q] once and loops over
// the S samples: per sample it reads its group's residual pair (the S pairs
// of one (pixel, group) are contiguous), computes the taps once for the V
// bytes, reads each of the four taps as one V-byte read-only load and writes
// V bytes. The chunks of one pixel sit in neighbouring lanes, so they share
// the taps' L1 lines, and for a fixed s neighbouring threads write
// neighbouring words of out: the stores coalesce fully. Index math is 32-bit
// when every element index of the call fits (the wrapper decides), else a
// 64-bit instance of the same template; the thread's divisions (pixel,
// chunk, row) happen once, outside the sample loop.
//
// What remains: fusing the sampler with SampleAttention's k/v projection
// (so out never reaches device memory), and a shared-memory window of the
// features (flow is unbounded, so a window needs a path for taps outside
// it; whether it beats this direct gather is not measured).
//
// The backward pass (training; the JAX model differentiates
// _grouped_deformable_sample with XLA's autodiff, nn/deformable_attn.py:83):
// given g = d loss / d out, one thread per (b, s, q, g) recomputes the
// coordinates, taps and weights exactly as the forward does and loops over
// the group's Cg channels, reading g and the four taps as V-byte chunks:
//
//   grad_feat[b, tap, c]     += w_tap * m_tap * g[c]        (fp32 atomicAdd)
//   d out / d x = sum_c g[c] * ((1-wy) (v01 - v00) + wy (v11 - v10))
//   d out / d y = sum_c g[c] * ((1-wx) (v10 - v00) + wx (v11 - v01))
//
// with a masked tap's value taken as 0 (ops/interp.py:175-187 masks the
// weights; the derivative of a masked weight's term is then 0 too). The
// coordinate gradient is grad_residual[b, q, g, s] (one thread owns it: no
// atomics) and, summed over (G, S), grad_flow[b, q] (fp32 atomicAdd), since
// coords = q + (residual + flow). The fp32 buffers are rounded once to the
// inputs' dtype by the wrapper; in bf16 every product and sum is fp32 and
// each result is rounded once, where JAX's autodiff rounds in bf16 along
// the way. Atomics add in an order that changes from run to run, so the
// sums are not bit-reproducible. What bounds it: the atomics into
// grad_feat (4 * Cg per sample), served by L2; the bytes bound counts each
// input read once and each output written once. Threads are ordered with q
// fastest for a fixed (b, s), so a warp reads neighbouring rows of g and
// adds into neighbouring pixels' taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// One V-byte load or store, and its split into 32-bit words (a 2-byte
// vector in the low half of one word) and back.
template <int V> struct Vec;
template <> struct Vec<16> {
  using type = uint4;
  static __device__ __forceinline__ void split(uint4 v, unsigned* w) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
  static __device__ __forceinline__ uint4 join(const unsigned* w) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Vec<8> {
  using type = uint2;
  static __device__ __forceinline__ void split(uint2 v, unsigned* w) { w[0] = v.x; w[1] = v.y; }
  static __device__ __forceinline__ uint2 join(const unsigned* w) { return make_uint2(w[0], w[1]); }
};
template <> struct Vec<4> {
  using type = unsigned int;
  static __device__ __forceinline__ void split(unsigned int v, unsigned* w) { w[0] = v; }
  static __device__ __forceinline__ unsigned int join(const unsigned* w) { return w[0]; }
};
template <> struct Vec<2> {
  using type = unsigned short;
  static __device__ __forceinline__ void split(unsigned short v, unsigned* w) { w[0] = v; }
  static __device__ __forceinline__ unsigned short join(const unsigned* w) {
    return (unsigned short)w[0];
  }
};

// Element i of a chunk held as words, and its fp32 value; exact both ways
// for fp32, and bf16 -> fp32 is exact. put() rounds fp32 to bf16 to nearest
// even, as __float2bfloat16 does, into words that start at zero.
template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float get(const unsigned* w, int i) {
    return __uint_as_float(w[i]);
  }
  static __device__ __forceinline__ void put(unsigned* w, int i, float v) {
    w[i] = __float_as_uint(v);
  }
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const unsigned* w, int i) {
    return __uint_as_float(((w[i >> 1] >> ((i & 1) * 16)) & 0xffffu) << 16);
  }
  static __device__ __forceinline__ void put(unsigned* w, int i, float v) {
    w[i >> 1] |= (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v)) << ((i & 1) * 16);
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <int V, typename T>
__device__ __forceinline__ void load_chunk(const T* p, unsigned* w) {
  Vec<V>::split(__ldg(reinterpret_cast<const typename Vec<V>::type*>(p)), w);
}

// T: float or __nv_bfloat16; V: bytes per chunk; I: int or long long, wide
// enough for every element index of the call.
template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
deformable_sample_kernel(const T* __restrict__ feat, const T* __restrict__ flow,
                         const T* __restrict__ residual, T* __restrict__ out,
                         int B2, int H, int W, int C, int G, int S) {
  constexpr int kElems = V / (int)sizeof(T);
  constexpr int kWords = (V + 3) / 4;
  const I HW = (I)H * W;
  const int chunks = C / kElems;                 // per pixel
  const long long t64 = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t64 >= (long long)B2 * H * W * chunks) return;
  const I t = (I)t64;
  const I pix = t / chunks;                      // b * HW + q
  const int k = (int)(t - pix * chunks);
  const I b = pix / HW;
  const I q = pix - b * HW;
  const int qy = (int)(q / W);
  const int qx = (int)(q - (I)qy * W);
  const int g = k / (chunks / G);

  const float fx = Elem<T>::load(flow + 2 * pix);
  const float fy = Elem<T>::load(flow + 2 * pix + 1);
  const T* r = residual + (pix * G + g) * S * 2;
  const T* fb = feat + b * HW * C + k * kElems;
  T* o = out + (b * S * HW + q) * C + k * kElems;
  const I out_step = HW * C;
  const I row_step = (I)W * C;

#pragma unroll 2
  for (int s = 0; s < S; ++s, o += out_step) {
    const float x = __fadd_rn((float)qx, __fadd_rn(Elem<T>::load(r + 2 * s), fx));
    const float y = __fadd_rn((float)qy, __fadd_rn(Elem<T>::load(r + 2 * s + 1), fy));
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

    unsigned a00[kWords] = {}, a01[kWords] = {}, a10[kWords] = {}, a11[kWords] = {};
    if (v00 || v01 || v10 || v11) {
      // x0 in [-1, W-1] and y0 in [-1, H-1] here; a tap's address is formed
      // only when the tap is valid.
      const I p00 = ((I)(int)y0f * W + (int)x0f) * C;
      if (v00) load_chunk<V>(fb + p00, a00);
      if (v01) load_chunk<V>(fb + p00 + C, a01);
      if (v10) load_chunk<V>(fb + p00 + row_step, a10);
      if (v11) load_chunk<V>(fb + p00 + row_step + C, a11);
    }
    const float ux = __fsub_rn(1.f, wx);
    const float uy = __fsub_rn(1.f, wy);
    const float w00 = __fmul_rn(ux, uy);
    const float w01 = __fmul_rn(wx, uy);
    const float w10 = __fmul_rn(ux, wy);
    const float w11 = __fmul_rn(wx, wy);

    unsigned res[kWords] = {};
#pragma unroll
    for (int i = 0; i < kElems; ++i) {
      // A masked tap adds an exact zero in the plain version; skipping it
      // gives the same sum.
      float acc = 0.f;
      if (v00) acc = __fmul_rn(w00, Elem<T>::get(a00, i));
      if (v01) acc = __fadd_rn(acc, __fmul_rn(w01, Elem<T>::get(a01, i)));
      if (v10) acc = __fadd_rn(acc, __fmul_rn(w10, Elem<T>::get(a10, i)));
      if (v11) acc = __fadd_rn(acc, __fmul_rn(w11, Elem<T>::get(a11, i)));
      Elem<T>::put(res, i, acc);
    }
    *reinterpret_cast<typename Vec<V>::type*>(o) = Vec<V>::join(res);
  }
}

template <typename T, int V>
int launch_v(const void* feat, const void* flow, const void* residual, void* out, int B2,
             int H, int W, int C, int G, int S, int index_bits, unsigned blocks,
             cudaStream_t stream) {
  const T* f = static_cast<const T*>(feat);
  const T* fl = static_cast<const T*>(flow);
  const T* r = static_cast<const T*>(residual);
  T* o = static_cast<T*>(out);
  if (index_bits == 32)
    deformable_sample_kernel<T, V, int><<<blocks, kThreads, 0, stream>>>(
        f, fl, r, o, B2, H, W, C, G, S);
  else
    deformable_sample_kernel<T, V, long long><<<blocks, kThreads, 0, stream>>>(
        f, fl, r, o, B2, H, W, C, G, S);
  return (int)cudaGetLastError();
}

// Refuses (cudaErrorInvalidValue, nothing launched) a vector width that does
// not divide a group's bytes or the alignment of feat and out, and 32-bit
// indices for a call with an element index of 2^31 or more.
template <typename T>
int launch(const void* feat, const void* flow, const void* residual, void* out,
           int B2, int H, int W, int C, int G, int S, int vec_bytes, int index_bits,
           void* stream) {
  if (B2 <= 0 || H <= 0 || W <= 0 || C <= 0 || G <= 0 || S <= 0 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  const long long esize = (long long)sizeof(T);
  const long long group_bytes = (long long)(C / G) * esize;
  const uintptr_t align = (uintptr_t)feat | (uintptr_t)out;
  if (vec_bytes < esize || vec_bytes > 16 || (vec_bytes & (vec_bytes - 1)) != 0 ||
      group_bytes % vec_bytes != 0 || align % (uintptr_t)vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)B2 * H * W;
  const long long out_elems = pixels * S * C;
  const long long res_elems = pixels * G * S * 2;
  const long long largest = out_elems > res_elems ? out_elems : res_elems;
  if (!(index_bits == 64 || (index_bits == 32 && largest < (1LL << 31))))
    return (int)cudaErrorInvalidValue;
  const long long threads = pixels * (C * esize / vec_bytes);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (vec_bytes) {
    case 16:
      return launch_v<T, 16>(feat, flow, residual, out, B2, H, W, C, G, S, index_bits,
                             (unsigned)blocks, st);
    case 8:
      return launch_v<T, 8>(feat, flow, residual, out, B2, H, W, C, G, S, index_bits,
                            (unsigned)blocks, st);
    case 4:
      return launch_v<T, 4>(feat, flow, residual, out, B2, H, W, C, G, S, index_bits,
                            (unsigned)blocks, st);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_v<T, 2>(feat, flow, residual, out, B2, H, W, C, G, S, index_bits,
                              (unsigned)blocks, st);
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
deformable_sample_bwd_kernel(const T* __restrict__ feat, const T* __restrict__ flow,
                             const T* __restrict__ residual, const T* __restrict__ grad_out,
                             float* __restrict__ grad_feat, T* __restrict__ grad_residual,
                             float* __restrict__ grad_flow, int B2, int H, int W, int C, int G,
                             int S) {
  constexpr int kElems = V / (int)sizeof(T);
  constexpr int kWords = (V + 3) / 4;
  const I HW = (I)H * W;
  const int Cg = C / G;
  const long long t64 = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t64 >= (long long)B2 * S * H * W * G) return;
  const I t = (I)t64;
  const I row = t / G;                           // (b * S + s) * HW + q
  const int g = (int)(t - row * G);
  const I bs = row / HW;
  const I q = row - bs * HW;
  const I b = bs / S;
  const int s = (int)(bs - b * S);
  const int qy = (int)(q / W);
  const int qx = (int)(q - (I)qy * W);
  const I pix = b * HW + q;

  const float fx = Elem<T>::load(flow + 2 * pix);
  const float fy = Elem<T>::load(flow + 2 * pix + 1);
  const I r = ((pix * G + g) * S + s) * 2;
  const float x = __fadd_rn((float)qx, __fadd_rn(Elem<T>::load(residual + r), fx));
  const float y = __fadd_rn((float)qy, __fadd_rn(Elem<T>::load(residual + r + 1), fy));
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = __fsub_rn(x, x0f);
  const float wy = __fsub_rn(y, y0f);
  const bool vx0 = x0f >= 0.f && x0f <= (float)(W - 1);
  const bool vx1 = x0f >= -1.f && x0f <= (float)(W - 2);
  const bool vy0 = y0f >= 0.f && y0f <= (float)(H - 1);
  const bool vy1 = y0f >= -1.f && y0f <= (float)(H - 2);
  const bool v00 = vx0 && vy0, v01 = vx1 && vy0;
  const bool v10 = vx0 && vy1, v11 = vx1 && vy1;

  float gx = 0.f, gy = 0.f;
  if (v00 || v01 || v10 || v11) {
    const float ux = __fsub_rn(1.f, wx);
    const float uy = __fsub_rn(1.f, wy);
    const float w00 = __fmul_rn(ux, uy);
    const float w01 = __fmul_rn(wx, uy);
    const float w10 = __fmul_rn(ux, wy);
    const float w11 = __fmul_rn(wx, wy);
    // As in the forward, a tap's address is formed only when it is valid.
    const I p00 = ((I)(int)y0f * W + (int)x0f) * C + (I)g * Cg;
    const I row_step = (I)W * C;
    const T* fb = feat + b * HW * C;
    float* gf = grad_feat + b * HW * C;
    const T* go = grad_out + row * C + (I)g * Cg;
    for (int c = 0; c < Cg; c += kElems) {
      unsigned gw[kWords];
      load_chunk<V>(go + c, gw);
      unsigned a00[kWords] = {}, a01[kWords] = {}, a10[kWords] = {}, a11[kWords] = {};
      if (v00) load_chunk<V>(fb + p00 + c, a00);
      if (v01) load_chunk<V>(fb + p00 + C + c, a01);
      if (v10) load_chunk<V>(fb + p00 + row_step + c, a10);
      if (v11) load_chunk<V>(fb + p00 + row_step + C + c, a11);
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const float gv = Elem<T>::get(gw, i);
        const float f00 = Elem<T>::get(a00, i), f01 = Elem<T>::get(a01, i);
        const float f10 = Elem<T>::get(a10, i), f11 = Elem<T>::get(a11, i);
        gx += gv * (uy * (f01 - f00) + wy * (f11 - f10));
        gy += gv * (ux * (f10 - f00) + wx * (f11 - f01));
        if (v00) atomicAdd(gf + p00 + c + i, w00 * gv);
        if (v01) atomicAdd(gf + p00 + C + c + i, w01 * gv);
        if (v10) atomicAdd(gf + p00 + row_step + c + i, w10 * gv);
        if (v11) atomicAdd(gf + p00 + row_step + C + c + i, w11 * gv);
      }
    }
    atomicAdd(grad_flow + 2 * pix, gx);
    atomicAdd(grad_flow + 2 * pix + 1, gy);
  }
  grad_residual[r] = Elem<T>::from_float(gx);
  grad_residual[r + 1] = Elem<T>::from_float(gy);
}

template <typename T, int V>
int launch_bwd_v(const void* feat, const void* flow, const void* residual,
                 const void* grad_out, void* grad_feat, void* grad_residual, void* grad_flow,
                 int B2, int H, int W, int C, int G, int S, int index_bits, unsigned blocks,
                 cudaStream_t stream) {
  const T* f = static_cast<const T*>(feat);
  const T* fl = static_cast<const T*>(flow);
  const T* r = static_cast<const T*>(residual);
  const T* go = static_cast<const T*>(grad_out);
  float* gf = static_cast<float*>(grad_feat);
  T* gr = static_cast<T*>(grad_residual);
  float* gfl = static_cast<float*>(grad_flow);
  if (index_bits == 32)
    deformable_sample_bwd_kernel<T, V, int><<<blocks, kThreads, 0, stream>>>(
        f, fl, r, go, gf, gr, gfl, B2, H, W, C, G, S);
  else
    deformable_sample_bwd_kernel<T, V, long long><<<blocks, kThreads, 0, stream>>>(
        f, fl, r, go, gf, gr, gfl, B2, H, W, C, G, S);
  return (int)cudaGetLastError();
}

// The forward's refusals, with grad_out's alignment in place of out's.
template <typename T>
int launch_bwd(const void* feat, const void* flow, const void* residual, const void* grad_out,
               void* grad_feat, void* grad_residual, void* grad_flow, int B2, int H, int W,
               int C, int G, int S, int vec_bytes, int index_bits, void* stream) {
  if (B2 <= 0 || H <= 0 || W <= 0 || C <= 0 || G <= 0 || S <= 0 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  const long long esize = (long long)sizeof(T);
  const long long group_bytes = (long long)(C / G) * esize;
  const uintptr_t align = (uintptr_t)feat | (uintptr_t)grad_out;
  if (vec_bytes < esize || vec_bytes > 16 || (vec_bytes & (vec_bytes - 1)) != 0 ||
      group_bytes % vec_bytes != 0 || align % (uintptr_t)vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)B2 * H * W;
  const long long out_elems = pixels * S * C;
  const long long res_elems = pixels * G * S * 2;
  const long long largest = out_elems > res_elems ? out_elems : res_elems;
  if (!(index_bits == 64 || (index_bits == 32 && largest < (1LL << 31))))
    return (int)cudaErrorInvalidValue;
  const long long threads = pixels * S * G;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (vec_bytes) {
    case 16:
      return launch_bwd_v<T, 16>(feat, flow, residual, grad_out, grad_feat, grad_residual,
                                 grad_flow, B2, H, W, C, G, S, index_bits, (unsigned)blocks, st);
    case 8:
      return launch_bwd_v<T, 8>(feat, flow, residual, grad_out, grad_feat, grad_residual,
                                grad_flow, B2, H, W, C, G, S, index_bits, (unsigned)blocks, st);
    case 4:
      return launch_bwd_v<T, 4>(feat, flow, residual, grad_out, grad_feat, grad_residual,
                                grad_flow, B2, H, W, C, G, S, index_bits, (unsigned)blocks, st);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_bwd_v<T, 2>(feat, flow, residual, grad_out, grad_feat, grad_residual,
                                  grad_flow, B2, H, W, C, G, S, index_bits, (unsigned)blocks,
                                  st);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vfi_deformable_sample_f32(const void* feat, const void* flow,
                                         const void* residual, void* out, int B2,
                                         int H, int W, int C, int G, int S, int vec_bytes,
                                         int index_bits, void* stream) {
  return launch<float>(feat, flow, residual, out, B2, H, W, C, G, S, vec_bytes, index_bits,
                       stream);
}

extern "C" int vfi_deformable_sample_bf16(const void* feat, const void* flow,
                                          const void* residual, void* out, int B2,
                                          int H, int W, int C, int G, int S, int vec_bytes,
                                          int index_bits, void* stream) {
  return launch<__nv_bfloat16>(feat, flow, residual, out, B2, H, W, C, G, S, vec_bytes,
                               index_bits, stream);
}

// grad_feat and grad_flow: fp32 buffers of feat's and flow's shapes, zeroed
// by the caller; grad_residual: residual's shape and dtype.
extern "C" int vfi_deformable_sample_bwd_f32(const void* feat, const void* flow,
                                             const void* residual, const void* grad_out,
                                             void* grad_feat, void* grad_residual,
                                             void* grad_flow, int B2, int H, int W, int C,
                                             int G, int S, int vec_bytes, int index_bits,
                                             void* stream) {
  return launch_bwd<float>(feat, flow, residual, grad_out, grad_feat, grad_residual, grad_flow,
                           B2, H, W, C, G, S, vec_bytes, index_bits, stream);
}

extern "C" int vfi_deformable_sample_bwd_bf16(const void* feat, const void* flow,
                                              const void* residual, const void* grad_out,
                                              void* grad_feat, void* grad_residual,
                                              void* grad_flow, int B2, int H, int W, int C,
                                              int G, int S, int vec_bytes, int index_bits,
                                              void* stream) {
  return launch_bwd<__nv_bfloat16>(feat, flow, residual, grad_out, grad_feat, grad_residual,
                                   grad_flow, B2, H, W, C, G, S, vec_bytes, index_bits, stream);
}
