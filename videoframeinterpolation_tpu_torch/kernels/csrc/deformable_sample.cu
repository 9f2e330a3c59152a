// Grouped deformable bilinear sampler of the DAT levels, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   videoframeinterpolation_tpu/kernels/window_sample.py:windowed_deformable_sample
// (:158, pl.pallas_call at :240). That kernel fetched one WIN x WIN window
// per query and resolved the taps with a lane gather, because the TPU pays
// per gathered row. This one is written from the function instead:
//
//   coords  = (qx*st + (st-1)/2, qy*st + (st-1)/2)
//             + (residual[b, qy, qx, g, s] + flow[b, qy, qx])
//   out[b, s, q, g*Cg + c] = sum over the 4 bilinear taps of
//                            w_tap * m_tap * feat[b, yi, xi, g*Cg + c]
//
// with floor-based taps and a zeros mask per tap (0 <= xi <= W-1,
// 0 <= yi <= H-1), as in videoframeinterpolation_tpu/ops/interp.py:119-190.
// The queries (qy, qx) lie on an h x w grid, h = H / st and w = W / st, with
// a stride st of 1 (every DAT level of the shipped checkpoints) or more (the
// attn_stride variant's level 1: JAX _grouped_deformable_sample(..., stride),
// nn/deformable_attn.py:83-128, whose queries sit at the centres of st x st
// cells and sample the full-resolution features). The query position is
// exact in fp32 (an integer, or an integer and a half), as JAX forms it; at
// st = 1 it is (qx, qy) and every result is what it was before the stride.
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
// Layout: feat (B2, H, W, C), flow (B2, h, w, 2), residual (B2, h, w, G, S, 2),
// out (B2, S, h*w, C), all contiguous; G divides C, st divides H and W.
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
// _grouped_deformable_sample with XLA's autodiff, nn/deformable_attn.py:83).
// Given g = d loss / d out it returns
//
//   grad_feat[b, tap, c] = sum over the (s, q) whose valid tap lands there
//                          of w_tap * g[b, s, q, c]
//   d out / d x = sum_c g[c] * ((1-wy) (v01 - v00) + wy (v11 - v10))
//   d out / d y = sum_c g[c] * ((1-wx) (v10 - v00) + wx (v11 - v01))
//
// with a masked tap's value taken as 0 (ops/interp.py:175-187 masks the
// weights; the derivative of a masked weight's term is then 0 too):
// grad_residual[b, q, g, s] is (d out / d x, d out / d y) over the group's
// channels and grad_flow[b, q] its sum over (G, S), since coords = q +
// (residual + flow). Every product and sum is fp32 and each result is
// rounded once to the inputs' dtype (JAX's autodiff rounds in bf16 along the
// way). One C entry point per dtype launches two kernels, each recomputing
// the forward's coordinates, taps and weights exactly:
//
// 1. The coordinate kernel: one thread per (b, q, V-byte chunk), the
//    forward's layout and widths, looping over the S samples; the chunks of
//    a (pixel, group) are summed in shared memory in a fixed order, and a
//    pixel's group sums, again in a fixed order, into grad_flow. No atomics:
//    grad_residual and grad_flow are the same bits on every run.
// 2. The feature kernel, on the path the wrapper plans per call
//    (kernels/window_sample.py:_backward_plan):
//    - shared memory: one block per (b, slice of K channels of one group)
//      holds the slice's fp32 gradient for the whole image (H * W * K * 4
//      bytes; the plan leaves room for two blocks per SM and sizes the grid
//      to one wave), adds every tap of every sample of the image into it
//      with shared-memory atomics, a row of K lanes per (s, q) row, and
//      writes it once in the inputs' dtype. No buffer is zeroed, nothing is
//      cast.
//    - global, where even a one-channel slice leaves no room for two blocks
//      per SM (every level of a 1080p request): one thread per (b, s, q, g)
//      adds into an fp32 buffer, zeroed by the caller, with global atomics,
//      and the caller rounds it once.
//    Atomics on either path add in an order that changes from run to run,
//    so grad_feat is not bit-reproducible.
// The feature kernel runs on a side stream forked from the caller's, the
// coordinate kernel on the caller's stream beside it (side_stream below).
//
// What bounds it: the shared-memory atomics of the feature kernel. sm_90 has
// no fp32 add in shared memory: atomicAdd compiles to a load and a
// compare-and-swap loop (LDS, ATOMS.CAST.SPIN), and random taps put several
// lanes of a warp in one bank. A row of K lanes per (s, q) row, a grid of
// one wave and the coordinate kernel beside it are what the measurements
// favoured (PERF.md, section 6, has the designs tried and their times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

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

// A query's position on the feature grid along one axis, as JAX forms it:
// j * st + (st - 1) / 2 in fp32 (nn/deformable_attn.py:108-114). Both terms
// and the sum are exact (integers and halves far below 2^23); at st = 1 it
// is (float)j.
__device__ __forceinline__ float query_pos(int j, int st) {
  return __fadd_rn((float)(j * st), 0.5f * (float)(st - 1));
}

// T: float or __nv_bfloat16; V: bytes per chunk; I: int or long long, wide
// enough for every element index of the call.
template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
deformable_sample_kernel(const T* __restrict__ feat, const T* __restrict__ flow,
                         const T* __restrict__ residual, T* __restrict__ out,
                         int B2, int H, int W, int C, int G, int S, int st) {
  constexpr int kElems = V / (int)sizeof(T);
  constexpr int kWords = (V + 3) / 4;
  const int h = H / st, w = W / st;              // the query grid
  const I HW = (I)H * W;
  const I hw = (I)h * w;
  const int chunks = C / kElems;                 // per pixel
  const long long t64 = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t64 >= (long long)B2 * h * w * chunks) return;
  const I t = (I)t64;
  const I pix = t / chunks;                      // b * hw + q
  const int k = (int)(t - pix * chunks);
  const I b = pix / hw;
  const I q = pix - b * hw;
  const int qy = (int)(q / w);
  const int qx = (int)(q - (I)qy * w);
  const int g = k / (chunks / G);
  const float bx = query_pos(qx, st), by = query_pos(qy, st);

  const float fx = Elem<T>::load(flow + 2 * pix);
  const float fy = Elem<T>::load(flow + 2 * pix + 1);
  const T* r = residual + (pix * G + g) * S * 2;
  const T* fb = feat + b * HW * C + k * kElems;
  T* o = out + (b * S * hw + q) * C + k * kElems;
  const I out_step = hw * C;
  const I row_step = (I)W * C;

#pragma unroll 2
  for (int s = 0; s < S; ++s, o += out_step) {
    const float x = __fadd_rn(bx, __fadd_rn(Elem<T>::load(r + 2 * s), fx));
    const float y = __fadd_rn(by, __fadd_rn(Elem<T>::load(r + 2 * s + 1), fy));
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
             int H, int W, int C, int G, int S, int st, int index_bits, unsigned blocks,
             cudaStream_t stream) {
  const T* f = static_cast<const T*>(feat);
  const T* fl = static_cast<const T*>(flow);
  const T* r = static_cast<const T*>(residual);
  T* o = static_cast<T*>(out);
  if (index_bits == 32)
    deformable_sample_kernel<T, V, int><<<blocks, kThreads, 0, stream>>>(
        f, fl, r, o, B2, H, W, C, G, S, st);
  else
    deformable_sample_kernel<T, V, long long><<<blocks, kThreads, 0, stream>>>(
        f, fl, r, o, B2, H, W, C, G, S, st);
  return (int)cudaGetLastError();
}

// The largest element count of the call's tensors: out (B2, S, h*w, C), the
// residual (B2, h, w, G, S, 2) and, on a strided grid, feat (B2, H, W, C).
long long largest_tensor(int B2, int H, int W, int C, int G, int S, int st) {
  const long long queries = (long long)B2 * (H / st) * (W / st);
  const long long out_elems = queries * S * C;
  const long long res_elems = queries * G * S * 2;
  const long long feat_elems = (long long)B2 * H * W * C;
  const long long most = out_elems > res_elems ? out_elems : res_elems;
  return most > feat_elems ? most : feat_elems;
}

// Refuses (cudaErrorInvalidValue, nothing launched) a stride that does not
// divide H and W, a vector width that does not divide a group's bytes or the
// alignment of feat and out, and 32-bit indices for a call with an element
// index of 2^31 or more.
template <typename T>
int launch(const void* feat, const void* flow, const void* residual, void* out,
           int B2, int H, int W, int C, int G, int S, int st, int vec_bytes, int index_bits,
           void* stream) {
  if (B2 <= 0 || H <= 0 || W <= 0 || C <= 0 || G <= 0 || S <= 0 || C % G != 0 || st <= 0 ||
      H % st != 0 || W % st != 0)
    return (int)cudaErrorInvalidValue;
  const long long esize = (long long)sizeof(T);
  const long long group_bytes = (long long)(C / G) * esize;
  const uintptr_t align = (uintptr_t)feat | (uintptr_t)out;
  if (vec_bytes < esize || vec_bytes > 16 || (vec_bytes & (vec_bytes - 1)) != 0 ||
      group_bytes % vec_bytes != 0 || align % (uintptr_t)vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)B2 * (H / st) * (W / st);   // queries
  const long long largest = largest_tensor(B2, H, W, C, G, S, st);
  if (!(index_bits == 64 || (index_bits == 32 && largest < (1LL << 31))))
    return (int)cudaErrorInvalidValue;
  const long long threads = pixels * (C * esize / vec_bytes);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t cs = (cudaStream_t)stream;
  switch (vec_bytes) {
    case 16:
      return launch_v<T, 16>(feat, flow, residual, out, B2, H, W, C, G, S, st, index_bits,
                             (unsigned)blocks, cs);
    case 8:
      return launch_v<T, 8>(feat, flow, residual, out, B2, H, W, C, G, S, st, index_bits,
                            (unsigned)blocks, cs);
    case 4:
      return launch_v<T, 4>(feat, flow, residual, out, B2, H, W, C, G, S, st, index_bits,
                            (unsigned)blocks, cs);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_v<T, 2>(feat, flow, residual, out, B2, H, W, C, G, S, st, index_bits,
                              (unsigned)blocks, cs);
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- backward

// The card's figures and the feature kernel's block size come from the build
// (kernels/build.py: DEFINES), which the launch plan in Python reads too.
#if !defined(VFI_THREADS_PER_SM) || !defined(VFI_SMEM_PER_BLOCK) || \
    !defined(VFI_BWD_FEAT_THREADS)
#error "build with kernels/build.py, which defines the VFI_ constants"
#endif
constexpr int kCoordThreads = 256;   // most threads a block of the coordinate kernel has
constexpr int kFeatThreads = VFI_BWD_FEAT_THREADS;   // at most, per block of the smem feature kernel
constexpr int kMaxSmem = VFI_SMEM_PER_BLOCK;         // the most dynamic shared memory a block may have
// The plan counts on as many feature blocks per SM as threads and shared
// memory allow; this many per SM (its __launch_bounds__) keeps the register
// file from holding fewer.
constexpr int kFeatMinBlocks = VFI_THREADS_PER_SM / kFeatThreads;
constexpr int kPathGlobal = 0;
constexpr int kPathSmem = 1;

// One sample's taps and weights, computed exactly as the forward computes
// them: the same query position (bx, by), the same _rn chain, the same
// float-based validity tests. x0, y0 are set only when a tap is valid (they
// are in [-1, W-1] and [-1, H-1] then), so a coordinate that would overflow
// an int never forms an address.
struct Taps {
  float wx, wy, ux, uy, w00, w01, w10, w11;
  bool v00, v01, v10, v11, any;
  int x0, y0;
};

__device__ __forceinline__ Taps taps_at(float bx, float by, float rx, float ry, float fx,
                                        float fy, int H, int W) {
  Taps t;
  const float x = __fadd_rn(bx, __fadd_rn(rx, fx));
  const float y = __fadd_rn(by, __fadd_rn(ry, fy));
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  t.wx = __fsub_rn(x, x0f);
  t.wy = __fsub_rn(y, y0f);
  const bool vx0 = x0f >= 0.f && x0f <= (float)(W - 1);
  const bool vx1 = x0f >= -1.f && x0f <= (float)(W - 2);
  const bool vy0 = y0f >= 0.f && y0f <= (float)(H - 1);
  const bool vy1 = y0f >= -1.f && y0f <= (float)(H - 2);
  t.v00 = vx0 && vy0;
  t.v01 = vx1 && vy0;
  t.v10 = vx0 && vy1;
  t.v11 = vx1 && vy1;
  t.any = t.v00 || t.v01 || t.v10 || t.v11;
  t.x0 = t.any ? (int)x0f : 0;
  t.y0 = t.any ? (int)y0f : 0;
  t.ux = __fsub_rn(1.f, t.wx);
  t.uy = __fsub_rn(1.f, t.wy);
  t.w00 = __fmul_rn(t.ux, t.uy);
  t.w01 = __fmul_rn(t.wx, t.uy);
  t.w10 = __fmul_rn(t.ux, t.wy);
  t.w11 = __fmul_rn(t.wx, t.wy);
  return t;
}

// The coordinate gradients. A block holds P whole pixels, each as its C / kElems
// chunks in neighbouring threads (the forward's layout); a chunk lies in one
// group. Per sample each thread forms its chunk's partial (gx, gy); the
// first thread of each (pixel, group) sums its group's chunks in order and
// writes grad_residual, and the pixel's first thread adds the G group sums,
// in order, into grad_flow's fp32 sum, written once after the last sample.
template <typename T, int V, typename I>
__global__ void __launch_bounds__(kCoordThreads)
deformable_sample_bwd_coord_kernel(const T* __restrict__ feat, const T* __restrict__ flow,
                                   const T* __restrict__ residual,
                                   const T* __restrict__ grad_out,
                                   T* __restrict__ grad_residual, T* __restrict__ grad_flow,
                                   int B2, int H, int W, int C, int G, int S, int st) {
  constexpr int kElems = V / (int)sizeof(T);
  constexpr int kWords = (V + 3) / 4;
  __shared__ float2 part[kCoordThreads];        // each thread's chunk sum
  __shared__ float2 group_sum[kCoordThreads];   // each (pixel, group) sum of the block
  const int chunks = C / kElems;                // per pixel
  const int per_group = chunks / G;
  const int P = blockDim.x / chunks;            // pixels per block
  const int p = threadIdx.x / chunks;
  const int k = threadIdx.x - p * chunks;
  const int g = k / per_group;
  const int h = H / st, w = W / st;             // the query grid
  const I HW = (I)H * W;
  const I hw = (I)h * w;
  const I pix = (I)blockIdx.x * P + p;          // b * hw + q
  const bool active = (long long)blockIdx.x * P + p < (long long)B2 * h * w;
  I b = 0, q = 0;
  int qx = 0, qy = 0;
  float fx = 0.f, fy = 0.f;
  if (active) {
    b = pix / hw;
    q = pix - b * hw;
    qy = (int)(q / w);
    qx = (int)(q - (I)qy * w);
    fx = Elem<T>::load(flow + 2 * pix);
    fy = Elem<T>::load(flow + 2 * pix + 1);
  }
  const float bx = query_pos(qx, st), by = query_pos(qy, st);
  const I r0 = active ? (pix * G + g) * S * 2 : 0;
  const T* fb = feat + b * HW * C + k * kElems;
  const T* go = grad_out + (b * S * hw + q) * C + k * kElems;
  const I go_step = hw * C;
  const I row_step = (I)W * C;
  const bool group_lead = active && k == g * per_group;
  float flow_x = 0.f, flow_y = 0.f;

  for (int s = 0; s < S; ++s, go += go_step) {
    float gx = 0.f, gy = 0.f;
    if (active) {
      const Taps t = taps_at(bx, by, Elem<T>::load(residual + r0 + 2 * s),
                             Elem<T>::load(residual + r0 + 2 * s + 1), fx, fy, H, W);
      if (t.any) {
        const I p00 = ((I)t.y0 * W + t.x0) * C;
        unsigned gw[kWords];
        load_chunk<V>(go, gw);
        unsigned a00[kWords] = {}, a01[kWords] = {}, a10[kWords] = {}, a11[kWords] = {};
        if (t.v00) load_chunk<V>(fb + p00, a00);
        if (t.v01) load_chunk<V>(fb + p00 + C, a01);
        if (t.v10) load_chunk<V>(fb + p00 + row_step, a10);
        if (t.v11) load_chunk<V>(fb + p00 + row_step + C, a11);
#pragma unroll
        for (int i = 0; i < kElems; ++i) {
          // A masked tap's value counts as 0: its weight is masked, so the
          // derivative of its term is 0 too (ops/interp.py:175-187).
          const float gv = Elem<T>::get(gw, i);
          const float f00 = Elem<T>::get(a00, i), f01 = Elem<T>::get(a01, i);
          const float f10 = Elem<T>::get(a10, i), f11 = Elem<T>::get(a11, i);
          gx += gv * (t.uy * (f01 - f00) + t.wy * (f11 - f10));
          gy += gv * (t.ux * (f10 - f00) + t.wx * (f11 - f01));
        }
      }
    }
    part[threadIdx.x] = make_float2(gx, gy);
    __syncthreads();
    if (group_lead) {
      float sx = 0.f, sy = 0.f;
      for (int j = 0; j < per_group; ++j) {
        sx += part[threadIdx.x + j].x;
        sy += part[threadIdx.x + j].y;
      }
      grad_residual[r0 + 2 * s] = Elem<T>::from_float(sx);
      grad_residual[r0 + 2 * s + 1] = Elem<T>::from_float(sy);
      group_sum[p * G + g] = make_float2(sx, sy);
    }
    __syncthreads();
    // part is written again only after every group's sum has been read
    // (above), and group_sum only after the next barrier, which this
    // thread reaches after reading it.
    if (active && k == 0) {
      for (int j = 0; j < G; ++j) {
        flow_x += group_sum[p * G + j].x;
        flow_y += group_sum[p * G + j].y;
      }
    }
  }
  if (active && k == 0) {
    grad_flow[2 * pix] = Elem<T>::from_float(flow_x);
    grad_flow[2 * pix + 1] = Elem<T>::from_float(flow_y);
  }
}

// grad_feat, shared-memory path. A block owns K channels of one image (the
// slice lies in one group) and holds their fp32 gradient for every pixel of
// the feature grid in dynamic shared memory, pixel-major (acc[pixel * K +
// k]). Its threads stand in rows of K lanes, one lane per channel: each row
// of lanes takes one (s, q) row of the image at a time (q on the query
// grid), recomputes its taps, reads its channel of g and adds w_tap * g into
// shared memory, so that the lanes of one row hit K neighbouring words. Then
// the block writes the slice once, rounded to T, zeros included.
// Shared-memory indices are 32-bit (HW * K * 4 <= 227 KB); global ones are I.
template <typename T, typename I>
__global__ void __launch_bounds__(kFeatThreads, kFeatMinBlocks)
deformable_sample_bwd_feat_smem_kernel(const T* __restrict__ flow,
                                        const T* __restrict__ residual,
                                        const T* __restrict__ grad_out,
                                        T* __restrict__ grad_feat, int H, int W, int C, int G,
                                        int S, int st, int K) {
  extern __shared__ float acc[];
  const int HW = H * W;
  const int w = W / st;
  const int hw = (H / st) * w;                  // the query grid
  const int slices = C / K;
  const int b = blockIdx.x / slices;
  const int c0 = (blockIdx.x - b * slices) * K;
  const int g = c0 / (C / G);
  for (int e = threadIdx.x; e < K * HW; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();
  const int c = threadIdx.x % K;
  const int step = blockDim.x / K;
  const T* fl = flow + (I)b * hw * 2;
  const T* res = residual + ((I)b * hw * G + g) * S * 2;
  const T* go = grad_out + (I)b * S * hw * C + c0 + c;
  const int rows = S * hw;
  for (int row = threadIdx.x / K; row < rows; row += step) {
    const int s = row / hw;
    const int q = row - s * hw;
    const int qy = q / w;
    const int qx = q - qy * w;
    const T* r = res + ((I)q * G * S + s) * 2;
    const Taps t = taps_at(query_pos(qx, st), query_pos(qy, st), Elem<T>::load(r),
                           Elem<T>::load(r + 1), Elem<T>::load(fl + 2 * q),
                           Elem<T>::load(fl + 2 * q + 1), H, W);
    if (!t.any) continue;
    const float gv = Elem<T>::load(go + ((I)s * hw + q) * C);
    float* a = acc + (t.y0 * W + t.x0) * K + c;
    if (t.v00) atomicAdd(a, t.w00 * gv);
    if (t.v01) atomicAdd(a + K, t.w01 * gv);
    if (t.v10) atomicAdd(a + W * K, t.w10 * gv);
    if (t.v11) atomicAdd(a + (W + 1) * K, t.w11 * gv);
  }
  __syncthreads();
  T* gf = grad_feat + (I)b * HW * C + c0;
  for (int e = threadIdx.x; e < K * HW; e += blockDim.x) {
    const int px = e / K;
    gf[(I)px * C + (e - px * K)] = Elem<T>::from_float(acc[e]);
  }
}

// grad_feat, global path, for images whose one-channel slice does not leave
// room for two blocks per SM: one thread per (b, s, q, g), q (on the query
// grid) fastest, loops over the group's channels and adds w_tap * g into an
// fp32 buffer of the feature grid, zeroed by the caller, with global atomics.
template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
deformable_sample_bwd_feat_global_kernel(const T* __restrict__ flow,
                                         const T* __restrict__ residual,
                                         const T* __restrict__ grad_out,
                                         float* __restrict__ grad_feat, int B2, int H, int W,
                                         int C, int G, int S, int st) {
  constexpr int kElems = V / (int)sizeof(T);
  constexpr int kWords = (V + 3) / 4;
  const int h = H / st, w = W / st;              // the query grid
  const I HW = (I)H * W;
  const I hw = (I)h * w;
  const int Cg = C / G;
  const long long t64 = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t64 >= (long long)B2 * S * h * w * G) return;
  const I t = (I)t64;
  const I row = t / G;                           // (b * S + s) * hw + q
  const int g = (int)(t - row * G);
  const I bs = row / hw;
  const I q = row - bs * hw;
  const I b = bs / S;
  const int s = (int)(bs - b * S);
  const int qy = (int)(q / w);
  const int qx = (int)(q - (I)qy * w);
  const I pix = b * hw + q;
  const I r = ((pix * G + g) * S + s) * 2;
  const Taps tp = taps_at(query_pos(qx, st), query_pos(qy, st), Elem<T>::load(residual + r),
                          Elem<T>::load(residual + r + 1), Elem<T>::load(flow + 2 * pix),
                          Elem<T>::load(flow + 2 * pix + 1), H, W);
  if (!tp.any) return;
  const I p00 = ((I)tp.y0 * W + tp.x0) * C + (I)g * Cg;
  const I row_step = (I)W * C;
  float* gf = grad_feat + b * HW * C + p00;
  const T* go = grad_out + row * C + (I)g * Cg;
  for (int c = 0; c < Cg; c += kElems) {
    unsigned gw[kWords];
    load_chunk<V>(go + c, gw);
#pragma unroll
    for (int i = 0; i < kElems; ++i) {
      const float gv = Elem<T>::get(gw, i);
      if (tp.v00) atomicAdd(gf + c + i, tp.w00 * gv);
      if (tp.v01) atomicAdd(gf + C + c + i, tp.w01 * gv);
      if (tp.v10) atomicAdd(gf + row_step + c + i, tp.w10 * gv);
      if (tp.v11) atomicAdd(gf + row_step + C + c + i, tp.w11 * gv);
    }
  }
}

// Calls fn with std::integral_constant<int, vec_bytes>; refuses a width
// that has no instance.
template <typename T, typename Fn>
int with_vector(int vec_bytes, Fn&& fn) {
  switch (vec_bytes) {
    case 16: return fn(std::integral_constant<int, 16>());
    case 8: return fn(std::integral_constant<int, 8>());
    case 4: return fn(std::integral_constant<int, 4>());
    default:
      if constexpr (sizeof(T) == 2)
        if (vec_bytes == 2) return fn(std::integral_constant<int, 2>());
      return (int)cudaErrorInvalidValue;
  }
}

// A second stream, of the device's highest priority, and two events for
// each host thread and device, made at the thread's first call on the device
// and kept for the thread's life. The feature kernel runs on it, forked from
// and joined back into the caller's stream, and the coordinate kernel on the
// caller's stream after it: the block scheduler places the feature kernel's
// blocks first (its grid is sized to one wave), and the coordinate kernel's
// blocks fill what is left of the SMs (the one is bound by shared-memory
// atomics, the other by L2). The fork and the join are stream-ordered
// calls, which a CUDA graph captures as a fork and a join. Each thread has
// its own events, so a fork recorded by one thread is never the one another
// thread waits for, and its own stream, so calls from two threads never
// queue behind each other; calls from one thread on two of its streams
// share the side stream and are serialised on it.
struct SideStream {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
  cudaError_t err = cudaErrorNotReady;   // not made yet
};

const SideStream& side_stream() {
  constexpr int kMaxDevices = 64;
  thread_local SideStream sides[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    thread_local SideStream bad;
    bad.err = cudaErrorInvalidDevice;
    return bad;
  }
  SideStream& s = sides[dev];
  if (s.err == cudaErrorNotReady) {
    int least = 0, greatest = 0;
    s.err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    if (s.err == cudaSuccess)
      s.err = cudaStreamCreateWithPriority(&s.stream, cudaStreamNonBlocking, greatest);
    if (s.err == cudaSuccess) s.err = cudaEventCreateWithFlags(&s.fork, cudaEventDisableTiming);
    if (s.err == cudaSuccess) s.err = cudaEventCreateWithFlags(&s.join, cudaEventDisableTiming);
  }
  return s;
}

// Lets every instance of the shared-memory kernel take up to 227 KB, once
// per instance, before its first launch (a host call, not a stream
// operation).
template <typename T, typename I>
int allow_feat_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      deformable_sample_bwd_feat_smem_kernel<T, I>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return (int)err;
}

template <typename T, typename I>
int launch_bwd_i(const T* feat, const T* flow, const T* residual, const T* grad_out,
                 void* grad_feat, T* grad_residual, T* grad_flow, int B2, int H, int W, int C,
                 int G, int S, int st, int vec_bytes, int path, int K, unsigned coord_blocks,
                 int coord_threads, unsigned feat_blocks, int smem, cudaStream_t cs) {
  if (path == kPathSmem) {
    const int err = allow_feat_smem<T, I>();
    if (err != 0) return err;
  }
  const SideStream& side = side_stream();
  if (side.err != cudaSuccess) return (int)side.err;
  int err = (int)cudaEventRecord(side.fork, cs);
  if (err == 0) err = (int)cudaStreamWaitEvent(side.stream, side.fork, 0);
  if (err != 0) return err;
  if (path == kPathSmem) {
    deformable_sample_bwd_feat_smem_kernel<T, I><<<feat_blocks, (kFeatThreads / K) * K, smem,
                                                   side.stream>>>(
        flow, residual, grad_out, static_cast<T*>(grad_feat), H, W, C, G, S, st, K);
    err = (int)cudaGetLastError();
  } else {
    err = with_vector<T>(vec_bytes, [&](auto v) {
      constexpr int V = decltype(v)::value;
      deformable_sample_bwd_feat_global_kernel<T, V, I><<<feat_blocks, kThreads, 0,
                                                          side.stream>>>(
          flow, residual, grad_out, static_cast<float*>(grad_feat), B2, H, W, C, G, S, st);
      return (int)cudaGetLastError();
    });
  }
  if (err == 0)
    err = with_vector<T>(vec_bytes, [&](auto v) {
      constexpr int V = decltype(v)::value;
      deformable_sample_bwd_coord_kernel<T, V, I><<<coord_blocks, coord_threads, 0, cs>>>(
          feat, flow, residual, grad_out, grad_residual, grad_flow, B2, H, W, C, G, S, st);
      return (int)cudaGetLastError();
    });
  // Join even after a failed launch, so that the caller's stream never
  // leaves the side stream behind (a capture would otherwise end unjoined).
  const int joined = (int)cudaEventRecord(side.join, side.stream);
  const int waited = joined == 0 ? (int)cudaStreamWaitEvent(cs, side.join, 0) : joined;
  return err != 0 ? err : waited;
}

// The forward's refusals, with grad_out's alignment in place of out's, and
// the plan's: a path other than global (0) or shared memory (1); on the
// shared-memory path a slice of K channels that does not divide a group,
// whose H * W * K fp32 values exceed 227 KB, or that is wider than a
// block; more than 256 chunks per pixel. Nothing is launched then.
template <typename T>
int launch_bwd(const void* feat, const void* flow, const void* residual, const void* grad_out,
               void* grad_feat, void* grad_residual, void* grad_flow, int B2, int H, int W,
               int C, int G, int S, int st, int vec_bytes, int index_bits, int path, int K,
               void* stream) {
  if (B2 <= 0 || H <= 0 || W <= 0 || C <= 0 || G <= 0 || S <= 0 || C % G != 0 || st <= 0 ||
      H % st != 0 || W % st != 0)
    return (int)cudaErrorInvalidValue;
  const long long esize = (long long)sizeof(T);
  const long long group_bytes = (long long)(C / G) * esize;
  const uintptr_t align = (uintptr_t)feat | (uintptr_t)grad_out;
  if (vec_bytes < esize || vec_bytes > 16 || (vec_bytes & (vec_bytes - 1)) != 0 ||
      group_bytes % vec_bytes != 0 || align % (uintptr_t)vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)B2 * (H / st) * (W / st);   // queries
  const long long largest = largest_tensor(B2, H, W, C, G, S, st);
  if (!(index_bits == 64 || (index_bits == 32 && largest < (1LL << 31))))
    return (int)cudaErrorInvalidValue;
  const long long chunks = C * esize / vec_bytes;
  if (chunks > kCoordThreads) return (int)cudaErrorInvalidValue;
  const int per_block = kCoordThreads / (int)chunks;
  const long long coord_blocks = (pixels + per_block - 1) / per_block;
  long long feat_blocks = 0, smem = 0;
  if (path == kPathSmem) {
    smem = (long long)H * W * K * 4;
    if (K <= 0 || K > kFeatThreads || (C / G) % K != 0 || smem > kMaxSmem)
      return (int)cudaErrorInvalidValue;
    feat_blocks = (long long)B2 * (C / K);
  } else if (path == kPathGlobal) {
    feat_blocks = (pixels * S * G + kThreads - 1) / kThreads;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (coord_blocks > INT_MAX || feat_blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const T* f = static_cast<const T*>(feat);
  const T* fl = static_cast<const T*>(flow);
  const T* r = static_cast<const T*>(residual);
  const T* go = static_cast<const T*>(grad_out);
  T* gr = static_cast<T*>(grad_residual);
  T* gfl = static_cast<T*>(grad_flow);
  const cudaStream_t cs = (cudaStream_t)stream;
  if (index_bits == 32)
    return launch_bwd_i<T, int>(f, fl, r, go, grad_feat, gr, gfl, B2, H, W, C, G, S, st,
                                vec_bytes, path, K, (unsigned)coord_blocks,
                                per_block * (int)chunks, (unsigned)feat_blocks, (int)smem, cs);
  return launch_bwd_i<T, long long>(f, fl, r, go, grad_feat, gr, gfl, B2, H, W, C, G, S, st,
                                    vec_bytes, path, K, (unsigned)coord_blocks,
                                    per_block * (int)chunks, (unsigned)feat_blocks, (int)smem,
                                    cs);
}

}  // namespace

// H, W: the feature grid; st: the query grid's stride over it (the query grid
// is H / st x W / st; 1 where every pixel is a query).
extern "C" int vfi_deformable_sample_f32(const void* feat, const void* flow,
                                         const void* residual, void* out, int B2,
                                         int H, int W, int C, int G, int S, int st,
                                         int vec_bytes, int index_bits, void* stream) {
  return launch<float>(feat, flow, residual, out, B2, H, W, C, G, S, st, vec_bytes, index_bits,
                       stream);
}

extern "C" int vfi_deformable_sample_bf16(const void* feat, const void* flow,
                                          const void* residual, void* out, int B2,
                                          int H, int W, int C, int G, int S, int st,
                                          int vec_bytes, int index_bits, void* stream) {
  return launch<__nv_bfloat16>(feat, flow, residual, out, B2, H, W, C, G, S, st, vec_bytes,
                               index_bits, stream);
}

// grad_feat: on the shared-memory path (path 1) feat's shape and dtype; on
// the global path (path 0) an fp32 buffer of feat's shape, zeroed by the
// caller. grad_residual and grad_flow: residual's and flow's shapes (the
// query grid), in the inputs' dtype. K: the shared-memory path's channels
// per block.
extern "C" int vfi_deformable_sample_bwd_f32(const void* feat, const void* flow,
                                             const void* residual, const void* grad_out,
                                             void* grad_feat, void* grad_residual,
                                             void* grad_flow, int B2, int H, int W, int C,
                                             int G, int S, int st, int vec_bytes,
                                             int index_bits, int path, int K, void* stream) {
  return launch_bwd<float>(feat, flow, residual, grad_out, grad_feat, grad_residual, grad_flow,
                           B2, H, W, C, G, S, st, vec_bytes, index_bits, path, K, stream);
}

extern "C" int vfi_deformable_sample_bwd_bf16(const void* feat, const void* flow,
                                              const void* residual, const void* grad_out,
                                              void* grad_feat, void* grad_residual,
                                              void* grad_flow, int B2, int H, int W, int C,
                                              int G, int S, int st, int vec_bytes,
                                              int index_bits, int path, int K, void* stream) {
  return launch_bwd<__nv_bfloat16>(feat, flow, residual, grad_out, grad_feat, grad_residual,
                                   grad_flow, B2, H, W, C, G, S, st, vec_bytes, index_bits, path,
                                   K, stream);
}
