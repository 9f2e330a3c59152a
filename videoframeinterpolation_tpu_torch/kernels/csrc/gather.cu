// Row and lane gathers of a 2-D table, for Hopper (sm_90a).
//
// Replace the TPU kernels of the two Pallas probes of tools/perf:
//   tools/perf/pallas_gather_probe.py:make_gather (pl.pallas_call at :17):
//     row gather, out[i, j] = x[idx[i, j], j]   (take_along_axis, axis 0);
//   tools/perf/pallas_lane_gather_probe.py:make (pl.pallas_call at :20):
//     lane gather, out[i, j] = x[i, idx[i, j]]  (take_along_axis, axis 1).
// On the TPU both held the whole table in one VMEM block and asked Mosaic
// for a dynamic gather across sublanes or lanes. Hopper has no such block.
//
// Layout: x (M, N), idx int32, out in x's type, all contiguous.
//   row gather:  idx (K, N) with values in [0, M), out (K, N);
//   lane gather: idx (M, K) with values in [0, N), out (M, K).
// The indices must be in range; the kernels do not check them (the caller
// states the precondition, and a device-side check would cost a sync).
//
// Row gather: one thread per output element, j fastest, so the reads of
// idx and the writes of out coalesce. What bounds it on this card: bytes
// (no arithmetic), x, idx and out each crossing memory once. At the
// probe's largest shape (M 28672, N 128, fp32) they are 14.7 MB each, 44 MB
// together, which the 50 MB L2 holds while the probe replays the call, so
// the rate that counts is L2's. Each read of x comes from a random row and
// costs a whole 32-byte sector for 4 useful bytes (2 in bf16): 3.67 M
// sectors at that shape, 117 MB of L2 traffic for 14.7 MB of table. No
// order of threads fixes that, since idx[i, j] differs for every j; and
// measured on the H100, what counts is requests, not bytes: each SM
// completes about one L2 request per 1.1 ns however the requests fall,
// which gives the kernel's time at every probe shape (about 40% of the
// bytes bound). Wider chunks per thread (8 or 16 bytes of out) were no
// faster. Holding 32-byte column strips of the table in the shared memory
// of a thread-block cluster was built and measured too: a random read of
// a peer block's shared memory costs an SM 3.5-4.5 times an L2 request,
// and a one-block cluster must first load its whole strip, so it wins only
// where a call gathers at least four times as many rows as the table has,
// which no caller does (PERF.md). Index math is 32-bit unless an index of
// the call reaches 2^31 (the wrapper picks the width; a width the call
// does not fit is refused with cudaErrorInvalidValue).
//
// Lane gather: one warp per row, lanes over j; a warp's reads of x fall in
// one row of N elements, so they are served from a few cache lines.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

// I is the type of the element indices: unsigned where every index of the
// call (and e, which may pass the last by one block) is below 2^32.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                  T* __restrict__ out, I total, int N) {
  const I e = (I)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const I j = e % (I)N;
  out[e] = __ldg(x + (I)__ldg(idx + e) * (I)N + j);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                   T* __restrict__ out, int M, int N, int K) {
  const long long i = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= M) return;
  const T* xrow = x + i * N;
  const int* irow = idx + i * K;
  T* orow = out + i * K;
  for (int j = threadIdx.x & 31; j < K; j += 32) orow[j] = xrow[irow[j]];
}

// Refuse an index width the call does not fit; launch the rest.
template <typename T>
int launch_row(const void* x, const void* idx, void* out, int M, int N, int K, int index_bits,
               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)K * N;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const int* it = static_cast<const int*>(idx);
  T* ot = static_cast<T*>(out);
  if (index_bits == 32) {
    if (total >= (1LL << 31) || (long long)M * N >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    row_gather_kernel<T, unsigned><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        xt, it, ot, (unsigned)total, N);
  } else if (index_bits == 64) {
    row_gather_kernel<T, long long><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        xt, it, ot, total, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lane(const void* x, const void* idx, void* out, int M, int N, int K,
                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)M + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lane_gather_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx), static_cast<T*>(out),
      M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Row gather with 32- or 64-bit index math (index_bits).
extern "C" int vfi_row_gather_f32(const void* x, const void* idx, void* out, int M, int N, int K,
                                  int index_bits, void* stream) {
  return launch_row<float>(x, idx, out, M, N, K, index_bits, stream);
}

extern "C" int vfi_row_gather_bf16(const void* x, const void* idx, void* out, int M, int N, int K,
                                   int index_bits, void* stream) {
  return launch_row<__nv_bfloat16>(x, idx, out, M, N, K, index_bits, stream);
}

extern "C" int vfi_lane_gather_f32(const void* x, const void* idx, void* out, int M,
                                   int N, int K, void* stream) {
  return launch_lane<float>(x, idx, out, M, N, K, stream);
}

extern "C" int vfi_lane_gather_bf16(const void* x, const void* idx, void* out, int M,
                                    int N, int K, void* stream) {
  return launch_lane<__nv_bfloat16>(x, idx, out, M, N, K, stream);
}
