// Row and lane gathers of a 2-D table, for Hopper (sm_90a).
//
// Replace the TPU kernels of the two Pallas probes of tools/perf:
//   tools/perf/pallas_gather_probe.py:make_gather (pl.pallas_call at :17):
//     row gather, out[i, j] = x[idx[i, j], j]   (take_along_axis, axis 0);
//   tools/perf/pallas_lane_gather_probe.py:make (pl.pallas_call at :20):
//     lane gather, out[i, j] = x[i, idx[i, j]]  (take_along_axis, axis 1).
// On the TPU both held the whole table in one VMEM block and asked Mosaic
// for a dynamic gather across sublanes or lanes. Hopper has no such block:
// each thread reads its element where it lies, and the 50 MB L2 holds the
// tables of every probe shape (the largest, x of 28672 x 128 fp32, is 14.7 MB).
//
// Layout: x (M, N), idx int32, out in x's type, all contiguous.
//   row gather:  idx (K, N) with values in [0, M), out (K, N);
//   lane gather: idx (M, K) with values in [0, N), out (M, K).
// The indices must be in range; the kernels do not check them (the caller
// states the precondition, and a device-side check would cost a sync).
//
// What bounds them on this card: bytes (no arithmetic). Row gather: one
// thread per output element, j fastest, so the reads of idx and the writes
// of out are coalesced; the reads of x are not (each comes from another row
// and costs a 32-byte sector for 4 or 2 useful bytes), so it is expected to
// stay well below its bytes bound. Lane gather: one warp per row, lanes
// over j; a warp's reads of x fall in one row of N elements, so they are
// served from a few cache lines. Making either fast (staging rows in shared
// memory, vector loads) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                  T* __restrict__ out, long long total, int N) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int j = (int)(e % N);
  out[e] = x[(long long)idx[e] * N + j];
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

template <typename T>
int launch_row(const void* x, const void* idx, void* out, int M, int N, int K,
               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)K * N;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  row_gather_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx), static_cast<T*>(out),
      total, N);
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

extern "C" int vfi_row_gather_f32(const void* x, const void* idx, void* out, int M,
                                  int N, int K, void* stream) {
  return launch_row<float>(x, idx, out, M, N, K, stream);
}

extern "C" int vfi_row_gather_bf16(const void* x, const void* idx, void* out, int M,
                                   int N, int K, void* stream) {
  return launch_row<__nv_bfloat16>(x, idx, out, M, N, K, stream);
}

extern "C" int vfi_lane_gather_f32(const void* x, const void* idx, void* out, int M,
                                   int N, int K, void* stream) {
  return launch_lane<float>(x, idx, out, M, N, K, stream);
}

extern "C" int vfi_lane_gather_bf16(const void* x, const void* idx, void* out, int M,
                                    int N, int K, void* stream) {
  return launch_lane<__nv_bfloat16>(x, idx, out, M, N, K, stream);
}
