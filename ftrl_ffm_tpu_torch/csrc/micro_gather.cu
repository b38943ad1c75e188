// Per-row gather through a permutation, summed: the CUDA counterpart of
// tools/micro_dma_gather.py::_gather_kernel (entry point dma_gather_sum).
//
// What it computes: out [8, E2] f32 with
//
//   out[0] = sum over j < N of pay[perm[j]]      (pay f32 or bf16, summed in f32)
//   out[1..7] = 0
//
// The TPU kernel issues one HBM->VMEM row DMA per j into a slab, waits, and
// folds the slab into a running sum carried across its sequential grid
// (leaving rows 1-7 unwritten); the caller passes N = (NNZ // BLK) * BLK, as
// that grid drops the ragged tail.  The question it prices is how fast
// per-row gathers through a sort permutation can feed a sum.
//
// Design: blocks run in parallel on an H100, so nothing is carried from one to
// the next.  A block takes one run of consecutive j and 256 consecutive
// columns, one per thread; each thread reads perm[j] (one broadcast load for
// the warp) and pay[perm[j], col] (coalesced across the warp), eight rows in
// flight at a time, and writes its partial sum to a [chunks, E2] scratch.  A
// second kernel adds the partials of each column in chunk order.  The number
// of chunks depends only on N, E2 and the card, so the sum is the same on
// every run: no float atomics.  A later design could stage rows with cp.async
// or TMA into a shared-memory ring; plain loads with eight rows in flight are
// the simple form.
//
// What bounds it on an H100: bytes, the gathered rows read once.  At
// N = 319,488, E2 = 1,280 f32 that is 1.64 GB, 0.49 ms at the 3.35 TB/s peak
// (1.5 ns per row); the partials (chunks * E2 floats) stay in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 8;
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
micro_gather_partial_kernel(const int* __restrict__ perm, const T* __restrict__ pay,
                            float* __restrict__ partial, int N, int E2, int rows_per_chunk) {
  const int chunk = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= E2) return;
  const int j0 = chunk * rows_per_chunk;
  const int j1 = min(j0 + rows_per_chunk, N);
  float acc = 0.f;
  int j = j0;
  for (; j + kInFlight <= j1; j += kInFlight) {
    float x[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      x[u] = to_f32(pay[static_cast<size_t>(__ldg(perm + j + u)) * E2 + col]);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) acc = __fadd_rn(acc, x[u]);
  }
  for (; j < j1; ++j) {
    acc = __fadd_rn(acc, to_f32(pay[static_cast<size_t>(__ldg(perm + j)) * E2 + col]));
  }
  partial[static_cast<size_t>(chunk) * E2 + col] = acc;
}

// out[0, c] = the partials of column c in chunk order; rows 1-7 zero.
__global__ void __launch_bounds__(kThreads)
micro_gather_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                           int chunks, int E2) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= E2) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc = __fadd_rn(acc, partial[static_cast<size_t>(c) * E2 + col]);
  out[col] = acc;
  for (int r = 1; r < 8; ++r) out[static_cast<size_t>(r) * E2 + col] = 0.f;
}

}  // namespace

extern "C" {

// The number of chunks (partial rows) micro_gather_launch uses for N rows of
// E2 columns on the current device; the caller allocates partial
// [chunks, E2] f32.  A negative CUDA error code when the device cannot be
// queried.
int micro_gather_chunks(int N, int E2) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int tiles = (E2 + kThreads - 1) / kThreads;
  int chunks = (kBlocksPerSm * sms + tiles - 1) / tiles;
  // at least kInFlight rows a chunk, and never more chunks than rows
  chunks = min(chunks, max(1, N / kInFlight));
  return max(chunks, 1);
}

// Launch on `stream`: perm [N] int32 (each in [0, rows of pay)), pay [*, E2]
// (f32, or bf16 when bf16 != 0), partial [chunks, E2] f32 scratch with
// chunks = micro_gather_chunks(N, E2), out [8, E2] f32, all contiguous on the
// current device.  Returns the CUDA error of the launches (0 on success).
int micro_gather_launch(const int* perm, const void* pay, float* partial, float* out, int N,
                        int E2, int chunks, int bf16, void* stream) {
  if (E2 == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (E2 + kThreads - 1) / kThreads;
  const int rows_per_chunk = (N + chunks - 1) / chunks;
  const dim3 grid(tiles, chunks);
  if (bf16) {
    micro_gather_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        perm, static_cast<const __nv_bfloat16*>(pay), partial, N, E2, rows_per_chunk);
  } else {
    micro_gather_partial_kernel<float><<<grid, kThreads, 0, s>>>(
        perm, static_cast<const float*>(pay), partial, N, E2, rows_per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  micro_gather_reduce_kernel<<<tiles, kThreads, 0, s>>>(partial, out, chunks, E2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
