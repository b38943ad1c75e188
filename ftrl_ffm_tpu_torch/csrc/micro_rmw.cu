// Dynamic-row read-modify-write into fast memory: the CUDA counterpart of
// tools/micro_vmem_rmw.py::_rmw_kernel (entry point rmw) and
// tools/micro_vmem_rmw2.py::make(variant).kern (entry point run_kernel).
//
// What it computes, over payload rows b = 0..N-1 in order, into out [R, E]
// f32 that starts at zero:
//
//   base, unroll8  out[idx[b]] += pay[b]               (payload f32 or bf16)
//   dual           per pair (2j, 2j+1): i0, i1 = idx[2j], idx[2j+1],
//                  same = i0 == i1;  out[i0] += pay[2j] + (same ? pay[2j+1] : 0),
//                  then out[same ? dump : i1] += (same ? 0 : pay[2j+1]),
//                  dump = R - 8 (the probe's dump row, past the live rows)
//   wo             out[idx[b]] = pay[b]: the last row in payload order wins,
//                  rows no id names stay 0
//   rd             reads out[idx[b]] and feeds the sum of what it read back
//                  into out: the output is all zeros (out starts at zero and
//                  only ever gains sums of zeros), but the reads happen
//
// Ids outside [0, R) are dropped.  Every element of out is summed (or
// written) in payload order, as the TPU's sequential grid does, so the
// result is deterministic and bit for bit what the sequential plain PyTorch
// version gives (CPU index_add_ adds in index order).  No atomics.
//
// Design: the TPU keeps acc [R, E] (6.6 MB at R = 2,568, E = 640) in VMEM;
// an H100 block has 227 KB of shared memory.  So acc is cut across blocks by
// columns (32 a block: one per lane, so a payload row's slice is one 128-byte
// load) and by row classes (row r belongs to class r % RB, RB a power of
// two), and the block's slice of acc lives in shared memory.  Inside a
// block, warp w owns the rows of its class whose local index r / RB is w
// modulo the warp count, so no two warps touch one element.  The block
// stages the rows its ids name, kStage at a time, in shared memory with
// coalesced loads; each warp scans them 32 at a time, lists the payload rows
// that land in its rows (a ballot keeps their order), then applies them in
// order, U at a time: the U payload loads are issued before the U
// read-modify-writes, which is what the probe's variants price (base and wo
// U = 1, dual U = 2, unroll8 U = 8).  At the end the block writes its slice
// of acc; every element of out is written by exactly one block.  The staging
// is there because every warp scanning the ids in device memory, with a
// division by RB per id, measured 0.112 ms at the probe's shape on an H100
// and its read-only variant 0.096 ms: the scan's latency, not the
// read-modify-writes, set the time.
//
// What bounds it on an H100: bytes.  At N = 8,192, R = 2,568 (+8), E = 640
// it reads 21.0 MB of payload and writes 6.6 MB of acc: 8.2 us at the
// 3.35 TB/s peak.  Launch overhead (a few us) and the serial chain of
// dependent loads per warp (a payload load, then the shared-memory RMW) are
// what this simple design meets first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = 4096;     // event rows a block stages at a time (16 KB)
constexpr int kChunk = 512;      // ids a warp lists before applying them
constexpr int kMaxLocal = 1024;  // rows of acc a block keeps (128 KB)

enum Variant { kBase = 0, kUnroll8 = 1, kDual = 2, kWriteOnly = 3, kReadOnly = 4 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The row event b lands on (-1: dropped).
template <int VARIANT>
__device__ __forceinline__ int event_row(const int* __restrict__ idx, int b, int rows,
                                         int dump) {
  int r = __ldg(idx + b);
  if (VARIANT == kDual && (b & 1) && r == __ldg(idx + b - 1)) r = dump;
  return r >= 0 && r < rows ? r : -1;
}

// What event b adds (or writes) at column col.
template <typename T, int VARIANT>
__device__ __forceinline__ float event_value(const int* __restrict__ idx,
                                             const T* __restrict__ pay, int b, int E,
                                             int col) {
  const float p = to_f32(pay[static_cast<size_t>(b) * E + col]);
  if (VARIANT != kDual) return p;
  const bool same = __ldg(idx + b) == __ldg(idx + (b ^ 1));
  if (b & 1) return same ? 0.f : p;
  return __fadd_rn(p, same ? to_f32(pay[static_cast<size_t>(b + 1) * E + col]) : 0.f);
}

template <typename T, int VARIANT, int U>
__global__ void __launch_bounds__(kThreads)
micro_rmw_kernel(const int* __restrict__ idx, const T* __restrict__ pay,
                 float* __restrict__ out, int N, int rows, int E, int rb_bits, int dump) {
  extern __shared__ float smem[];
  const int class_mask = (1 << rb_bits) - 1;
  const int ct = blockIdx.x;
  const int rb = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = ct * 32 + lane;
  const bool live = col < E;
  const int nl = rows > rb ? ((rows - 1 - rb) >> rb_bits) + 1 : 0;  // local rows
  float* acc = smem;                                                  // [nl, 32]
  int* srow = reinterpret_cast<int*>(acc + static_cast<size_t>(nl) * 32);  // [kStage]
  int* list = srow + kStage + warp * kChunk;                               // [kChunk]
  for (int i = threadIdx.x; i < nl * 32; i += kThreads) acc[i] = 0.f;

  float read_sum = 0.f;
  for (int s0 = 0; s0 < N; s0 += kStage) {
    const int s1 = min(s0 + kStage, N);
    __syncthreads();  // acc is zeroed and the last stage's rows are read
#pragma unroll 4
    for (int b = s0 + threadIdx.x; b < s1; b += kThreads) {
      srow[b - s0] = event_row<VARIANT>(idx, b, rows, dump);
    }
    __syncthreads();
    for (int c0 = s0; c0 < s1; c0 += kChunk) {
      const int c1 = min(c0 + kChunk, s1);
      int cnt = 0;
#pragma unroll 4
      for (int base = c0; base < c1; base += 32) {
        const int b = base + lane;
        const int r = b < c1 ? srow[b - s0] : -1;
        const bool mine =
            r >= 0 && (r & class_mask) == rb && ((r >> rb_bits) & (kWarps - 1)) == warp;
        const unsigned mask = __ballot_sync(0xffffffffu, mine);
        if (mine) list[cnt + __popc(mask & ((1u << lane) - 1u))] = b;
        cnt += __popc(mask);
      }
      __syncwarp();
      for (int j0 = 0; j0 < cnt; j0 += U) {
        float val[U];
        int lr[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int b = j0 + u < cnt ? list[j0 + u] : -1;
          lr[u] = b >= 0 ? srow[b - s0] >> rb_bits : -1;
          val[u] = 0.f;
          if (VARIANT != kReadOnly && live && b >= 0) {
            val[u] = event_value<T, VARIANT>(idx, pay, b, E, col);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (lr[u] < 0) continue;
          float* a = acc + lr[u] * 32 + lane;
          if (VARIANT == kWriteOnly) {
            *a = val[u];
          } else if (VARIANT == kReadOnly) {
            read_sum += *a;
          } else {
            *a = __fadd_rn(*a, val[u]);
          }
        }
      }
      __syncwarp();  // the list is written again by the next chunk
    }
  }
  // rd: what was read goes back into a row this warp owns (all zeros)
  if (VARIANT == kReadOnly && warp < nl) {
    acc[warp * 32 + lane] = __fadd_rn(acc[warp * 32 + lane], read_sum);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nl * 32; i += kThreads) {
    const int l = i >> 5;
    const int c = ct * 32 + (i & 31);
    if (c < E) out[static_cast<size_t>((l << rb_bits) + rb) * E + c] = acc[i];
  }
}

template <typename T, int VARIANT, int U>
int launch(const int* idx, const void* pay, float* out, int N, int rows, int E,
           cudaStream_t stream) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ct = (E + 31) / 32;
  // row classes: enough blocks for two per SM and at most kMaxLocal rows of
  // acc in a block, rounded up to a power of two, at most rows
  const int want = max((rows + kMaxLocal - 1) / kMaxLocal, (2 * sms + ct - 1) / ct);
  int rb_bits = 0;
  while ((1 << rb_bits) < want) ++rb_bits;
  while (rb_bits > 0 && (1 << rb_bits) > rows) --rb_bits;
  const int classes = 1 << rb_bits;
  const int nl = (rows + classes - 1) / classes;
  const size_t bytes = static_cast<size_t>(nl) * 32 * sizeof(float) +
                       (kStage + static_cast<size_t>(kWarps) * kChunk) * sizeof(int);
  auto kernel = &micro_rmw_kernel<T, VARIANT, U>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(ct, classes), kThreads, bytes, stream>>>(idx, static_cast<const T*>(pay), out,
                                                         N, rows, E, rb_bits, rows - 8);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_variant(int variant, const int* idx, const void* pay, float* out, int N, int rows,
                   int E, cudaStream_t s) {
  switch (variant) {
    case kBase: return launch<T, kBase, 1>(idx, pay, out, N, rows, E, s);
    case kUnroll8: return launch<T, kUnroll8, 8>(idx, pay, out, N, rows, E, s);
    case kDual: return launch<T, kDual, 2>(idx, pay, out, N, rows, E, s);
    case kWriteOnly: return launch<T, kWriteOnly, 1>(idx, pay, out, N, rows, E, s);
    case kReadOnly: return launch<T, kReadOnly, 1>(idx, pay, out, N, rows, E, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: idx [N] int32, pay [N, E] (f32, or bf16 when bf16 !=
// 0), out [rows, E] f32 (every element written), all contiguous on the
// current device.  variant: 0 base, 1 unroll8, 2 dual (N even, rows >= 8;
// pair duplicates go to row rows - 8), 3 wo, 4 rd.  Returns the CUDA error of
// the launch (0 on success).
int micro_rmw_launch(const int* idx, const void* pay, float* out, int N, int rows, int E,
                     int variant, int bf16, void* stream) {
  if (rows == 0 || E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_variant<__nv_bfloat16>(variant, idx, pay, out, N, rows, E, s)
              : launch_variant<float>(variant, idx, pay, out, N, rows, E, s);
}

}  // extern "C"
