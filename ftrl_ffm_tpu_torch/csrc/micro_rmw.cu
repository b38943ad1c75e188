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
// version gives (CPU index_add_ adds in index order).  No atomics on out.
//
// What bounds it on an H100: bytes.  At N = 8,192, R = 2,568 (+8), E = 640
// it reads 21.0 MB of payload and writes 6.6 MB of acc: 8.2 us at the
// 3.35 TB/s peak.  The TPU keeps acc [R, E] in VMEM; an H100 block has
// 227 KB of shared memory, so acc is cut across blocks by column tiles and
// by row classes (row r belongs to class r % RB, RB a power of two, at local
// row r / RB), and one warp owns a (tile, class) slice of acc in shared
// memory.  Two kernels:
//
// - micro_rmw_bin: the events binned by class, once.  Block g sorts its
//   chunk of 256 ids (one a thread) stably by class: a ballot per class bit
//   ranks a lane among the warp's lanes of its class, the warps' counts
//   become offsets, and each event goes to its class's segment of the
//   chunk's list, in payload order.  An entry holds the payload row, the
//   local row and what the event adds (dual's pair sums and dump-row zeros
//   are decided here).  Every id is read once, by one block.  (A first form
//   sorted all N ids in one block of 1,024 threads, on one SM: the probe
//   took 0.025 ms of device time with it, 0.015 with chunks on an H100.)
// - micro_rmw_apply: block = one warp = one (column tile, class) slice.  A
//   lane owns 4 consecutive columns (a float4 of f32, 8 bytes of bf16;
//   scalar when E % 4 != 0 or the payload is unaligned), so a warp covers
//   128 columns and E = 640 takes 5 tiles.  The warp walks its class's
//   segments chunk by chunk, which is payload order, kChunk events at a
//   time (16 for dual, which loads two rows for some): it issues all their
//   payload loads first, then applies them in order to its slice, which no
//   other warp touches.  So every variant has kChunk loads in flight: base and
//   unroll8 (whose only difference on the TPU was how many loads were in
//   flight) run the same code.  Then it writes its slice of out; every
//   element of out is written by exactly one warp.
//
// RB is chosen so that the grid runs in one wave of at most eight warps per
// SM and a slice fits 48 KB; the launcher reads the SM count, the
// shared-memory limit and each instance's occupancy once per device (a
// static cache), not on every launch.  The event list is
// scratch the caller allocates (micro_rmw_scratch_ints).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kBinIds = 256;           // ids a bin block sorts, one a thread
constexpr int kBinWarps = kBinIds / 32;
constexpr int kMaxClasses = 256;       // row classes (bin's shared memory: 9 KB)
constexpr int kChunk = 32;             // payload loads a warp has in flight (dual: 2x16)
constexpr int kFastBytes = 48 * 1024;  // a slice of acc that needs no opt-in
constexpr int kRowBits = 24;           // an entry's local row; its kind above
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kBase = 0, kUnroll8 = 1, kDual = 2, kWriteOnly = 3, kReadOnly = 4 };
// what an event adds: its payload row; dual's first row of an equal pair
// (+ the second), of an unequal pair (+ 0), and the second of an equal pair
// (0, into the dump row)
enum Kind { kPay = 0, kPairSum = 1, kPayPlusZero = 2, kZero = 3 };

// {row (-1: dropped), kind} of event b whose id is raw (b < end); every
// lane of the warp calls it (dual reads its neighbours' ids by shuffle: b
// and the lane have the same parity, since a warp's ids start at a multiple
// of 32)
template <bool DUAL>
__device__ __forceinline__ int2 event(int raw, int b, int end, int rows, int lane) {
  int row = raw;
  int kind = kPay;
  if (DUAL) {
    const int prev = __shfl_up_sync(kFull, raw, 1);
    const int next = __shfl_down_sync(kFull, raw, 1);
    if (lane & 1) {
      if (raw == prev) {
        row = rows - 8;
        kind = kZero;
      }
    } else {
      kind = raw == next ? kPairSum : kPayPlusZero;
    }
  }
  if (b >= end || row < 0 || row >= rows) row = -1;
  return make_int2(row, kind);
}

// A chunk's stable counting sort by class r & (RB-1): block g takes ids
// [g*kBinIds, (g+1)*kBinIds), one a thread.  list[g*kBinIds + offs[g*(RB+1)
// + c] .. g*kBinIds + offs[g*(RB+1) + c+1]) holds the chunk's class-c
// events in payload order as {b, local row | kind << kRowBits}.
template <bool DUAL>
__global__ void __launch_bounds__(kBinIds)
micro_rmw_bin(const int* __restrict__ idx, int N, int rows, int rb_bits,
              int2* __restrict__ list, int* __restrict__ offs) {
  __shared__ int cnt[kBinWarps * kMaxClasses];  // per warp and class: counts, then offsets
  __shared__ int cstart[kMaxClasses + 1];       // per class: count, then start
  __shared__ int wsum[kBinWarps];
  const int RB = 1 << rb_bits;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kBinIds + threadIdx.x;
  for (int i = threadIdx.x; i < kBinWarps * RB; i += kBinIds) cnt[i] = 0;
  const int2 ev = event<DUAL>(b < N ? __ldg(idx + b) : -1, b, N, rows, lane);
  const int c = ev.x >= 0 ? ev.x & (RB - 1) : -1;
  // the lanes with this lane's class: one ballot per class bit
  unsigned peers = __ballot_sync(kFull, ev.x >= 0);
  if (ev.x < 0) peers = ~peers;
  for (int bit = 0; bit < rb_bits; ++bit) {
    const unsigned on = __ballot_sync(kFull, (c >> bit) & 1);
    peers &= (c >> bit) & 1 ? on : ~on;
  }
  const int rank = __popc(peers & ((1u << lane) - 1u));
  __syncthreads();
  if (ev.x >= 0 && rank == 0) cnt[warp * RB + c] = __popc(peers);
  __syncthreads();
  for (int k = threadIdx.x; k < RB; k += kBinIds) {
    int run = 0;
    for (int w = 0; w < kBinWarps; ++w) {
      const int n = cnt[w * RB + k];
      cnt[w * RB + k] = run;
      run += n;
    }
    cstart[k] = run;
  }
  __syncthreads();
  // class starts: an exclusive scan, warp w over classes 32w .. 32w+31
  const int k = warp * 32 + lane;
  const int n = k < RB ? cstart[k] : 0;
  int incl = n;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  if (k < RB) cstart[k] = before + incl - n;
  if (k == RB - 1) cstart[RB] = before + incl;
  __syncthreads();
  int* chunk_offs = offs + static_cast<size_t>(blockIdx.x) * (RB + 1);
  for (int j = threadIdx.x; j <= RB; j += kBinIds) chunk_offs[j] = cstart[j];
  if (ev.x >= 0) {
    list[static_cast<size_t>(blockIdx.x) * kBinIds + cstart[c] + cnt[warp * RB + c] + rank] =
        make_int2(b, (ev.x >> rb_bits) | (ev.y << kRowBits));
  }
}

// VEC payload floats at offset `at` (bf16 widens exactly: its bits are the
// top half of the f32's)
template <int VEC>
__device__ __forceinline__ void load(const float* __restrict__ pay, size_t at, float* v) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(pay + at));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(pay + at);
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ pay, size_t at,
                                     float* v) {
  if constexpr (VEC == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(pay + at));
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
    v[0] = __bfloat162float(pay[at]);
  }
}

// VEC floats of a lane's slice of acc in shared memory, as one 16-byte
// access when VEC = 4 (four scalar accesses at the lanes' 16-byte stride
// would meet 4-way bank conflicts)
template <int VEC>
__device__ __forceinline__ void load_acc(const float* a, float* v) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(a);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = a[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_acc(float* a, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(a) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    a[0] = v[0];
  }
}

template <typename T, int VARIANT, int VEC>
__global__ void __launch_bounds__(32)
micro_rmw_apply(const int2* __restrict__ list, const int* __restrict__ offs,
                const T* __restrict__ pay, float* __restrict__ out, int N, int rows, int E,
                int rb_bits) {
  extern __shared__ float acc[];  // [local rows][32 * VEC]
  constexpr int TW = 32 * VEC;
  constexpr bool kDualSum = VARIANT == kDual;
  constexpr int kStep = kDualSum ? kChunk / 2 : kChunk;  // dual loads two rows an event
  const int cls = blockIdx.y;
  const int lane = threadIdx.x;
  const int nl = rows > cls ? ((rows - 1 - cls) >> rb_bits) + 1 : 0;
  const int col = blockIdx.x * TW + lane * VEC;
  const bool live = col < E;     // VEC = 4 only when E % 4 == 0
  float* my = acc + lane * VEC;  // this lane's columns of local row l: my[l * TW]
  const float zeros[VEC] = {};
  for (int l = 0; l < nl; ++l) store_acc<VEC>(my + l * TW, zeros);
  float read_sum[VEC] = {};
  // the class's events, chunk by chunk in payload order: lane g of a group
  // of 32 chunks holds chunk g's segment [lo, lo + n) and its place excl
  // among the group's events
  const int chunks = (N + kBinIds - 1) / kBinIds;
  const int stride = (1 << rb_bits) + 1;
  for (int g0 = 0; g0 < chunks; g0 += 32) {
    const int g = g0 + lane;
    int lo = 0;
    int n = 0;
    if (g < chunks) {
      lo = offs[static_cast<size_t>(g) * stride + cls];
      n = offs[static_cast<size_t>(g) * stride + cls + 1] - lo;
    }
    int incl = n;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int excl = incl - n;
    const int total = __shfl_sync(kFull, incl, 31);
    for (int p0 = 0; p0 < total; p0 += kStep) {
      // lane u < kStep fetches event p0 + u: its chunk is the last lane
      // whose excl <= p (excl does not decrease across the lanes)
      const int p = p0 + lane;
      int at = 0;
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFull, excl, at + step) <= p) at += step;
      }
      const int seg_lo = __shfl_sync(kFull, lo, at);
      const int seg_excl = __shfl_sync(kFull, excl, at);
      const int2 e = lane < kStep && p < total
          ? list[static_cast<size_t>(g0 + at) * kBinIds + seg_lo + (p - seg_excl)]
          : make_int2(-1, 0);
      float val[kStep][VEC];
      float nxt[kDualSum ? kStep : 1][VEC];  // dual: what the first of a pair adds on
      int lr[kStep];
      int kind[kStep];
      // every payload load of the step first ...
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const int b = __shfl_sync(kFull, e.x, u);
        const int y = __shfl_sync(kFull, e.y, u);
        lr[u] = b >= 0 ? y & ((1 << kRowBits) - 1) : -1;
        kind[u] = y >> kRowBits;
#pragma unroll
        for (int i = 0; i < VEC; ++i) val[u][i] = 0.f;
        if (VARIANT != kReadOnly && live && b >= 0 && kind[u] != kZero) {
          load<VEC>(pay, static_cast<size_t>(b) * E + col, val[u]);
        }
        if constexpr (kDualSum) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) nxt[u][i] = 0.f;
          if (live && b >= 0 && kind[u] == kPairSum) {
            load<VEC>(pay, static_cast<size_t>(b + 1) * E + col, nxt[u]);
          }
        }
      }
      // ... then the read-modify-writes in payload order
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        if (lr[u] < 0) continue;
        float* a = my + lr[u] * TW;
        float cur[VEC];
        if (VARIANT != kWriteOnly) load_acc<VEC>(a, cur);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float x = val[u][i];
          if constexpr (kDualSum) {
            if (kind[u] == kPairSum || kind[u] == kPayPlusZero) x = __fadd_rn(x, nxt[u][i]);
          }
          if (VARIANT == kReadOnly) {
            read_sum[i] += cur[i];
          } else {
            cur[i] = VARIANT == kWriteOnly ? x : __fadd_rn(cur[i], x);
          }
        }
        if (VARIANT != kReadOnly) store_acc<VEC>(a, cur);
      }
    }
  }
  // rd: what was read goes back into local row 0 (all zeros)
  if (VARIANT == kReadOnly && nl > 0) {
    float cur[VEC];
    load_acc<VEC>(my, cur);
#pragma unroll
    for (int i = 0; i < VEC; ++i) cur[i] = __fadd_rn(cur[i], read_sum[i]);
    store_acc<VEC>(my, cur);
  }
  if (!live) return;
  for (int l = 0; l < nl; ++l) {
    float v[VEC];
    load_acc<VEC>(my + l * TW, v);
    store_acc<VEC>(out + static_cast<size_t>((l << rb_bits) + cls) * E + col, v);
  }
}

// The current device's SM count and per-block shared-memory limit (opt-in),
// read from the runtime once per device.
cudaError_t device_limits(int* dev, int* sms, int* optin) {
  static int cache[kMaxDevices][2] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int* c = cache[*dev];
  if (c[0] == 0) {
    int s = 0;
    int o = 0;
    err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, *dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    }
    if (err != cudaSuccess) return err;
    c[1] = o;
    c[0] = s;
  }
  *sms = c[0];
  *optin = c[1];
  return cudaSuccess;
}

template <typename T, int VARIANT, int VEC>
int launch(const int* idx, const void* pay, float* out, int* scratch, int N, int rows, int E,
           cudaStream_t stream) {
  static bool allowed[kMaxDevices] = {};
  static int resident[kMaxDevices] = {};  // this instance's warps that fit the card at once
  int dev = 0;
  int sms = 0;
  int optin = 0;
  cudaError_t err = device_limits(&dev, &sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto apply = &micro_rmw_apply<T, VARIANT, VEC>;
  if (resident[dev] == 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, apply, 32, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = max(per_sm, 1) * sms;
  }
  constexpr int TW = 32 * VEC;
  const int ct = (E + TW - 1) / TW;
  // row classes, a power of two: as many as keep the grid in one wave of
  // at most eight warps per SM (registers permitting), at least as many as
  // keep a slice within 48 KB, at most rows and kMaxClasses
  const int fast_rows = kFastBytes / (TW * static_cast<int>(sizeof(float)));
  const int fit = (rows + fast_rows - 1) / fast_rows;
  const int wave = max(min(8 * sms, resident[dev]) / ct, 1);
  int rb_bits = 0;
  while ((2 << rb_bits) <= wave) ++rb_bits;
  while ((1 << rb_bits) < fit) ++rb_bits;
  while (rb_bits > 0 && ((1 << rb_bits) > rows || (1 << rb_bits) > kMaxClasses)) --rb_bits;
  const int classes = 1 << rb_bits;
  const size_t bytes = static_cast<size_t>((rows + classes - 1) / classes) * TW * sizeof(float);
  if (bytes > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > static_cast<size_t>(kFastBytes) && !allowed[dev]) {
    err = cudaFuncSetAttribute(apply, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = true;
  }
  int2* list = reinterpret_cast<int2*>(scratch);
  int* offs = scratch + 2 * static_cast<size_t>(N);
  const int chunks = (N + kBinIds - 1) / kBinIds;
  if (chunks > 0) {
    auto bin = VARIANT == kDual ? &micro_rmw_bin<true> : &micro_rmw_bin<false>;
    bin<<<chunks, kBinIds, 0, stream>>>(idx, N, rows, rb_bits, list, offs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  apply<<<dim3(ct, classes), 32, bytes, stream>>>(list, offs, static_cast<const T*>(pay), out,
                                                   N, rows, E, rb_bits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_variant(int variant, const int* idx, const void* pay, float* out, int* scratch,
                   int N, int rows, int E, cudaStream_t s) {
  switch (variant) {
    case kBase:
    case kUnroll8: return launch<T, kBase, VEC>(idx, pay, out, scratch, N, rows, E, s);
    case kDual: return launch<T, kDual, VEC>(idx, pay, out, scratch, N, rows, E, s);
    case kWriteOnly: return launch<T, kWriteOnly, VEC>(idx, pay, out, scratch, N, rows, E, s);
    case kReadOnly: return launch<T, kReadOnly, VEC>(idx, pay, out, scratch, N, rows, E, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Ints of scratch a launch with N ids needs: the event list (N int2), then
// each chunk's class offsets.
long long micro_rmw_scratch_ints(int N) {
  return 2LL * N + static_cast<long long>((N + kBinIds - 1) / kBinIds) * (kMaxClasses + 1);
}

// Launch on `stream`: idx [N] int32, pay [N, E] (f32, or bf16 when bf16 !=
// 0), out [rows, E] f32 (every element written), scratch
// [micro_rmw_scratch_ints(N)] int32 (8-byte aligned), all on the current
// device, contiguous.
// variant: 0 base, 1 unroll8, 2 dual (N even, rows >= 8; pair duplicates go
// to row rows - 8), 3 wo, 4 rd.  Returns the CUDA error of the launch (0 on
// success).
int micro_rmw_launch(const int* idx, const void* pay, float* out, int* scratch, int N,
                     int rows, int E, int variant, int bf16, void* stream) {
  if (rows == 0 || E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = bf16 ? 8 : 16;
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(pay) % align == 0;
  if (bf16) {
    return vec ? launch_variant<__nv_bfloat16, 4>(variant, idx, pay, out, scratch, N, rows, E, s)
               : launch_variant<__nv_bfloat16, 1>(variant, idx, pay, out, scratch, N, rows, E, s);
  }
  return vec ? launch_variant<float, 4>(variant, idx, pay, out, scratch, N, rows, E, s)
             : launch_variant<float, 1>(variant, idx, pay, out, scratch, N, rows, E, s);
}

}  // extern "C"
