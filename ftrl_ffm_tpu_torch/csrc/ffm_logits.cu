// FFM logits for eval and serving: the CUDA counterpart of
// ftrl_ffm_tpu/ops/ffm_pallas.py::_ffm_logits_kernel (entry point
// ffm_fused_logits).
//
// What it computes, for each sample b with occurrences m = 0..F-1 (field
// f_m, value x_m, gathered factor row v_m of E = C'*K values, slot (k, c)
// at k*C' + c, factor-major as in ops/layout.py):
//
//   logit_b = lin_b + sum over unordered pairs m < n with f_m, f_n in
//             [0, C') of x_m * x_n * sum_k v_m[k*C' + f_n] * v_n[k*C' + f_m]
//
// The term of (m, n) equals the term of (n, m), so this is the JAX kernel's
// 1/2 (cross - self) (ops/interactions.py::ffm_logits) with each pair taken
// once and no 1/2: the same products, summed in another order (within the
// plain version's rtol 1e-4, atol 1e-5).  An occurrence whose field lies
// outside [0, C') selects nothing, as in the one-hot form, and no row is
// read outside [0, E).  Lane (k=0, c=n_fields), the linear mirror, is read
// only by an occurrence of field n_fields, which the parser never emits.
//
// The rows come as f32, or as bf16 (a bf16 table's gathered rows, read as
// they are and widened in registers: widening is exact, so the logits are
// bit for bit those of the f32 instance on the widened rows).
//
// What bounds it on an H100: bytes.  A sample reads its F gathered rows once
// (F*E*4 = 99,840 B at 39 fields, C'=40, K=16) for about F*F*K = 24k
// multiply-adds: far below the card's flops per byte.  At B=16,384 that is
// 1.636 GB of f32 rows, 0.490 ms at 3.35 TB/s (bf16 rows: 0.818 GB, 0.244 ms).
// Two instances:
//
// - ffm_logits_c40 (C' = 40, K = 16, F <= 40, rows 16-byte aligned: the
//   bench's shape, every eval, predict and scoring batch of chip_smoke.py).
//   A persistent grid (as many blocks as fit on the card, one per SM for f32
//   rows, two for bf16) walks over the samples; each block holds two
//   buffers in shared memory and fills the next sample's with cp.async
//   (16-byte .cg copies of the rows; 4-byte copies of fields, values and
//   lin) while it sums the current one, so the loads of one sample overlap
//   the arithmetic of the last.  Layout: row m at m*S, S = E+4 floats for
//   f32 (E+8 halves for bf16), so every row starts 16-byte aligned, as
//   cp.async needs, and in the pair loop the 32 lanes of a warp hit 32
//   distinct banks for canonical fields: 640 threads, thread t = 40*k + i
//   takes slot i at factor k, and its two reads v_i[k*40 + f_n] and
//   v_n[k*40 + f_i] sit at bank (5t + const) mod 32 (S mod 32 = 4,
//   40 mod 32 = 8).  Each unordered pair of the 40 slots is taken once, by a
//   round robin: slot i pairs with slots i+1..i+19 (mod 40), and slots
//   i < 20 also with i+20.  So every work item does 19 or 20 products and
//   finds its partner in O(1): no loop over all F with a skip, no bucket
//   table, one round over 640 threads.  All divisors are compile-time
//   constants.  Products are taken as x_n * (a * b) added into a partial
//   sum with __fmaf_rn, then times x_m, with each operation spelled out, so
//   the f32 and bf16 instances round alike.
// - ffm_logits_kernel (any other shape, f32 or bf16 rows): one block per
//   sample copies its rows, widened, into shared memory at a stride of E+1
//   floats and sums over work items (m, k) with run-time sizes; a sample
//   whose rows do not fit the per-block shared memory (above 90 occurrences
//   at E = 640 on an H100) runs the same code on its rows in device memory.
//
// The launcher reads the device's SM count and shared-memory limit, raises
// each kernel's allowance and sizes the persistent grid once per device (a
// static cache), not on every launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

// Floats of dynamic shared memory for one sample of the general kernel: the
// warp partial sums, the rows at stride E+1, then the fields and values.
size_t staged_floats(int F, int E) {
  return kWarps + static_cast<size_t>(F) * (E + 1) + 2 * static_cast<size_t>(F);
}

template <bool STAGED, typename T>
__global__ void __launch_bounds__(kThreads)
ffm_logits_kernel(const T* __restrict__ v, const int* __restrict__ fields,
                  const float* __restrict__ vals, const float* __restrict__ lin,
                  float* __restrict__ out, int F, int C, int K, int vec4) {
  extern __shared__ float smem[];
  const int E = C * K;
  const int b = blockIdx.x;
  const size_t occ0 = static_cast<size_t>(b) * F;
  float* red = smem;

  // the rows: staged f32 at stride E+1 (threads of a warp, which take
  // consecutive occurrences m, hit distinct banks), or T in device memory
  const float* srows = nullptr;
  const T* grows = nullptr;
  const int* fld;
  const float* x;
  int stride;
  if constexpr (STAGED) {
    float* rows = smem + kWarps;
    int* sf = reinterpret_cast<int*>(rows + static_cast<size_t>(F) * (E + 1));
    float* sx = reinterpret_cast<float*>(sf + F);
    for (int i = threadIdx.x; i < F; i += kThreads) {
      sf[i] = fields[occ0 + i];
      sx[i] = vals[occ0 + i];
    }
    const T* src = v + occ0 * E;
    const int total = F * E;
    if (vec4) {
      // f32 rows, E % 4 == 0: the four floats of a load share one row r,
      // whose shared-memory offset is r*(E+1) + (j - r*E) = j + r
      const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
      for (int i = threadIdx.x; i < total / 4; i += kThreads) {
        const float4 q = __ldg(src4 + i);
        const int j = 4 * i;
        float* dst = rows + j + j / E;
        dst[0] = q.x;
        dst[1] = q.y;
        dst[2] = q.z;
        dst[3] = q.w;
      }
    } else {
#pragma unroll 4
      for (int j = threadIdx.x; j < total; j += kThreads) {
        rows[j + j / E] = widen(src[j]);
      }
    }
    __syncthreads();
    srows = rows;
    fld = sf;
    x = sx;
    stride = E + 1;
  } else {
    grows = v + occ0 * E;
    fld = fields + occ0;
    x = vals + occ0;
    stride = E;
  }
  auto at = [&](size_t j) -> float {
    if constexpr (STAGED) {
      return srows[j];
    } else {
      return widen(grows[j]);
    }
  };

  // Work item (m, k), m fastest: occurrence m's partner sum at factor k.
  float acc = 0.f;
  for (int w = threadIdx.x; w < F * K; w += kThreads) {
    const int m = w % F;
    const int k = w / F;
    const int fm = fld[m];
    if (fm < 0 || fm >= C) continue;
    const size_t vm = static_cast<size_t>(m) * stride + k * C;  // v_m[k, .]
    const size_t vn = static_cast<size_t>(k) * C + fm;          // + n*stride: v_n[k, f_m]
    float part = 0.f;
    for (int n = 0; n < F; ++n) {
      const int fn = fld[n];
      if (n == m || fn < 0 || fn >= C) continue;
      part += x[n] * at(vm + fn) * at(vn + static_cast<size_t>(n) * stride);
    }
    acc += x[m] * part;
  }

  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) out[b] = lin[b] + 0.5f * acc;
  }
}

// ---- the instance for C' = 40, K = 16, F <= 40 ----
constexpr int kC = 40;
constexpr int kK = 16;
constexpr int kE = kC * kK;
constexpr int kFMax = 40;
constexpr int kSpecThreads = kFMax * kK;  // 640: one thread per (slot, factor)
constexpr int kSpecWarps = kSpecThreads / 32;
constexpr int kHalfRound = kFMax / 2;     // slot i pairs with i+1..i+19, i < 20 also i+20
static_assert(kFMax % 2 == 0 && kSpecThreads % 32 == 0 && kSpecWarps <= 32, "slots");

// The row stride in shared memory, in elements: E plus 16 bytes, so rows
// stay 16-byte aligned and the stride is 4 words mod 32 (see the header).
template <typename T>
__host__ __device__ constexpr int row_stride() { return kE + 16 / static_cast<int>(sizeof(T)); }
// 16-byte copies a row
template <typename T>
__host__ __device__ constexpr int row_chunks() { return kE * static_cast<int>(sizeof(T)) / 16; }

// Shared memory, in 4-byte words: the warp partial sums (32), then per
// buffer a header of fields [40], values [40] and lin (84 words, a multiple
// of 4), then the two buffers' rows.
constexpr int kRedWords = 32;
constexpr int kHeadWords = 84;
template <typename T>
constexpr size_t spec_bytes() {
  return (kRedWords + 2 * kHeadWords) * 4 +
         2 * static_cast<size_t>(kFMax) * row_stride<T>() * sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one group (the next sample's) is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start the copies of sample b into one buffer: its F rows (one contiguous
// span of v), fields, values and lin.
template <typename T>
__device__ __forceinline__ void stage_sample(T* rows, int* head, const T* v, const int* fields,
                                             const float* vals, const float* lin, int b, int F) {
  constexpr int kChunks = row_chunks<T>();
  const size_t occ0 = static_cast<size_t>(b) * F;
  const char* src = reinterpret_cast<const char*>(v + occ0 * kE);
  const int total = F * kChunks;
  for (int q = threadIdx.x; q < total; q += kSpecThreads) {
    const int m = q / kChunks;
    const int c = q - m * kChunks;
    cp_async16(reinterpret_cast<char*>(rows + m * row_stride<T>()) + 16 * c,
               src + 16 * static_cast<size_t>(q));
  }
  const int t = threadIdx.x;
  if (t < F) {
    cp_async4(head + t, fields + occ0 + t);
    cp_async4(head + kFMax + t, vals + occ0 + t);
  } else if (t == kSpecThreads - 1) {
    cp_async4(head + 2 * kFMax, lin + b);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSpecThreads)
ffm_logits_c40(const T* __restrict__ v, const int* __restrict__ fields,
               const float* __restrict__ vals, const float* __restrict__ lin,
               float* __restrict__ out, int B, int F) {
  extern __shared__ float smem[];  // 16-byte aligned, as all dynamic shared memory
  constexpr int S = row_stride<T>();
  float* red = smem;
  // buffer c: header at head0 + c*kHeadWords, rows at rows0 + c*kFMax*S
  int* const head0 = reinterpret_cast<int*>(smem + kRedWords);
  T* const rows0 = reinterpret_cast<T*>(smem + kRedWords + 2 * kHeadWords);
  const int t = threadIdx.x;
  const int i = t % kFMax;  // slot
  const int k = t / kFMax;  // factor
  const int warp = t >> 5;
  const int lane = t & 31;

  int b = blockIdx.x;
  if (b < B) stage_sample(rows0, head0, v, fields, vals, lin, b, F);
  cp_async_commit();
  for (int it = 0; b < B; ++it, b += gridDim.x) {
    const int cur = it & 1;
    // the next sample into the other buffer, whose last reader passed the
    // previous iteration's second barrier
    const int next = b + gridDim.x;
    const int other = cur ^ 1;
    if (next < B) {
      stage_sample(rows0 + other * (kFMax * S), head0 + other * kHeadWords, v, fields, vals, lin,
                   next, F);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    // lin is read into a register here: the buffer is refilled as soon as
    // every thread has passed the second barrier below
    const int* f = head0 + cur * kHeadWords;
    const float* x = reinterpret_cast<const float*>(f + kFMax);
    const float lin_b = x[kFMax];
    const T* r = rows0 + cur * (kFMax * S);
    const int fi = i < F ? f[i] : -1;
    float acc = 0.f;
    if (fi >= 0 && fi < kC) {
      const T* vi = r + i * S + k * kC;  // v_i[k, .]
      const T* vp = r + k * kC + fi;     // + n*S: v_n[k, f_i]
      float part = 0.f;
#pragma unroll
      for (int d = 1; d <= kHalfRound; ++d) {
        if (d == kHalfRound && i >= kHalfRound) break;
        int n = i + d;
        if (n >= kFMax) n -= kFMax;
        if (n >= F) continue;
        const int fn = f[n];
        if (fn < 0 || fn >= kC) continue;
        part = __fmaf_rn(x[n], __fmul_rn(widen(vi[fn]), widen(vp[n * S])), part);
      }
      acc = __fmul_rn(x[i], part);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      acc = lane < kSpecWarps ? red[lane] : 0.f;
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
      if (lane == 0) out[b] = lin_b + acc;
    }
  }
}

// What the launcher reads from the runtime once per device: the SM count
// and the per-block shared-memory limit (opt-in).  launch_logits keeps, per
// kernel, whether its allowance is raised and its persistent grid's size.
struct DeviceInfo {
  int sms = 0;
  int optin = 0;
};

cudaError_t device_info(int* dev, DeviceInfo* info) {
  static DeviceInfo cache[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& c = cache[*dev];
  if (c.sms == 0) {
    int sms = 0, optin = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, *dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    }
    if (err != cudaSuccess) return err;
    c.optin = optin;
    c.sms = sms;
  }
  *info = c;
  return cudaSuccess;
}

// Raise `kernel`'s dynamic shared-memory allowance to the device's limit,
// once per device (`done` is that kernel's own flags).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int dev, int optin, bool* done) {
  if (done[dev]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

bool takes_c40(int F, int C, int K, const void* v) {
  return C == kC && K == kK && F >= 1 && F <= kFMax && reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

// The instance that takes a sample of F occurrences at C' fields and K
// factors under `optin` bytes of shared memory a block: 2 the C' = 40,
// K = 16 instance, 1 the general one with its rows staged in shared
// memory, 0 the general one on rows in device memory, -1 none.
template <typename T>
int pick_instance(int F, int C, int K, const void* v, int optin) {
  const size_t limit = static_cast<size_t>(optin);
  if (takes_c40(F, C, K, v) && spec_bytes<T>() <= limit) return 2;
  if (staged_floats(F, C * K) * sizeof(float) <= limit) return 1;
  if (kWarps * sizeof(float) <= limit) return 0;
  return -1;
}

// Launch the instance `instance` (pick_instance's code) on rows of type T;
// each instantiation keeps its own once-per-device flags and grid size.
template <typename T>
int launch_logits(int instance, int dev, const DeviceInfo& info, const T* v, const int* fields,
                  const float* vals, const float* lin, float* out, int B, int F, int C, int K,
                  cudaStream_t s) {
  static bool done_c40[kMaxDevices] = {};
  static bool done_staged[kMaxDevices] = {};
  static int grid_c40[kMaxDevices] = {};
  cudaError_t err;
  if (instance == 2) {
    constexpr size_t bytes = spec_bytes<T>();
    err = allow_shared(&ffm_logits_c40<T>, dev, info.optin, done_c40);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (grid_c40[dev] == 0) {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ffm_logits_c40<T>,
                                                          kSpecThreads, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      grid_c40[dev] = per_sm * info.sms;
    }
    const int grid = B < grid_c40[dev] ? B : grid_c40[dev];
    ffm_logits_c40<T><<<grid, kSpecThreads, bytes, s>>>(v, fields, vals, lin, out, B, F);
    return static_cast<int>(cudaGetLastError());
  }
  const int E = C * K;
  const int vec4 = sizeof(T) == 4 && E % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (instance == 1) {
    const size_t bytes = staged_floats(F, E) * sizeof(float);
    err = allow_shared(&ffm_logits_kernel<true, T>, dev, info.optin, done_staged);
    if (err != cudaSuccess) return static_cast<int>(err);
    ffm_logits_kernel<true, T><<<B, kThreads, bytes, s>>>(v, fields, vals, lin, out, F, C, K,
                                                          vec4);
  } else {
    ffm_logits_kernel<false, T><<<B, kThreads, kWarps * sizeof(float), s>>>(
        v, fields, vals, lin, out, F, C, K, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`: v [B*F, C*K] (f32, or bf16 when v_bf16), fields/vals
// [B, F], lin/out [B], all contiguous on the current device.  Writes the
// instance it picked to *instance (pick_instance's code; left as it was
// when the device cannot be queried) and launches it.  Returns the CUDA
// error of the launch (0 on success, cudaErrorInvalidValue when no instance
// takes the shape); the caller raises on anything else.
int ffm_logits_launch(const void* v, const int* fields, const float* vals, const float* lin,
                      float* out, int B, int F, int C, int K, int v_bf16, void* stream,
                      int* instance_out) {
  int dev = 0;
  DeviceInfo info;
  const cudaError_t err = device_info(&dev, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf16 = __nv_bfloat16;
  const int instance = v_bf16 ? pick_instance<bf16>(F, C, K, v, info.optin)
                              : pick_instance<float>(F, C, K, v, info.optin);
  *instance_out = instance;
  if (instance < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v_bf16) {
    return launch_logits(instance, dev, info, static_cast<const bf16*>(v), fields, vals, lin,
                         out, B, F, C, K, s);
  }
  return launch_logits(instance, dev, info, static_cast<const float*>(v), fields, vals, lin, out,
                       B, F, C, K, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
