// FFM logits and the FTRL payload of one train step: the CUDA counterpart of
// ftrl_ffm_tpu/ops/ffm_pallas.py::_ffm_fused_kernel (entry point
// ffm_fused_logits_grads, f32 or bf16 output, combined or split).
//
// What it computes, for each sample b with occurrences m = 0..F-1 (field
// f_m, value x_m, gathered factor row v_m of E = C'*K floats, slot (k, c) at
// k*C' + c, factor-major as in ops/layout.py):
//
//   logit_b  = the logit of ffm_logits.cu
//   gs       = (sigmoid(logit_b) - y_b) * sample_w_b
//   g_m[k,c] = gs * x_m * sum over n != m with f_n = c of x_n * v_n[k*C' + f_m]
//   gg2[m]   = (g_m || g_m^2), [2E] floats per occurrence (combined), or
//   g[m], g2[m] = g_m, g_m^2 in two [B*F, E] tensors (split, for the
//   huge-table in-place update); only the store differs
//
// The payload's type is a template parameter of both instances: float, or
// __nv_bfloat16 (Config.acc_dtype=bfloat16, the JAX package's out_dtype):
// g and g^2 are computed in f32 as before and each rounded to bf16 once at
// the store, g^2 from the f32 g (ffm_pallas.py's (g * g).astype(bf16)).
// The bf16 payload halves the store, the bound of the kernel: at the bench
// shape 1.64 GB of rows read and 1.64 GB of payload written, 0.98 ms at
// 3.35 TB/s (1.47 ms for f32).
//
// The sum is ops/interactions.py's T - oh_e * xv (the field-bucketed form of
// the Pallas kernel) without its one-hot contractions: the sample's
// occurrences are listed by field in C' buckets (stable: ascending m in each
// bucket), so each output slot sums only its own bucket.  In canonical CTR
// data (one feature per field) every bucket holds one occurrence and a slot
// costs O(1).  Slot (0, aug_lane), when aug_lane >= 0, carries the linear
// gradient gs * x_m for every occurrence instead (ffm_pallas.py's
// where(lane == aug_lane, gx, g)).  An occurrence whose field lies outside
// [0, C') has a zero factor gradient and reads no row; a padding occurrence
// (x = 0) gives zeros.
//
// What bounds it on an H100: the store of the payload.  At B=16,384, F=39,
// C'=40, K=16 it reads 1.64 GB of rows but writes 3.27 GB of payload per
// batch (638,976 x 1280 x 4 B): 1.47 ms at 3.35 TB/s, for about 2 flops per
// stored float.  One block per sample stages its rows in shared memory at
// a stride of E+1 floats (threads of a warp on consecutive occurrences hit
// distinct banks), takes the pair sum of the logit as ffm_logits.cu does,
// and stores every payload value once, coalesced; g^2 is squared in
// registers, no [B, F, E] temporaries.  Two instances:
//
// - ffm_fused_c40 (C' = 40, K = 16, F <= 40: the bench's shape, every train
//   step of chip_smoke.py).  Every divisor is a compile-time constant (the
//   run-time divisions by E, F and C' cost about 0.9 ms a batch in the
//   canonical-fields probe, micro_canon.cu).  The rows are staged already
//   scaled by x (xv = x * v, rounded once), so a bucket sum adds xv and the
//   logit adds xv_m * xv_n: each product is rounded in another place than
//   in the general instance, and the logit's work items are (m, k) with m
//   running over 40 slots, not F: its partial sums run in another order
//   (both within the tolerances of the plain version).  The bucket table is
//   built in parallel: thread c counts field c, one warp prefix-sums the
//   counts and each lane places its own occurrences (the same stable
//   order), where the general instance sorts on one thread.  Each thread of
//   the store takes four consecutive slots (k, c..c+3) of one occurrence,
//   whose bucket sums read one column, and stores one float4 of g and one of
//   g^2 with streaming stores (__stcs: 3.27 GB passes through a 50 MB L2).
//   320 threads, so the 640 (m, k) work items of the logit are two rounds;
//   103.6 KB of shared memory, two blocks per SM.
// - ffm_fused_kernel (any other shape): the same work with run-time sizes,
//   a serial counting sort on thread 0 and one float a thread.  A sample
//   whose rows do not fit the per-block shared memory runs the same code on
//   its rows in device memory (STAGED = false).  A shape neither takes
//   raises.
//
// The launcher reads the device's shared-memory limit and raises each
// kernel's allowance once per device (a static cache), not on every launch.
// Offsets into v and the payload are size_t: B*F*2E passes 2^31 at
// B = 65,536.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// One payload value from its f32 form: as it is, or rounded to nearest even.
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Four adjacent payload values with one streaming store: a float4, or four
// bf16 rounded to nearest even in 8 bytes.
__device__ __forceinline__ void put4(float* p, float a, float b, float c, float d) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(reinterpret_cast<const unsigned&>(lo),
                                                 reinterpret_cast<const unsigned&>(hi)));
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

// Floats of dynamic shared memory for one sample: the warp partial sums,
// gs (and a pad float), fields, values, bucket starts [C+1], the occurrences
// in bucket order [F], then the rows at stride E+1 when staged.
size_t fused_floats(int F, int C, int K, bool staged) {
  const size_t f = static_cast<size_t>(F);
  size_t n = kWarps + 2 + 3 * f + static_cast<size_t>(C) + 1;
  if (staged) n += f * (static_cast<size_t>(C) * K + 1);
  return n;
}

template <bool STAGED, typename OutT>
__global__ void __launch_bounds__(kThreads)
ffm_fused_kernel(const float* __restrict__ v, const int* __restrict__ fields,
                 const float* __restrict__ vals, const float* __restrict__ lin,
                 const float* __restrict__ y, const float* __restrict__ sw,
                 float* __restrict__ logits, OutT* __restrict__ g_out,
                 OutT* __restrict__ g2_out, int out_stride, int F, int C, int K,
                 int aug_lane, int vec4) {
  extern __shared__ float smem[];
  const int E = C * K;
  const int b = blockIdx.x;
  const size_t occ0 = static_cast<size_t>(b) * F;
  float* red = smem;
  float* gs_s = red + kWarps;
  int* sf = reinterpret_cast<int*>(gs_s + 2);
  float* sx = reinterpret_cast<float*>(sf + F);
  int* bstart = reinterpret_cast<int*>(sx + F);
  int* border = bstart + C + 1;

  for (int i = threadIdx.x; i < F; i += kThreads) {
    sf[i] = fields[occ0 + i];
    sx[i] = vals[occ0 + i];
  }
  const float* rows;
  int stride;
  if constexpr (STAGED) {
    // the rows (one contiguous span of v) at a stride of E+1 floats, so the
    // threads of a warp, which take consecutive occurrences, hit distinct
    // banks
    float* srows = reinterpret_cast<float*>(border + F);
    const float* src = v + occ0 * E;
    const int total = F * E;
    if (vec4) {
      // E % 4 == 0, so the four floats of a load share one row r, whose
      // shared-memory offset is r*(E+1) + (j - r*E) = j + r
      const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
      for (int i = threadIdx.x; i < total / 4; i += kThreads) {
        const float4 q = __ldg(src4 + i);
        const int j = 4 * i;
        float* dst = srows + j + j / E;
        dst[0] = q.x;
        dst[1] = q.y;
        dst[2] = q.z;
        dst[3] = q.w;
      }
    } else {
#pragma unroll 4
      for (int j = threadIdx.x; j < total; j += kThreads) {
        srows[j + j / E] = __ldg(src + j);
      }
    }
    rows = srows;
    stride = E + 1;
  } else {
    rows = v + occ0 * E;
    stride = E;
  }
  __syncthreads();

  // Counting sort of the occurrences by field (stable: ascending m in each
  // bucket): bucket c lists border[bstart[c] .. bstart[c+1]).
  if (threadIdx.x == 0) {
    for (int c = 0; c <= C; ++c) bstart[c] = 0;
    for (int m = 0; m < F; ++m) {
      const int fm = sf[m];
      if (fm >= 0 && fm < C) ++bstart[fm + 1];
    }
    for (int c = 0; c < C; ++c) bstart[c + 1] += bstart[c];
    for (int m = 0; m < F; ++m) {  // bstart[c] walks to the end of bucket c
      const int fm = sf[m];
      if (fm >= 0 && fm < C) border[bstart[fm]++] = m;
    }
    for (int c = C; c > 0; --c) bstart[c] = bstart[c - 1];
    bstart[0] = 0;
  }

  // The logit: ffm_logits.cu's pair sum over work items (m, k), m fastest,
  // of x_m * x_n * v_m[k, f_n] * v_n[k, f_m] over partners n != m.
  float acc = 0.f;
  for (int w = threadIdx.x; w < F * K; w += kThreads) {
    const int m = w % F;
    const int k = w / F;
    const int fm = sf[m];
    if (fm < 0 || fm >= C) continue;
    const float* vm = rows + static_cast<size_t>(m) * stride + k * C;  // v_m[k, .]
    const float* vn = rows + k * C + fm;  // + n*stride: v_n[k, f_m]
    float part = 0.f;
    for (int n = 0; n < F; ++n) {
      const int fn = sf[n];
      if (n == m || fn < 0 || fn >= C) continue;
      part += sx[n] * vm[fn] * vn[static_cast<size_t>(n) * stride];
    }
    acc += sx[m] * part;
  }
  // block sum (its barrier also publishes the bucket table), then gs
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const float logit = lin[b] + 0.5f * acc;
      logits[b] = logit;
      gs_s[0] = (1.f / (1.f + expf(-logit)) - y[b]) * sw[b];
    }
  }
  __syncthreads();
  const float gs = gs_s[0];

  // g_m and g_m^2 of occurrence m start at m*out_stride of their bases
  OutT* out_g = g_out + occ0 * out_stride;
  OutT* out_g2 = g2_out + occ0 * out_stride;
  const int total = F * E;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int m = i / E;
    const int j = i - m * E;
    const float gx = gs * sx[m];
    float g;
    if (j == aug_lane) {
      g = gx;
    } else {
      const int fm = sf[m];
      const int k = j / C;
      const int c = j - k * C;
      float s = 0.f;
      if (fm >= 0 && fm < C) {
        const float* col = rows + k * C + fm;  // + n*stride: v_n[k, f_m]
        for (int q = bstart[c]; q < bstart[c + 1]; ++q) {
          const int n = border[q];
          if (n != m) s += sx[n] * col[static_cast<size_t>(n) * stride];
        }
      }
      g = gx * s;
    }
    const size_t at = static_cast<size_t>(m) * out_stride + j;
    put(out_g + at, g);
    put(out_g2 + at, g * g);
  }
}

// ---- the instance for C' = 40, K = 16, F <= 40 ----
constexpr int kC = 40;
constexpr int kK = 16;
constexpr int kE = kC * kK;
constexpr int kFMax = 40;
constexpr int kS = kE + 1;                 // staged row stride (floats)
constexpr int kSpecThreads = 320;
constexpr int kSpecWarps = kSpecThreads / 32;
constexpr int kQuads = kE / 4;             // float4 groups of slots in a row
static_assert(kC % 4 == 0 && kC <= 64 && kFMax <= 64, "bucket scan takes 2 per lane");

// Ints of dynamic shared memory before the staged rows: warp partial sums,
// gs and a pad, fields, values, field counts, bucket starts [C+1] and the
// occurrences in bucket order [FMAX] (rounded up to 4 ints).
constexpr int kSpecHead = (kSpecWarps + 2 + 3 * kFMax + kC + kC + 1 + 3) / 4 * 4;
constexpr size_t kSpecBytes = (kSpecHead + static_cast<size_t>(kFMax) * kS) * sizeof(float);

template <typename OutT>
__global__ void __launch_bounds__(kSpecThreads, 2)
ffm_fused_c40(const float* __restrict__ v, const int* __restrict__ fields,
              const float* __restrict__ vals, const float* __restrict__ lin,
              const float* __restrict__ y, const float* __restrict__ sw,
              float* __restrict__ logits, OutT* __restrict__ g_out,
              OutT* __restrict__ g2_out, int out_stride, int F, int aug_lane, int vec4) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const size_t occ0 = static_cast<size_t>(b) * F;
  float* red = smem;
  float* gs_s = red + kSpecWarps;
  int* sf = reinterpret_cast<int*>(gs_s + 2);
  float* sx = reinterpret_cast<float*>(sf + kFMax);
  int* cnt = reinterpret_cast<int*>(sx + kFMax);
  int* bstart = cnt + kC;
  int* border = bstart + kC + 1;
  float* xv = smem + kSpecHead;  // xv[m*kS + j] = x_m * v_m[j]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < F; i += kSpecThreads) {
    sf[i] = fields[occ0 + i];
    sx[i] = vals[occ0 + i];
  }
  const float* src = v + occ0 * kE;
  const float* xsrc = vals + occ0;
  const int total = F * kE;
  if (vec4) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int i = threadIdx.x; i < total / 4; i += kSpecThreads) {
      const float4 q = __ldg(src4 + i);
      const int m = i / kQuads;
      const float x = __ldg(xsrc + m);
      float* dst = xv + 4 * i + m;  // row m at m*kS = m*kE + m
      dst[0] = __fmul_rn(q.x, x);
      dst[1] = __fmul_rn(q.y, x);
      dst[2] = __fmul_rn(q.z, x);
      dst[3] = __fmul_rn(q.w, x);
    }
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < total; j += kSpecThreads) {
      const int m = j / kE;
      xv[j + m] = __fmul_rn(__ldg(src + j), __ldg(xsrc + m));
    }
  }
  __syncthreads();

  // field counts for the bucket table (threads c < C), beside the logit
  if (threadIdx.x < kC) {
    int n = 0;
    for (int m = 0; m < F; ++m) n += sf[m] == static_cast<int>(threadIdx.x);
    cnt[threadIdx.x] = n;
  }
  // The logit: work items (m, k), m fastest over kFMax slots, each summing
  // xv_m[k, f_n] * xv_n[k, f_m] over partners n != m with fields in range.
  float acc = 0.f;
  for (int w = threadIdx.x; w < kFMax * kK; w += kSpecThreads) {
    const int m = w % kFMax;
    const int k = w / kFMax;
    if (m >= F) continue;
    const int fm = sf[m];
    if (fm < 0 || fm >= kC) continue;
    const float* vm = xv + m * kS + k * kC;  // xv_m[k, .]
    const float* vn = xv + k * kC + fm;      // + n*kS: xv_n[k, f_m]
    float part = 0.f;
#pragma unroll 4
    for (int n = 0; n < F; ++n) {
      const int fn = sf[n];
      if (n == m || fn < 0 || fn >= kC) continue;
      part = fmaf(vm[fn], vn[n * kS], part);
    }
    acc += part;
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    // bucket starts: lane l holds the counts of fields 2l and 2l+1
    const int c0 = 2 * lane;
    const int a = c0 < kC ? cnt[c0] : 0;
    const int a1 = c0 + 1 < kC ? cnt[c0 + 1] : 0;
    int incl = a + a1;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const int excl = incl - a - a1;
    if (c0 < kC) bstart[c0] = excl;
    if (c0 + 1 < kC) bstart[c0 + 1] = excl + a;
    if (c0 + 2 == kC) bstart[kC] = incl;
    __syncwarp();
    // each occurrence m (lanes m and m - 32) takes its place in its bucket:
    // bstart[f_m] + the number of n < m with f_n == f_m
    for (int m = lane; m < F; m += 32) {
      const int fm = sf[m];
      if (fm < 0 || fm >= kC) continue;
      int rank = 0;
      for (int n = 0; n < m; ++n) rank += sf[n] == fm;
      border[bstart[fm] + rank] = m;
    }
    acc = lane < kSpecWarps ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const float logit = lin[b] + 0.5f * acc;
      logits[b] = logit;
      gs_s[0] = (1.f / (1.f + expf(-logit)) - y[b]) * sw[b];
    }
  }
  __syncthreads();
  const float gs = gs_s[0];

  // four slots (k, c0..c0+3) of occurrence m a thread: the bucket sums of
  // c0..c0+3 all read column k*C + f_m of their partners' rows; one store
  // of g and one of g^2 (16 bytes each for f32, 8 for bf16)
  OutT* out_g = g_out + occ0 * out_stride;
  OutT* out_g2 = g2_out + occ0 * out_stride;
  for (int i = threadIdx.x; i < F * kQuads; i += kSpecThreads) {
    const int m = i / kQuads;
    const int r = i - m * kQuads;
    const int k = r / (kC / 4);
    const int c0 = 4 * r - k * kC;
    const int fm = sf[m];
    const float gx = gs * sx[m];
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (fm >= 0 && fm < kC) {
      const float* col = xv + k * kC + fm;  // + n*kS: xv_n[k, f_m]
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q1 = bstart[c0 + u + 1];
        for (int q = bstart[c0 + u]; q < q1; ++q) {
          const int n = border[q];
          if (n != m) s[u] += col[n * kS];
        }
      }
    }
    float g[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) g[u] = 4 * r + u == aug_lane ? gx : gx * s[u];
    const size_t at = static_cast<size_t>(m) * out_stride + 4 * r;
    put4(out_g + at, g[0], g[1], g[2], g[3]);
    put4(out_g2 + at, g[0] * g[0], g[1] * g[1], g[2] * g[2], g[3] * g[3]);
  }
}

// The current device and its per-block shared-memory limit (opt-in), read
// from the runtime once per device.
cudaError_t device_optin(int* dev, int* optin) {
  static int cache[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[*dev] == 0) {
    int value = 0;
    err = cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return err;
    cache[*dev] = value;
  }
  *optin = cache[*dev];
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

bool takes_c40(int F, int C, int K) { return C == kC && K == kK && F >= 1 && F <= kFMax; }

// The instance that takes a sample of F occurrences at C' fields and K
// factors under `optin` bytes of shared memory a block: 2 the C' = 40,
// K = 16 instance, 1 the general one with its rows staged in shared
// memory, 0 the general one on rows in device memory, -1 none.
int pick_instance(int F, int C, int K, int optin) {
  const size_t limit = static_cast<size_t>(optin);
  if (takes_c40(F, C, K) && kSpecBytes <= limit) return 2;
  if (fused_floats(F, C, K, true) * sizeof(float) <= limit) return 1;
  if (fused_floats(F, C, K, false) * sizeof(float) <= limit) return 0;
  return -1;
}

// Launch the instance `instance` (pick_instance's code) with payload type
// OutT; each instantiation keeps its own once-per-device allowance flags.
template <typename OutT>
int launch_fused(int instance, int dev, int optin, const float* v, const int* fields,
                 const float* vals, const float* lin, const float* y, const float* sw,
                 float* logits, OutT* g, OutT* g2, int B, int F, int C, int K, int aug_lane,
                 cudaStream_t s) {
  static bool done_c40[kMaxDevices] = {};
  static bool done_staged[kMaxDevices] = {};
  static bool done_device[kMaxDevices] = {};
  const int E = C * K;
  const int vec4 = E % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int stride = g2 == nullptr ? 2 * E : E;
  OutT* second = g2 == nullptr ? g + E : g2;
  cudaError_t err;
  if (instance == 2) {
    err = allow_shared(&ffm_fused_c40<OutT>, dev, optin, done_c40);
    if (err != cudaSuccess) return static_cast<int>(err);
    ffm_fused_c40<OutT><<<B, kSpecThreads, kSpecBytes, s>>>(v, fields, vals, lin, y, sw, logits,
                                                            g, second, stride, F, aug_lane, vec4);
    return static_cast<int>(cudaGetLastError());
  }
  const bool staged = instance == 1;
  auto kernel = staged ? &ffm_fused_kernel<true, OutT> : &ffm_fused_kernel<false, OutT>;
  err = allow_shared(kernel, dev, optin, staged ? done_staged : done_device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = fused_floats(F, C, K, staged) * sizeof(float);
  kernel<<<B, kThreads, bytes, s>>>(v, fields, vals, lin, y, sw, logits, g, second, stride, F,
                                    C, K, aug_lane, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`: v [B*F, C*K], fields/vals [B, F], lin/y/sw/logits
// [B], all contiguous on the current device; aug_lane in [-1, C*K).  The
// payload, f32 (out_bf16 = 0) or bf16 (out_bf16 = 1), goes to g [B*F,
// 2*C*K] (combined, g2 null) or to g and g2, each [B*F, C*K] (split),
// 16-byte aligned.  Writes the instance it picked to *instance
// (pick_instance's code; left as it was when the device cannot be
// queried) and launches it.  Returns the CUDA error of the launch (0 on
// success, cudaErrorInvalidValue when no instance takes the shape); the
// caller raises on anything else.
int ffm_fused_launch(const float* v, const int* fields, const float* vals,
                     const float* lin, const float* y, const float* sw, float* logits,
                     void* g, void* g2, int B, int F, int C, int K, int aug_lane, int out_bf16,
                     void* stream, int* instance_out) {
  int dev = 0;
  int optin = 0;
  const cudaError_t err = device_optin(&dev, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int instance = pick_instance(F, C, K, optin);
  *instance_out = instance;
  if (instance < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return launch_fused(instance, dev, optin, v, fields, vals, lin, y, sw, logits,
                        static_cast<__nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(g2), B, F,
                        C, K, aug_lane, s);
  }
  return launch_fused(instance, dev, optin, v, fields, vals, lin, y, sw, logits,
                      static_cast<float*>(g), static_cast<float*>(g2), B, F, C, K, aug_lane, s);
}

}  // extern "C"
