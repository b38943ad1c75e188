// FFM logits and combined payload for canonical fields: the CUDA counterpart
// of tools/micro_canon_kernel.py::_canon_kernel (entry point canon).
//
// Canonical fields means occurrence m of every sample is field m
// (fields[b] == 0..C-1, one feature per field, the Criteo layout after the
// usual preparation).  The shape is the probe's: C = 40 padded fields, K = 16
// factors, E = C*K = 640, the linear gradient in lane 39.  With
// xv[m, (k, c)] = x_m * v_m[k*C + c] (row m of the sample, slot (k, c),
// factor-major as in ops/layout.py):
//
//   s_t[m, (k, c)] = xv[c, (k, m)]         the field crossing, no sort
//   cross          = sum over m, (k, c) of xv[m, (k, c)] * s_t[m, (k, c)]
//   self_sq        = sum over m, k of xv[m, (k, m)]^2   (a static mask)
//   logit          = lin + 0.5 * (cross - self_sq)
//   gs             = (sigmoid(logit) - y) * sample_w,  gx_m = gs * x_m
//   g[m, (k, c)]   = gx_m * (s_t[m, (k, c)] - [c == m] * xv[m, (k, c)])
//   g[m, 39]       = gx_m                  (the linear gradient's lane)
//   out[m]         = (g[m] || g[m]^2), 2E floats per occurrence
//
// NOTR = true is the probe's timing variant without the crossing:
// s_t = xv + 1.  Kernel #2 (csrc/ffm_fused.cu) computes the same payload for
// any fields with a per-sample counting sort into field buckets; here the
// buckets are the identity, so no sort and no bucket table.
//
// What bounds it on an H100: bytes.  At B = 16,384, C = 40, K = 16 it reads
// 1.68 GB of rows and writes 3.36 GB of payload: 5.03 GB, 1.50 ms at the
// 3.35 TB/s peak, for about 6 flops per stored float.  One block per sample
// stages the sample's C rows, already scaled by x_m, in shared memory at a
// stride of E+1 floats (102.6 KB at E = 640, so two blocks share an SM): the
// crossing reads xv[c, (k, m)] with consecutive threads on consecutive c, which
// the odd stride puts in distinct banks.  Threads take consecutive slots of
// one occurrence, so both halves of the payload are stored coalesced, once.
// The Pallas kernel takes B a multiple of its block of samples; this one any
// B.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int C = 40;         // padded fields
constexpr int K = 16;         // factors
constexpr int E = C * K;      // row width
constexpr int kAugLane = 39;  // the linear gradient's lane (k = 0, c = 39)

// Floats of dynamic shared memory: the warp partial sums, gs (and a pad
// float), the sample's values [C], then its scaled rows at stride E+1.
constexpr size_t kCanonFloats = kWarps + 2 + C + C * (E + 1);

template <bool NOTR>
__global__ void __launch_bounds__(kThreads)
micro_canon_kernel(const float* __restrict__ v, const float* __restrict__ vals,
                   const float* __restrict__ lin, const float* __restrict__ y,
                   const float* __restrict__ sw, float* __restrict__ logits,
                   float* __restrict__ out, int vec4) {
  extern __shared__ float smem[];
  constexpr int S = E + 1;
  const int b = blockIdx.x;
  const size_t occ0 = static_cast<size_t>(b) * C;
  float* red = smem;
  float* gs_s = red + kWarps;
  float* sx = gs_s + 2;
  float* xv = sx + C;
  for (int i = threadIdx.x; i < C; i += kThreads) sx[i] = vals[occ0 + i];
  __syncthreads();

  // xv[m*(E+1) + j] = x_m * v_m[j]: the sample's rows are one contiguous
  // span of v
  const float* src = v + occ0 * E;
  constexpr int total = C * E;
  if (vec4) {
    // E % 4 == 0, so the four floats of a load share one row
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int i = threadIdx.x; i < total / 4; i += kThreads) {
      const float4 q = __ldg(src4 + i);
      const int j = 4 * i;
      const int m = j / E;
      const float x = sx[m];
      float* dst = xv + j + m;
      dst[0] = __fmul_rn(q.x, x);
      dst[1] = __fmul_rn(q.y, x);
      dst[2] = __fmul_rn(q.z, x);
      dst[3] = __fmul_rn(q.w, x);
    }
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < total; j += kThreads) {
      const int m = j / E;
      xv[j + m] = __fmul_rn(__ldg(src + j), sx[m]);
    }
  }
  __syncthreads();

  // cross - self_sq over every (m, (k, c)): slot (k, c) of row m meets slot
  // (k, m) of row c
  float acc = 0.f;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int m = i / E;
    const int j = i - m * E;
    const int k = j / C;
    const int c = j - k * C;
    const float x = xv[m * S + j];
    const float st = NOTR ? __fadd_rn(x, 1.f) : xv[c * S + k * C + m];
    acc += x * st;
    if (c == m) acc -= x * x;
  }
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

  // (g || g^2) of occurrence m at (b*C + m) * 2E
  float* ob = out + occ0 * 2 * E;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int m = i / E;
    const int j = i - m * E;
    const float gx = __fmul_rn(gs, sx[m]);
    float g;
    if (j == kAugLane) {
      g = gx;
    } else {
      const int k = j / C;
      const int c = j - k * C;
      const float x = xv[m * S + j];
      const float st = NOTR ? __fadd_rn(x, 1.f) : xv[c * S + k * C + m];
      g = __fmul_rn(gx, __fsub_rn(st, c == m ? x : 0.f));
    }
    const size_t at = static_cast<size_t>(m) * 2 * E + j;
    ob[at] = g;
    ob[at + E] = __fmul_rn(g, g);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: v [B*40, 640], vals [B, 40], lin/y/sw/logits [B], out
// [B*40, 1280], all contiguous f32 on the current device.  notr != 0 runs the
// variant without the field crossing.  Returns the CUDA error of the launch
// (0 on success), or cudaErrorInvalidValue when a sample's rows do not fit
// one block's shared memory.
int micro_canon_launch(const float* v, const float* vals, const float* lin, const float* y,
                       const float* sw, float* logits, float* out, int B, int notr,
                       void* stream) {
  if (B == 0) return 0;
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = kCanonFloats * sizeof(float);
  if (bytes > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec4 = reinterpret_cast<uintptr_t>(v) % 16 == 0;
  auto kernel = notr ? &micro_canon_kernel<true> : &micro_canon_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      v, vals, lin, y, sw, logits, out, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
