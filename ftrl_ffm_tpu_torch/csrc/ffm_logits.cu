// FFM logits for eval and serving: the CUDA counterpart of
// ftrl_ffm_tpu/ops/ffm_pallas.py::_ffm_logits_kernel (entry point
// ffm_fused_logits).
//
// What it computes, for each sample b with occurrences m = 0..F-1 (field
// f_m, value x_m, gathered factor row v_m of E = C'*K floats, slot (k, c) at
// k*C' + c, factor-major as in ops/layout.py):
//
//   logit_b = lin_b + 1/2 * sum over ordered pairs m != n with f_m, f_n in
//             [0, C') of x_m * x_n * sum_k v_m[k*C' + f_n] * v_n[k*C' + f_m]
//
// That is the sum 1/2 (cross - self) of ops/interactions.py::ffm_logits,
// taken in another order.  An occurrence whose field lies outside [0, C')
// selects nothing, as in the one-hot form, and no row is read outside
// [0, E).  Lane (k=0, c=n_fields), the linear mirror, is read only by an
// occurrence of field n_fields, which the parser never emits.
//
// What bounds it on an H100: bytes.  A sample reads its F gathered rows once
// (F*E*4 = 99,840 B at 39 fields, C'=40, K=16) for about 2*F*F*K = 49k
// flops: half a flop per byte, far below the card's ratio, so device-memory
// bandwidth is the limit.  The design reads every byte once and coalesced:
// one block per sample copies its rows (one contiguous span of v) into
// shared memory with 16-byte loads, then takes the pair sum from shared
// memory.  Rows sit at a stride of E+1 floats there, so the threads of a
// warp, which take consecutive occurrences m, hit distinct banks.  A sample
// whose rows do not fit the card's per-block shared memory (above 90
// occurrences at E = 640 on an H100) runs the same code on its rows in device memory
// (STAGED = false), so every F the stream reader can produce is served.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Floats of dynamic shared memory for one sample: the warp partial sums,
// the rows at stride E+1, then the fields and values.
size_t staged_floats(int F, int E) {
  return kWarps + static_cast<size_t>(F) * (E + 1) + 2 * static_cast<size_t>(F);
}

template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
ffm_logits_kernel(const float* __restrict__ v, const int* __restrict__ fields,
                  const float* __restrict__ vals, const float* __restrict__ lin,
                  float* __restrict__ out, int F, int C, int K, int vec4) {
  extern __shared__ float smem[];
  const int E = C * K;
  const int b = blockIdx.x;
  const size_t occ0 = static_cast<size_t>(b) * F;
  float* red = smem;

  const float* rows;
  const int* fld;
  const float* x;
  int stride;
  if constexpr (STAGED) {
    float* srows = smem + kWarps;
    int* sf = reinterpret_cast<int*>(srows + static_cast<size_t>(F) * (E + 1));
    float* sx = reinterpret_cast<float*>(sf + F);
    for (int i = threadIdx.x; i < F; i += kThreads) {
      sf[i] = fields[occ0 + i];
      sx[i] = vals[occ0 + i];
    }
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
    __syncthreads();
    rows = srows;
    fld = sf;
    x = sx;
    stride = E + 1;
  } else {
    rows = v + occ0 * E;
    fld = fields + occ0;
    x = vals + occ0;
    stride = E;
  }

  // Work item (m, k), m fastest: occurrence m's partner sum at factor k.
  float acc = 0.f;
  for (int w = threadIdx.x; w < F * K; w += kThreads) {
    const int m = w % F;
    const int k = w / F;
    const int fm = fld[m];
    if (fm < 0 || fm >= C) continue;
    const float* vm = rows + static_cast<size_t>(m) * stride + k * C;  // v_m[k, .]
    const float* vn = rows + k * C + fm;  // + n*stride: v_n[k, f_m]
    float part = 0.f;
    for (int n = 0; n < F; ++n) {
      const int fn = fld[n];
      if (n == m || fn < 0 || fn >= C) continue;
      part += x[n] * vm[fn] * vn[static_cast<size_t>(n) * stride];
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

}  // namespace

extern "C" {

// 1 when a sample of F occurrences at row width E fits in shared memory on
// the current device (the staged path), 0 when it runs from device memory,
// a negative CUDA error code when the device cannot be queried.
int ffm_logits_stages(int F, int E) {
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return staged_floats(F, E) * sizeof(float) <= static_cast<size_t>(optin) ? 1 : 0;
}

// Launch on `stream`: v [B*F, C*K], fields/vals [B, F], lin/out [B], all
// contiguous on the current device.  Returns the CUDA error of the launch
// (0 on success); the caller raises on anything else.
int ffm_logits_launch(const float* v, const int* fields, const float* vals,
                      const float* lin, float* out, int B, int F, int C, int K,
                      void* stream) {
  if (B == 0) return 0;
  const int E = C * K;
  const int staged = ffm_logits_stages(F, E);
  if (staged < 0) return -staged;
  const int vec4 = E % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged) {
    const size_t bytes = staged_floats(F, E) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ffm_logits_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ffm_logits_kernel<true><<<B, kThreads, bytes, s>>>(v, fields, vals, lin, out, F, C,
                                                        K, vec4);
  } else {
    ffm_logits_kernel<false><<<B, kThreads, kWarps * sizeof(float), s>>>(
        v, fields, vals, lin, out, F, C, K, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
