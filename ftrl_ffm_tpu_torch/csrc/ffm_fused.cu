// FFM logits and the FTRL payload of one train step: the CUDA counterpart of
// ftrl_ffm_tpu/ops/ffm_pallas.py::_ffm_fused_kernel (entry point
// ffm_fused_logits_grads, f32 output, combined or split).
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
// The sum is ops/interactions.py's T - oh_e * xv (the field-bucketed form of
// the Pallas kernel) without its one-hot contractions: a counting sort of the
// sample's fields into C' buckets lists, for each field c, the occurrences
// of c, so each output slot sums only its own bucket.  In canonical CTR data
// (one feature per field) every bucket holds one occurrence and a slot costs
// O(1).  Slot (0, aug_lane), when aug_lane >= 0, carries the linear gradient
// gs * x_m for every occurrence instead (ffm_pallas.py's
// where(lane == aug_lane, gx, g)).  An occurrence whose field lies outside
// [0, C') has a zero factor gradient and reads no row; a padding occurrence
// (x = 0) gives zeros.
//
// What bounds it on an H100: the store of the payload.  At B=16,384, F=39,
// C'=40, K=16 it reads 1.64 GB of rows but writes 3.27 GB of payload per
// batch (638,976 x 1280 x 4 B) for about 2 flops per stored float.  The
// design writes every value once and coalesced: one block per sample stages
// its rows in shared memory and takes the pair sum of the logit as
// ffm_logits.cu does, threads take consecutive slots (k, c) of one
// occurrence, and g^2 is squared in registers — no [B, F, E] temporaries.
// (The staging and the pair sum are written out here rather than shared
// with ffm_logits.cu through device functions: sharing them measured 10%
// slower for the logits kernel on an H100.)  A sample whose rows do not fit
// the per-block shared memory runs the same code on its rows in device
// memory (STAGED = false).
// Offsets into v and the payload are size_t: B*F*2E passes 2^31 at
// B = 65,536.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Floats of dynamic shared memory for one sample: the warp partial sums,
// gs (and a pad float), fields, values, bucket starts [C+1], the occurrences
// in bucket order [F], then the rows at stride E+1 when staged.
size_t fused_floats(int F, int C, int K, bool staged) {
  const size_t f = static_cast<size_t>(F);
  size_t n = kWarps + 2 + 3 * f + static_cast<size_t>(C) + 1;
  if (staged) n += f * (static_cast<size_t>(C) * K + 1);
  return n;
}

template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
ffm_fused_kernel(const float* __restrict__ v, const int* __restrict__ fields,
                 const float* __restrict__ vals, const float* __restrict__ lin,
                 const float* __restrict__ y, const float* __restrict__ sw,
                 float* __restrict__ logits, float* __restrict__ g_out,
                 float* __restrict__ g2_out, int out_stride, int F, int C, int K,
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
  float* out_g = g_out + occ0 * out_stride;
  float* out_g2 = g2_out + occ0 * out_stride;
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
    out_g[at] = g;
    out_g2[at] = g * g;
  }
}

// 1 when `floats` of dynamic shared memory fit one block on the current
// device, 0 when not, a negative CUDA error code when the device cannot be
// queried.
int fits_shared(size_t floats) {
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return floats * sizeof(float) <= static_cast<size_t>(optin) ? 1 : 0;
}

}  // namespace

extern "C" {

// 1 when a sample of F occurrences at C' fields and K factors stages its
// rows in shared memory on the current device, 0 when it runs from device
// memory, a negative CUDA error code when the device cannot be queried.
int ffm_fused_stages(int F, int C, int K) {
  return fits_shared(fused_floats(F, C, K, true));
}

// Launch on `stream`: v [B*F, C*K], fields/vals [B, F], lin/y/sw/logits
// [B], all contiguous on the current device; aug_lane in [-1, C*K).  The
// payload goes to g [B*F, 2*C*K] (combined, g2 null) or to g and g2, each
// [B*F, C*K] (split).  Returns the CUDA error of the launch (0 on
// success); the caller raises on anything else.
int ffm_fused_launch(const float* v, const int* fields, const float* vals,
                     const float* lin, const float* y, const float* sw, float* logits,
                     float* g, float* g2, int B, int F, int C, int K, int aug_lane,
                     void* stream) {
  if (B == 0) return 0;
  const int E = C * K;
  int staged = ffm_fused_stages(F, C, K);
  if (staged < 0) return -staged;
  if (!staged) {
    const int small = fits_shared(fused_floats(F, C, K, false));
    if (small < 0) return -small;
    if (!small) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec4 = E % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const size_t bytes = fused_floats(F, C, K, staged) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = staged ? &ffm_fused_kernel<true> : &ffm_fused_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int stride = g2 == nullptr ? 2 * E : E;
  kernel<<<B, kThreads, bytes, s>>>(v, fields, vals, lin, y, sw, logits, g,
                                    g2 == nullptr ? g + E : g2, stride, F, C, K, aug_lane,
                                    vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
