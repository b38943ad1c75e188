// The closed-form pass of the huge-table in-place FTRL update: the CUDA
// counterpart of ftrl_ffm_tpu/ops/ftrl_pallas.py::_pass_kernel (entry point
// closed_form_pass_pallas).  Over every coordinate of the [R, E] tables,
// after csrc/ftrl_update.cu's za_scatter has left z' = z + sum g in z and
// A = sum g^2 in a:
//
//   sigma = (sqrt(n + A) - sqrt(n)) / alpha
//   z     = z' - sigma * w
//   n     = n + A
//   w     = closed form (n, z)   where n > UNTOUCHED_N, else w kept
//
// n, z and w are rewritten in place, as the Pallas kernel's
// input_output_aliases does.  Each operation is rounded on its own, as in
// ftrl_update.cu's ftrl_step and the plain PyTorch version (no contracted
// multiply-adds, correctly rounded sqrtf and division: the build never
// passes --use_fast_math), so a coordinate with A = 0 keeps its n and z bits
// and its w is what ftrl_step would give.
//
// The Pallas kernel streams [br, E] blocks through VMEM and takes only E a
// multiple of 128 and an R with an 8-multiple divisor that fits (the JAX
// package falls back to XLA otherwise).  Here the pass is one grid-stride
// loop over all R*E floats with size_t indices, 16-byte loads and stores
// when all four tables are 16-byte aligned (a scalar loop takes the R*E % 4
// tail, or everything otherwise): any R and E.
//
// The w table is float or __nv_bfloat16 (template parameter W;
// Config.table_dtype=bfloat16, ftrl_pallas.py's w_ref.astype / w_out
// .astype): a bf16 w is widened before the math and the new w rounded to
// nearest even at the store.  A coordinate with A = 0 keeps its n and z
// bits, and its recomputed w, the same f32 value as the one stored, rounds
// to the stored bf16.  With a bf16 w the vector loop reads and writes four
// w values as 8 bytes (when n, z and A are 16-byte aligned and w 8-byte).
//
// What bounds it on an H100: bytes, seven table streams (read n, z', w, A;
// write n, z, w): 17.9 GB at R = 1M, E = 640, about 5.4 ms at the 3.35 TB/s
// peak; with a bf16 w 15.4 GB, 4.6 ms.  A later design could skip the rows
// no id touched (A = 0 there: the pass leaves their n and z as they are and
// recomputes the w they hold), which is what csrc/ftrl_update.cu's
// touched-rows update does in one pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr float kUntouchedN = 1e-16f;  // ftrl.py::UNTOUCHED_N

struct Params {
  float alpha, beta, l1, l2;
};

// One coordinate; w = closed form (ftrl.py::ftrl_weights) where touched.
__device__ __forceinline__ void pass_one(float& n, float& z, float& w, float a,
                                         const Params& p) {
  const float new_n = __fadd_rn(n, a);
  const float sigma = __fdiv_rn(__fsub_rn(sqrtf(new_n), sqrtf(n)), p.alpha);
  z = __fsub_rn(z, __fmul_rn(sigma, w));
  n = new_n;
  if (new_n > kUntouchedN) {
    const float sl1 = z > 0.f ? p.l1 : -p.l1;
    const float den = __fadd_rn(p.l2, __fdiv_rn(__fadd_rn(p.beta, sqrtf(new_n)), p.alpha));
    w = fabsf(z) <= p.l1 ? 0.f : __fdiv_rn(-__fsub_rn(z, sl1), den);
  }
}

// w values widened to f32, and stored back (bf16: rounded to nearest
// even): one at a time, or the four at 4*i.
__device__ __forceinline__ float load(const float* w, size_t i) { return w[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* w, size_t i) {
  return __bfloat162float(w[i]);
}
__device__ __forceinline__ void store(float* w, size_t i, float x) { w[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* w, size_t i, float x) {
  w[i] = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float4 load4(const float* w, size_t i) {
  return reinterpret_cast<const float4*>(w)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* w, size_t i) {
  const uint2 u = reinterpret_cast<const uint2*>(w)[i];
  const float2 lo = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162&>(u.x));
  const float2 hi = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162&>(u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* w, size_t i, float4 x) {
  reinterpret_cast<float4*>(w)[i] = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* w, size_t i, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  reinterpret_cast<uint2*>(w)[i] =
      make_uint2(reinterpret_cast<const unsigned&>(lo), reinterpret_cast<const unsigned&>(hi));
}

// Coordinates [0, 4*count4) four at a time (float4 n, z, A; four w), then
// [4*count4, count) one by one.
template <typename W>
__global__ void __launch_bounds__(kThreads)
ftrl_pass_kernel(float* __restrict__ n, float* __restrict__ z, W* __restrict__ w,
                 const float* __restrict__ a, size_t count, size_t count4, Params p) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  float4* n4 = reinterpret_cast<float4*>(n);
  float4* z4 = reinterpret_cast<float4*>(z);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  for (size_t i = t; i < count4; i += stride) {
    float4 nn = n4[i], zz = z4[i], ww = load4(w, i);
    const float4 aa = a4[i];
    pass_one(nn.x, zz.x, ww.x, aa.x, p);
    pass_one(nn.y, zz.y, ww.y, aa.y, p);
    pass_one(nn.z, zz.z, ww.z, aa.z, p);
    pass_one(nn.w, zz.w, ww.w, aa.w, p);
    n4[i] = nn;
    z4[i] = zz;
    store4(w, i, ww);
  }
  for (size_t i = 4 * count4 + t; i < count; i += stride) {
    float nn = n[i], zz = z[i], ww = load(w, i);
    pass_one(nn, zz, ww, a[i], p);
    n[i] = nn;
    z[i] = zz;
    store(w, i, ww);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: n, z, w (updated in place) and a, `count` values
// each, contiguous on the current device; w is f32, or bf16 when w_bf16.
// Returns the CUDA error of the launch (0 on success).
int ftrl_pass_launch(float* n, float* z, void* w, const float* a, size_t count, int w_bf16,
                     float alpha, float beta, float l1, float l2, void* stream) {
  if (count == 0) return 0;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = ((reinterpret_cast<uintptr_t>(n) | reinterpret_cast<uintptr_t>(z) |
                         reinterpret_cast<uintptr_t>(a)) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(w) & (w_bf16 ? 7 : 15)) == 0;
  const size_t count4 = aligned ? count / 4 : 0;
  const size_t work = count4 + (count - 4 * count4);
  size_t blocks = (work + kThreads - 1) / kThreads;
  const size_t cap = static_cast<size_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const Params p{alpha, beta, l1, l2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    ftrl_pass_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        n, z, static_cast<__nv_bfloat16*>(w), a, count, count4, p);
  } else {
    ftrl_pass_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        n, z, static_cast<float*>(w), a, count, count4, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
