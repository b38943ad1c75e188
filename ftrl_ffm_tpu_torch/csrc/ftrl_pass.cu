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
// What bounds it on an H100: bytes, seven table streams (read n, z', w, A;
// write n, z, w): 17.9 GB at R = 1M, E = 640, about 5.4 ms at the 3.35 TB/s
// peak.  A later design could skip the rows no id touched (A = 0 there: the
// pass leaves their n and z as they are and recomputes the w they hold),
// which is what csrc/ftrl_update.cu's touched-rows update does in one pass.

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

// Floats [0, 4*count4) as float4s, then [4*count4, count) one by one.
__global__ void __launch_bounds__(kThreads)
ftrl_pass_kernel(float* __restrict__ n, float* __restrict__ z, float* __restrict__ w,
                 const float* __restrict__ a, size_t count, size_t count4, Params p) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  float4* n4 = reinterpret_cast<float4*>(n);
  float4* z4 = reinterpret_cast<float4*>(z);
  float4* w4 = reinterpret_cast<float4*>(w);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  for (size_t i = t; i < count4; i += stride) {
    float4 nn = n4[i], zz = z4[i], ww = w4[i];
    const float4 aa = a4[i];
    pass_one(nn.x, zz.x, ww.x, aa.x, p);
    pass_one(nn.y, zz.y, ww.y, aa.y, p);
    pass_one(nn.z, zz.z, ww.z, aa.z, p);
    pass_one(nn.w, zz.w, ww.w, aa.w, p);
    n4[i] = nn;
    z4[i] = zz;
    w4[i] = ww;
  }
  for (size_t i = 4 * count4 + t; i < count; i += stride) {
    float nn = n[i], zz = z[i], ww = w[i];
    pass_one(nn, zz, ww, a[i], p);
    n[i] = nn;
    z[i] = zz;
    w[i] = ww;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: n, z, w (updated in place) and a, `count` floats each,
// contiguous on the current device.  Returns the CUDA error of the launch
// (0 on success).
int ftrl_pass_launch(float* n, float* z, float* w, const float* a, size_t count,
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
                         reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(a)) &
                        15) == 0;
  const size_t count4 = aligned ? count / 4 : 0;
  const size_t work = count4 + (count - 4 * count4);
  size_t blocks = (work + kThreads - 1) / kThreads;
  const size_t cap = static_cast<size_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  ftrl_pass_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(n, z, w, a, count, count4,
                                                          Params{alpha, beta, l1, l2});
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
