// The no-w closed-form pass of the lazy-w probe: the CUDA counterpart of
// tools/micro_lazy.py::_pass3_kernel (entry point pass3).  Over every
// coordinate of the [R, E] tables n and z, given A:
//
//   sigma = (sqrt(n + A) - sqrt(n)) / alpha
//   w     = closed form (n, z)           from the PRE-update n and the z given
//   z     = z - sigma * w
//   n     = n + A
//
// n and z are rewritten in place (the Pallas kernel's input_output_aliases);
// no w table is read or written.  w from the pre-update n and the z as given
// is the probe's own stated approximation of a lazy-w update (it prices the
// bytes and operations, not the exact integration), ported as written.  As in
// csrc/ftrl_pass.cu, each operation is rounded on its own (no contracted
// multiply-adds, correctly rounded sqrtf and division; the build never passes
// --use_fast_math), so the kernel and the plain PyTorch version
// (ftrl_ffm_tpu_torch/tools/micro_lazy.py::pass3_plain) agree bit for bit.
//
// The Pallas kernel streams [br, E] blocks through VMEM and needs an R with an
// 8-multiple divisor that fits.  Here the pass is one grid-stride loop over all
// R*E floats with size_t indices, 16-byte loads and stores when all three
// tables are 16-byte aligned (a scalar loop takes the R*E % 4 tail, or
// everything otherwise): any R and E.  It is its own copy of ftrl_pass.cu's
// loop, not a shared device function: sharing code between kernels measured
// 10-70% slower on an H100 (PERF.md).
//
// What bounds it on an H100: bytes, five table streams (read n, z, A; write
// n, z): 12.8 GB at R = 1M, E = 640, 3.82 ms at the 3.35 TB/s peak, against
// the seven streams (17.9 GB) of kernel #3.  About 16 operations per
// coordinate, far below the card's f32 rate.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Params {
  float alpha, beta, l1, l2;
};

// One coordinate: w from (n, z) before the update, then z and n.
__device__ __forceinline__ void pass3_one(float& n, float& z, float a, const Params& p) {
  const float sqrt_n = sqrtf(n);
  const float sigma = __fdiv_rn(__fsub_rn(sqrtf(__fadd_rn(n, a)), sqrt_n), p.alpha);
  const float sl1 = z > 0.f ? p.l1 : -p.l1;
  const float den = __fadd_rn(p.l2, __fdiv_rn(__fadd_rn(p.beta, sqrt_n), p.alpha));
  const float w = fabsf(z) <= p.l1 ? 0.f : __fdiv_rn(-__fsub_rn(z, sl1), den);
  z = __fsub_rn(z, __fmul_rn(sigma, w));
  n = __fadd_rn(n, a);
}

// Floats [0, 4*count4) as float4s, then [4*count4, count) one by one.
__global__ void __launch_bounds__(kThreads)
micro_pass3_kernel(float* __restrict__ n, float* __restrict__ z, const float* __restrict__ a,
                   size_t count, size_t count4, Params p) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  float4* n4 = reinterpret_cast<float4*>(n);
  float4* z4 = reinterpret_cast<float4*>(z);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  for (size_t i = t; i < count4; i += stride) {
    float4 nn = n4[i], zz = z4[i];
    const float4 aa = a4[i];
    pass3_one(nn.x, zz.x, aa.x, p);
    pass3_one(nn.y, zz.y, aa.y, p);
    pass3_one(nn.z, zz.z, aa.z, p);
    pass3_one(nn.w, zz.w, aa.w, p);
    n4[i] = nn;
    z4[i] = zz;
  }
  for (size_t i = 4 * count4 + t; i < count; i += stride) {
    float nn = n[i], zz = z[i];
    pass3_one(nn, zz, a[i], p);
    n[i] = nn;
    z[i] = zz;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: n, z (updated in place) and a, `count` floats each,
// contiguous on the current device.  Returns the CUDA error of the launch
// (0 on success).
int micro_pass3_launch(float* n, float* z, const float* a, size_t count, float alpha,
                       float beta, float l1, float l2, void* stream) {
  if (count == 0) return 0;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = ((reinterpret_cast<uintptr_t>(n) | reinterpret_cast<uintptr_t>(z) |
                         reinterpret_cast<uintptr_t>(a)) &
                        15) == 0;
  const size_t count4 = aligned ? count / 4 : 0;
  const size_t work = count4 + (count - 4 * count4);
  size_t blocks = (work + kThreads - 1) / kThreads;
  const size_t cap = static_cast<size_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  micro_pass3_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(n, z, a, count, count4,
                                                            Params{alpha, beta, l1, l2});
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
