// The FTRL table update of one train step, deterministic, touched rows only,
// and the z/A scatter of the huge-table in-place update.
// No Pallas kernel did this on the TPU: there XLA lowered
// ftrl_ffm_tpu/ftrl.py::dense_ftrl_update2_aug (a scatter-add of the
// combined (g || g^2) payload into a zeroed [R, 2E] accumulator, then the
// closed form over the whole table).  A scatter-add with float atomics sums
// duplicates in no fixed order, and the JAX package is bit-deterministic, so
// the port sums each row's payload rows in one fixed order instead.
//
// Input: the payload's row ids sorted stably (sids, and perm: sorted slot ->
// payload row), so the occurrences of one id form a segment in ascending
// payload order.  One warp per segment start (a position whose id differs
// from its left neighbour; the warps stride over all positions, so no
// segment list is built and the host never waits): for its row id, lane by
// lane over the columns, it sums gg2[perm[j]] over the segment in sorted
// order (reading through the permutation, no sorted copy of the payload),
// then applies the accumulator step and the closed form to vec_n/z/w[id]
// in place — reading the row's pre-step w for sigma * w before writing it.
// On the linear lane (`lane` >= 0, the dead-lane mirror) the same sums also
// update lin_n/z/w[id]; without one (lane = -1) the linear stats come from
// their own [N, 2] payload gg2_lin.  Ids outside [0, R) — the padding
// sentinel n_feats — are skipped.  Rows no id touches are not read or
// written: the dense form leaves them as they are too (sigma = 0, the same
// closed form).  The closed form rounds each operation on its own (no
// contracted multiply-adds), as the plain PyTorch version does.
//
// What bounds it on an H100: bytes.  At the bench shape (B=16,384, F=39,
// E=640, 100k rows) it reads the 3.27 GB payload once plus about 1.5 GB of
// touched table rows read and written.  Each lane reads consecutive
// columns, so a warp reads 128 contiguous bytes per payload row and column
// block.  A very frequent id is one warp's serial work: heavy-tailed data
// would want the segment split across warps.
//
// With E = 0 (no factor tables given) only the linear tables are updated,
// from gg2_lin: the huge-table path's separate linear step when no dead
// lane mirrors them.
//
// The payload and the vec_w table each come as float or __nv_bfloat16
// (template parameters P and W; Config.acc_dtype and table_dtype, all four
// pairs reachable).  A bf16 payload is summed as the JAX package sums it
// into its bf16 accumulator (ftrl_ffm_tpu/ftrl.py::dense_ftrl_update2_aug's
// zeros(bf16).at[ids].add): each add in f32, rounded to bf16 at once,
// acc = bf16(acc + x), in ascending payload order; the rounded sums then
// meet the f32 n and z, and on the linear lane the f32 linear tables.  A
// bf16 w is widened before the math and the new w rounded to nearest even
// at the store.  gg2_lin and the n, z and linear tables stay f32.  With a
// bf16 payload and a bf16 w the bench shape's bound falls from 1.44 ms to
// 0.87 ms (1.64 GB of payload, 1.28 GB of touched rows).
//
// za_scatter_kernel is the z/A scatter of the huge-table in-place update:
// XLA lowered its two scatter-adds (ftrl_ffm_tpu/ftrl.py::
// dense_ftrl_update_inplace, z.at[ids].add(g) and zeros.at[ids].add(g2)) on
// the TPU.  The same sorted segments, one warp each, sum the split payload
// g, g2 [N, E] in ascending payload order and write z[id] += sum g (the
// row's sum added once; JAX adds each g into z in turn) and A[id] = sum g^2.
// A must be zero on every row no id touches (the caller zeroes it each
// step); csrc/ftrl_pass.cu's closed-form pass follows.  It reads the 3.27 GB
// payload and reads and writes z and writes A on the touched rows (about
// 470k of a 1M-row table with the synthetic ids).  It keeps its own copy of
// the segment loop: sharing it with ftrl_update_kernel through inline device
// functions slowed that kernel from 2.67 to 4.54 ms at the bench shape
// (H100 80GB HBM3 at 700 W, both versions timed in one run).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// A table or payload value widened to f32, and an f32 value stored into a
// table (rounded to nearest even for bf16).
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// One add of a payload value into its segment's sum: an f32 sum for an f32
// payload; for a bf16 payload the bf16 accumulator of the JAX package,
// rounded after every add.
__device__ __forceinline__ float accumulate(float acc, float x) { return acc + x; }
__device__ __forceinline__ float accumulate(float acc, __nv_bfloat16 x) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, __bfloat162float(x))));
}

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kCols = 8;  // columns per lane per pass over a segment
constexpr float kUntouchedN = 1e-16f;  // ftrl.py::UNTOUCHED_N

struct Ftrl {
  float alpha, beta, l1, l2;
};

// One coordinate: accumulator step with the pre-step w, then the closed
// form where the coordinate has been touched (ftrl.py::_closed_step).
template <typename W>
__device__ __forceinline__ void ftrl_step(float* n_p, float* z_p, W* w_p, float g, float g2,
                                          const Ftrl& p) {
  const float n = *n_p;
  const float w = load(w_p);
  const float new_n = __fadd_rn(n, g2);
  const float sigma = __fdiv_rn(__fsub_rn(sqrtf(new_n), sqrtf(n)), p.alpha);
  const float new_z = __fsub_rn(__fadd_rn(*z_p, g), __fmul_rn(sigma, w));
  float new_w = w;
  if (new_n > kUntouchedN) {
    const float sl1 = new_z > 0.f ? p.l1 : -p.l1;
    const float den = __fadd_rn(p.l2, __fdiv_rn(__fadd_rn(p.beta, sqrtf(new_n)), p.alpha));
    new_w = fabsf(new_z) <= p.l1 ? 0.f : __fdiv_rn(-__fsub_rn(new_z, sl1), den);
  }
  *n_p = new_n;
  *z_p = new_z;
  store(w_p, new_w);
}

template <typename P, typename W>
__global__ void __launch_bounds__(kThreads)
ftrl_update_kernel(const int* __restrict__ sids, const long long* __restrict__ perm, int N,
                   const P* __restrict__ gg2, const float* __restrict__ gg2_lin,
                   float* vec_n, float* vec_z, W* vec_w, float* lin_n, float* lin_z,
                   float* lin_w, int R, int E, int lane, Ftrl p) {
  const int ln = threadIdx.x & 31;
  const int warps = gridDim.x * kWarpsPerBlock;
  const size_t w2 = 2 * static_cast<size_t>(E);
  for (int j = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); j < N; j += warps) {
    const int id = sids[j];
    if ((j > 0 && sids[j - 1] == id) || id < 0 || id >= R) continue;
    int end = j + 1;
    while (end < N && sids[end] == id) ++end;
    const size_t row = static_cast<size_t>(id) * E;
    for (int c0 = 0; c0 < E; c0 += 32 * kCols) {
      float g[kCols], g2[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) g[u] = g2[u] = 0.f;
      for (int q = j; q < end; ++q) {
        const P* src = gg2 + static_cast<size_t>(perm[q]) * w2;
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int c = c0 + ln + 32 * u;
          if (c < E) {
            g[u] = accumulate(g[u], src[c]);
            g2[u] = accumulate(g2[u], src[E + c]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = c0 + ln + 32 * u;
        if (c < E) {
          ftrl_step(vec_n + row + c, vec_z + row + c, vec_w + row + c, g[u], g2[u], p);
          if (c == lane) ftrl_step(lin_n + id, lin_z + id, lin_w + id, g[u], g2[u], p);
        }
      }
    }
    if (lane < 0 && ln == 0) {
      float g = 0.f, g2 = 0.f;
      for (int q = j; q < end; ++q) {
        const float* src = gg2_lin + 2 * static_cast<size_t>(perm[q]);
        g += src[0];
        g2 += src[1];
      }
      ftrl_step(lin_n + id, lin_z + id, lin_w + id, g, g2, p);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
za_scatter_kernel(const int* __restrict__ sids, const long long* __restrict__ perm, int N,
                  const float* __restrict__ g, const float* __restrict__ g2,
                  float* __restrict__ z, float* __restrict__ a, int R, int E) {
  const int ln = threadIdx.x & 31;
  const int warps = gridDim.x * kWarpsPerBlock;
  for (int j = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); j < N; j += warps) {
    const int id = sids[j];
    if ((j > 0 && sids[j - 1] == id) || id < 0 || id >= R) continue;
    int end = j + 1;
    while (end < N && sids[end] == id) ++end;
    const size_t row = static_cast<size_t>(id) * E;
    for (int c0 = 0; c0 < E; c0 += 32 * kCols) {
      float sg[kCols], sg2[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) sg[u] = sg2[u] = 0.f;
      for (int q = j; q < end; ++q) {
        const size_t at = static_cast<size_t>(perm[q]) * E;
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int c = c0 + ln + 32 * u;
          if (c < E) {
            sg[u] += g[at + c];
            sg2[u] += g2[at + c];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = c0 + ln + 32 * u;
        if (c < E) {
          z[row + c] = __fadd_rn(z[row + c], sg[u]);
          a[row + c] = sg2[u];
        }
      }
    }
  }
}

int segment_blocks(int N) {
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return blocks > 4096 ? 4096 : blocks;
}

template <typename P, typename W>
int launch_update(const int* sids, const long long* perm, int N, const void* gg2,
                  const float* gg2_lin, float* vec_n, float* vec_z, void* vec_w, float* lin_n,
                  float* lin_z, float* lin_w, int R, int E, int lane, Ftrl p,
                  cudaStream_t stream) {
  ftrl_update_kernel<P, W><<<segment_blocks(N), kThreads, 0, stream>>>(
      sids, perm, N, static_cast<const P*>(gg2), gg2_lin, vec_n, vec_z, static_cast<W*>(vec_w),
      lin_n, lin_z, lin_w, R, E, lane, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`: sids [N] int32 sorted stably, perm [N] int64, gg2
// [N, 2E] (f32, or bf16 when payload_bf16), gg2_lin [N, 2] f32 (read only
// when lane < 0), vec tables [R, E] (unused when E = 0; vec_w f32, or bf16
// when w_bf16) and lin tables [R] updated in place, all contiguous on the
// current device.  Returns the CUDA error of the launch (0 on success).
int ftrl_update_launch(const int* sids, const long long* perm, int N, const void* gg2,
                       const float* gg2_lin, float* vec_n, float* vec_z, void* vec_w,
                       float* lin_n, float* lin_z, float* lin_w, int R, int E, int lane,
                       int payload_bf16, int w_bf16, float alpha, float beta, float l1,
                       float l2, void* stream) {
  if (N == 0) return 0;
  const Ftrl p{alpha, beta, l1, l2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (payload_bf16) {
    return w_bf16 ? launch_update<bf16, bf16>(sids, perm, N, gg2, gg2_lin, vec_n, vec_z, vec_w,
                                              lin_n, lin_z, lin_w, R, E, lane, p, s)
                  : launch_update<bf16, float>(sids, perm, N, gg2, gg2_lin, vec_n, vec_z,
                                               vec_w, lin_n, lin_z, lin_w, R, E, lane, p, s);
  }
  return w_bf16 ? launch_update<float, bf16>(sids, perm, N, gg2, gg2_lin, vec_n, vec_z, vec_w,
                                             lin_n, lin_z, lin_w, R, E, lane, p, s)
                : launch_update<float, float>(sids, perm, N, gg2, gg2_lin, vec_n, vec_z, vec_w,
                                              lin_n, lin_z, lin_w, R, E, lane, p, s);
}

// Launch on `stream`: sids [N] int32 sorted stably, perm [N] int64, g and
// g2 [N, E], z and a [R, E] (a zero on the rows no id touches), all
// contiguous on the current device: z[id] += sum g, a[id] = sum g^2.
// Returns the CUDA error of the launch (0 on success).
int za_scatter_launch(const int* sids, const long long* perm, int N, const float* g,
                      const float* g2, float* z, float* a, int R, int E, void* stream) {
  if (N == 0 || E == 0) return 0;
  za_scatter_kernel<<<segment_blocks(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sids, perm, N, g, g2, z, a, R, E);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
