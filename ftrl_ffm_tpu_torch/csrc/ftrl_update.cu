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
// payload order.  The payload comes in one of two layouts, a compile-time
// parameter (Split) of every update kernel below:
//
// - combined (one device's "dense2" and "sparse2"): gg2 [N, 2E], g in a
//   row's first E values and g^2 in its last E;
// - split (the owner's update on a (1, N) route mesh,
//   parallel/sharded.py::_update_routed): g and g^2 as the two all_to_all
//   outputs [M*K, E] arrive, from two bases with one row stride, read in
//   place (a concatenation would copy ~1.6 GB a step at k=16).
//
// The combined instances read gg2 and gg2 + E at a stride of 2E, as they did
// before the split form existed, so they compile to the same code.  For
// its row id, each coordinate sums the g and g^2 of payload rows perm[j]
// over the segment in sorted order, one add at a time from 0 (reading
// through the permutation, no sorted copy of the payload), then applies the
// accumulator step and the closed form to vec_n/z/w[id] in place — reading
// the row's pre-step w for sigma * w before writing it.  On the linear lane
// (`lane` >= 0, the dead-lane mirror) the same sums also update
// lin_n/z/w[id]; without one (lane = -1) the linear stats come from their
// own [N, 2] payload gg2_lin, summed the same way.  Ids outside [0, R) —
// the padding sentinel n_feats, a route's empty slots R — are skipped,
// their payload never read.  Rows no id touches are not read or written:
// the dense form and kernel #3's pass leave them as they are too (sigma =
// 0, the same closed form).  The closed form rounds each operation on its
// own (no contracted multiply-adds), as the plain PyTorch version does.  Every
// coordinate keeps that order and those operations whichever kernel below
// runs it, so all three give the same bits.
//
// What bounds it on an H100: bytes.  At the bench shape (B=16,384, F=39,
// E=640, 100k rows) it reads the 3.27 GB payload once plus about 1.5 GB of
// touched table rows read and written: 1.436 ms at 3.35 TB/s.  Its
// kernels:
//
// - ftrl_update_kernel (E % 4 == 0 and the tables and payloads aligned for
//   16-byte f32 and 8-byte bf16 accesses: every training shape).  A
//   persistent grid (as many blocks as fit, sized once per device) whose
//   warps walk tiles of 32 sorted positions: a warp loads a tile's ids at
//   once and takes its segment starts (an id that differs from its left
//   neighbour) from one __ballot_sync, then, start by start, finds the
//   segment's end with ballots over the next positions.  The warp covers a
//   whole 640-wide row in one pass: each lane holds five 4-column quads of g
//   and of g^2 (a float4, or 8 bytes of bf16), ten streaming 16- or 8-byte
//   loads in flight per payload row (__ldcs: the payload is read once and
//   would only evict the table rows from L2).  The segment's perm entries
//   are loaded 32 at a time and broadcast by shuffle.  The table rows are
//   read and written as float4 (n, z) and float4 or 8 bytes (w).  Registers
//   are capped so that two blocks (f32 payload) or three (bf16) share an
//   SM: more warps in flight measured faster than more payload rows loaded
//   ahead by each (update_blocks_per_sm).  A segment longer than
//   kHotRows (64) payload rows is not summed here: its start goes to a list
//   in device memory (an atomic counter; the list's order does not matter,
//   each segment is its own rows) for the next kernel.
// - ftrl_update_hot: the segments of that list, split by columns (one id
//   in most rows of a batch: ~15k payload rows).  One block per (segment,
//   32-column slice): its eight warps copy the slice of the next payload
//   rows with cp.async into a ring of four 64-row chunks in shared memory,
//   while warp 0 sums the current chunk, one lane a column, in order (and,
//   with lane = -1, one thread of warp 1 sums the gg2_lin pairs the ring
//   also holds).  So a hot id costs ~15k dependent adds on 20 SMs at once
//   instead of ~15k payload rows' loads on one warp.
// - ftrl_update_scalar (any other E or alignment): the earlier design, one
//   warp per segment start over all positions, columns in passes of 256.
//
// Narrow rows (0 <= E <= kNarrowCols = 32: FM's K=16 row, LR's E = 0) take
// ftrl_update_narrow instead of ftrl_update_kernel, chosen from E alone.  A
// warp built for 640 columns would spend a whole pass on a 16-wide row (4
// of its 32 lanes busy) and walk a tile's ~30 segments one after another.
// Here a group of GS lanes (a power of two >= E / 4, one quad a lane) takes
// one segment, so 32 / GS segments are in flight per warp: at E = 16, 8
// segments of 4 lanes.  The warp first lists the tile's segments in shared
// memory (tile_segments: starts from one ballot, each end from the next
// boundary in the tile, the last one's from ballots past the tile, capped
// at kHotRows; longer ones go to ftrl_update_hot's list) with the tile's 32
// perm entries, then each group sums its segments' rows in order, one
// float4 (or 8 bytes of bf16) of g and one of g^2 a lane, read streaming,
// kBatchRows rows' loads in flight before their adds.  With lane = -1 the
// group's first lane sums the gg2_lin pairs in order; on the linear lane
// the lane holding that column updates lin_n/z/w.  At E = 0 (only the
// linear tables) the groups are single lanes: each lane that starts a
// segment sums its own gg2_lin pairs, 32 segments in flight.  Bytes bound
// them too: at FM's E = 16 (100k rows, ~99,800 touched, N = 638,976) the
// 82 MB payload and the touched rows take 0.039 ms at 3.35 TB/s, at E = 0
// the pairs 0.003 ms; the rows sit at random addresses, 64 bytes each.
//
// The host never waits for a count: the hot kernel reads the list's
// length from device memory, and the launcher zeroes that length on the
// stream before the main kernel (the wrapper allocates the list,
// ftrl_update_scratch_ints).
//
// With E = 0 (no factor tables given) only the linear tables are updated,
// from gg2_lin: LR's whole update, and the huge-table path's separate
// linear step when no dead lane mirrors them.
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
// The z/A scatter of the huge-table in-place update: XLA lowered its two
// scatter-adds (ftrl_ffm_tpu/ftrl.py::dense_ftrl_update_inplace,
// z.at[ids].add(g) and zeros.at[ids].add(g2)) on the TPU.  The same sorted
// segments sum the split payload g, g2 [N, E] in ascending payload order
// and write z[id] += sum g (the row's sum added once; JAX adds each g into
// z in turn) and A[id] = sum g^2.  A must be zero on every row no id
// touches (the caller zeroes it each step); csrc/ftrl_pass.cu's closed-form
// pass follows.  Bytes bound it: the payload read once, z read and written
// and A written on the touched rows (at FFM's 1M x 640, 3.27 GB of payload
// and ~470k rows: 2.05 ms at 3.35 TB/s; at FM's 2^22 x 16, 82 MB and
// ~590k rows: 0.059 ms).  Its kernels mirror the update's:
//
// - za_scatter_rows (E > 32, E % 4 == 0, tables and payload 16-byte
//   aligned): ftrl_update_kernel's walk — a persistent grid, tiles of 32
//   sorted positions, starts from one ballot, ends from ballots capped at
//   kHotRows, 32 perm entries loaded at once and broadcast by shuffle, five
//   float4 quads of g and of g^2 a lane read streaming, z read and written
//   and A written as float4.
// - za_scatter_narrow (E <= 32, aligned): ftrl_update_narrow's groups, one
//   quad of g and one of g^2 a lane a row.
// - za_scatter_hot: the segments over kHotRows rows that either listed,
//   one block per (segment, 32-column slice), its warps copying the next
//   rows of the slice with cp.async into a ring of 64-row chunks while warp
//   0 sums the current one, one lane a column, in order: ftrl_update_hot's
//   design on the split payloads, with each perm entry loaded kPermAhead
//   chunks before its copy and as many blocks as fit on the card.
//   Zipf-skewed ids give segments of thousands of rows, which one warp
//   would walk row by row.
// - za_scatter_scalar (any other E or alignment): one warp per segment
//   start over all positions, columns in passes of 256 (the first design).
//
// All of them give the same bits.  The scatter keeps its own loops:
// sharing the segment loop with the update kernel of that time (now
// ftrl_update_scalar) through inline device functions slowed the update
// kernel from 2.67 to 4.54 ms at the bench shape (H100 80GB HBM3 at 700 W,
// both versions timed in one run).  Only the narrow forms share
// tile_segments, the listing of a tile's segments; the E = 640 kernels do
// not call it.

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

// Four adjacent payload values (a quad): a float4, or four bf16 in 8 bytes;
// loaded streaming (read once), and added into four sums in order.
__device__ __forceinline__ float4 load_quad(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 load_quad(const __nv_bfloat16* p) {
  return __ldcs(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ void add_quad(float* acc, float4 q) {
  acc[0] = accumulate(acc[0], q.x);
  acc[1] = accumulate(acc[1], q.y);
  acc[2] = accumulate(acc[2], q.z);
  acc[3] = accumulate(acc[3], q.w);
}
__device__ __forceinline__ void add_quad(float* acc, uint2 q) {
  const __nv_bfloat162 lo = reinterpret_cast<const __nv_bfloat162&>(q.x);
  const __nv_bfloat162 hi = reinterpret_cast<const __nv_bfloat162&>(q.y);
  acc[0] = accumulate(acc[0], lo.x);
  acc[1] = accumulate(acc[1], lo.y);
  acc[2] = accumulate(acc[2], hi.x);
  acc[3] = accumulate(acc[3], hi.y);
}

// Four adjacent w values widened to f32, and stored back rounded.
__device__ __forceinline__ void load_w4(const float* p, float* w) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  w[0] = q.x;
  w[1] = q.y;
  w[2] = q.z;
  w[3] = q.w;
}
__device__ __forceinline__ void load_w4(const __nv_bfloat16* p, float* w) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162&>(q.x));
  const float2 hi = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162&>(q.y));
  w[0] = lo.x;
  w[1] = lo.y;
  w[2] = hi.x;
  w[3] = hi.y;
}
__device__ __forceinline__ void store_w4(float* p, const float* w) {
  *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store_w4(__nv_bfloat16* p, const float* w) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(w[0], w[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(w[2], w[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(reinterpret_cast<const unsigned&>(lo),
                                            reinterpret_cast<const unsigned&>(hi));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
// one quad of the payload into shared memory (16 bytes f32, 8 bytes bf16)
__device__ __forceinline__ void cp_quad(float* dst, const float* src) { cp_async16(dst, src); }
__device__ __forceinline__ void cp_quad(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  cp_async8(dst, src);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kCols = 8;  // ftrl_update_scalar: columns per lane per pass over a segment
constexpr float kUntouchedN = 1e-16f;  // ftrl.py::UNTOUCHED_N
constexpr unsigned kFull = 0xffffffffu;
// ftrl_update_kernel: quads per lane, so a warp covers 640 columns a pass
constexpr int kQuadsPerLane = 5;
constexpr int kPassQuads = 32 * kQuadsPerLane;
// segments longer than this many payload rows go to ftrl_update_hot
constexpr int kHotRows = 64;
// ftrl_update_hot: rows a chunk, chunks in the ring, columns a slice
constexpr int kChunkRows = 64;
constexpr int kRing = 4;
constexpr int kSlice = 32;
constexpr int kMaxDevices = 64;
// rows at most this wide take the narrow forms (one quad a lane, several
// segments a warp): ftrl_update_narrow, za_scatter_narrow
constexpr int kNarrowCols = 32;
// the narrow forms' rows a group loads before it adds them
constexpr int kBatchRows = 4;
static_assert(kHotRows % 32 == 0 && kThreads == 4 * kChunkRows && kSlice == 32, "shapes");

struct Ftrl {
  float alpha, beta, l1, l2;
};

// Values between one payload row and the next: 2E in the combined layout
// (g || g^2 in one row), the caller's stride in the split one.
template <bool Split>
__device__ __forceinline__ size_t row_stride(int E, size_t stride) {
  return Split ? stride : 2 * static_cast<size_t>(E);
}

// One coordinate's accumulator step with the pre-step w, then the closed
// form where the coordinate has been touched (ftrl.py::_closed_step), on
// values.
__device__ __forceinline__ void ftrl_coord(float& n, float& z, float& w, float g, float g2,
                                           const Ftrl& p) {
  const float new_n = __fadd_rn(n, g2);
  const float sigma = __fdiv_rn(__fsub_rn(sqrtf(new_n), sqrtf(n)), p.alpha);
  const float new_z = __fsub_rn(__fadd_rn(z, g), __fmul_rn(sigma, w));
  if (new_n > kUntouchedN) {
    const float sl1 = new_z > 0.f ? p.l1 : -p.l1;
    const float den = __fadd_rn(p.l2, __fdiv_rn(__fadd_rn(p.beta, sqrtf(new_n)), p.alpha));
    w = fabsf(new_z) <= p.l1 ? 0.f : __fdiv_rn(-__fsub_rn(new_z, sl1), den);
  }
  n = new_n;
  z = new_z;
}

// The same on one coordinate of the tables, in place.
template <typename W>
__device__ __forceinline__ void ftrl_step(float* n_p, float* z_p, W* w_p, float g, float g2,
                                          const Ftrl& p) {
  float n = *n_p, z = *z_p, w = load(w_p);
  ftrl_coord(n, z, w, g, g2, p);
  *n_p = n;
  *z_p = z;
  store(w_p, w);
}

template <typename P, typename W, bool Split>
__global__ void __launch_bounds__(kThreads)
ftrl_update_scalar(const int* __restrict__ sids, const long long* __restrict__ perm, int N,
                   const P* __restrict__ gg2, const P* __restrict__ g2s, size_t stride,
                   const float* __restrict__ gg2_lin, float* vec_n, float* vec_z, W* vec_w,
                   float* lin_n, float* lin_z, float* lin_w, int R, int E, int lane, Ftrl p) {
  const int ln = threadIdx.x & 31;
  const int warps = gridDim.x * kWarpsPerBlock;
  const size_t w2 = row_stride<Split>(E, stride);
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
        const size_t at = static_cast<size_t>(perm[q]) * w2;
        const P* src = gg2 + at;
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int c = c0 + ln + 32 * u;
          if (c < E) {
            g[u] = accumulate(g[u], src[c]);
            g2[u] = accumulate(g2[u], Split ? g2s[at + c] : src[E + c]);
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

// The linear stats of the segment [s, end) from gg2_lin, in order, the same
// on every lane: the lanes load 32 pairs at once, then each sum takes them
// by shuffle, one add at a time (the sums of one lane's loop over the rows).
__device__ __forceinline__ void linear_sums(const long long* __restrict__ perm,
                                            const float* __restrict__ gg2_lin, int s, int end,
                                            int ln, float& g, float& g2) {
  g = 0.f;
  g2 = 0.f;
  for (int base = s; base < end; base += 32) {
    const int cnt = min(32, end - base);
    float a = 0.f, b = 0.f;
    if (ln < cnt) {
      const float* src = gg2_lin + 2 * static_cast<size_t>(perm[base + ln]);
      a = src[0];
      b = src[1];
    }
    for (int r = 0; r < cnt; ++r) {
      g += __shfl_sync(kFull, a, r);
      g2 += __shfl_sync(kFull, b, r);
    }
  }
}

// Blocks of ftrl_update_kernel an SM holds: its registers capped so that two
// (f32 payload) or three (bf16) fit.  Measured at the bench shape (H100
// 80GB HBM3, 700 W): f32 1.83 ms at two, 2.21-2.34 at one or three; bf16
// 1.43 at three, 1.94-2.92 at one or two.
template <typename P>
__host__ __device__ constexpr int update_blocks_per_sm() {
  return sizeof(P) == 4 ? 2 : 3;
}

template <typename P, typename W, bool Split>
__global__ void __launch_bounds__(kThreads, update_blocks_per_sm<P>())
ftrl_update_kernel(const int* __restrict__ sids, const long long* __restrict__ perm, int N,
                   const P* __restrict__ gg2, const P* __restrict__ g2s, size_t stride,
                   const float* __restrict__ gg2_lin, float* vec_n, float* vec_z, W* vec_w,
                   float* lin_n, float* lin_z, float* lin_w, int R, int E, int lane, Ftrl p,
                   int* __restrict__ hot) {
  const int ln = threadIdx.x & 31;
  const int quads = E / 4;
  const size_t w2 = row_stride<Split>(E, stride);
  // a persistent grid: each warp walks tiles of 32 sorted positions
  const int tiles = gridDim.x * kWarpsPerBlock * 32;
  for (int tile0 = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * 32; tile0 < N;
       tile0 += tiles) {
    // the segment starts among this tile's 32 sorted positions
    const int j = tile0 + ln;
    const int id = j < N ? sids[j] : -1;
    int prev = __shfl_up_sync(kFull, id, 1);
    if (ln == 0 && j > 0) prev = sids[j - 1];
    unsigned starts = __ballot_sync(kFull, j < N && id >= 0 && id < R && (j == 0 || prev != id));
    while (starts) {
      const int first = __ffs(starts) - 1;
      starts &= starts - 1;
      const int s = tile0 + first;
      const int sid = __shfl_sync(kFull, id, first);
      // the segment's end: the first later position with another id (or N)
      int end = -1;
      for (int c = 0; c < kHotRows / 32 && end < 0; ++c) {
        const int q = s + 1 + 32 * c + ln;
        const unsigned other = __ballot_sync(kFull, q >= N || sids[q] != sid);
        if (other) end = s + 32 * c + __ffs(other);
      }
      if (end < 0) {  // more than kHotRows payload rows: ftrl_update_hot's
        if (ln == 0) hot[1 + atomicAdd(hot, 1)] = s;
        continue;
      }
      const size_t row = static_cast<size_t>(sid) * E;
      for (int q0 = 0; q0 < quads; q0 += kPassQuads) {
        float g[4 * kQuadsPerLane], g2[4 * kQuadsPerLane];
#pragma unroll
        for (int u = 0; u < 4 * kQuadsPerLane; ++u) g[u] = g2[u] = 0.f;
        for (int base = s; base < end; base += 32) {
          const int cnt = min(32, end - base);
          const long long mine = ln < cnt ? perm[base + ln] : 0;
          for (int r = 0; r < cnt; ++r) {
            const size_t at = static_cast<size_t>(__shfl_sync(kFull, mine, r)) * w2;
            const P* src = gg2 + at;
            const P* sq = Split ? g2s + at : src + E;
#pragma unroll
            for (int u = 0; u < kQuadsPerLane; ++u) {
              const int qd = q0 + ln + 32 * u;
              if (qd < quads) {
                add_quad(g + 4 * u, load_quad(src + 4 * qd));
                add_quad(g2 + 4 * u, load_quad(sq + 4 * qd));
              }
            }
          }
        }
        // the closed form on the row's quads: float4 n and z, 16 or 8 bytes of w
#pragma unroll
        for (int u = 0; u < kQuadsPerLane; ++u) {
          const int qd = q0 + ln + 32 * u;
          if (qd >= quads) continue;
          const size_t at = row + 4 * static_cast<size_t>(qd);
          float4 n4 = *reinterpret_cast<const float4*>(vec_n + at);
          float4 z4 = *reinterpret_cast<const float4*>(vec_z + at);
          float w[4];
          load_w4(vec_w + at, w);
          ftrl_coord(n4.x, z4.x, w[0], g[4 * u], g2[4 * u], p);
          ftrl_coord(n4.y, z4.y, w[1], g[4 * u + 1], g2[4 * u + 1], p);
          ftrl_coord(n4.z, z4.z, w[2], g[4 * u + 2], g2[4 * u + 2], p);
          ftrl_coord(n4.w, z4.w, w[3], g[4 * u + 3], g2[4 * u + 3], p);
          *reinterpret_cast<float4*>(vec_n + at) = n4;
          *reinterpret_cast<float4*>(vec_z + at) = z4;
          store_w4(vec_w + at, w);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (4 * qd + c == lane) {
              ftrl_step(lin_n + sid, lin_z + sid, lin_w + sid, g[4 * u + c], g2[4 * u + c], p);
            }
          }
        }
      }
      if (lane < 0) {
        float g, g2;
        linear_sums(perm, gg2_lin, s, end, ln, g, g2);
        if (ln == 0) ftrl_step(lin_n + sid, lin_z + sid, lin_w + sid, g, g2, p);
      }
    }
  }
}

// Dynamic shared memory of ftrl_update_hot: the ring of payload slices
// [kRing][kChunkRows][g slice | g^2 slice], then the gg2_lin pairs
// [kRing][kChunkRows][2].
constexpr size_t kRingElems = static_cast<size_t>(kRing) * kChunkRows * 2 * kSlice;
template <typename P>
constexpr size_t hot_bytes() {
  return kRingElems * sizeof(P) + static_cast<size_t>(kRing) * kChunkRows * 2 * 4;
}

template <typename P, typename W, bool Split>
__global__ void __launch_bounds__(kThreads)
ftrl_update_hot(const int* __restrict__ sids, const long long* __restrict__ perm, int N,
                const P* __restrict__ gg2, const P* __restrict__ g2s, size_t stride,
                const float* __restrict__ gg2_lin, float* vec_n, float* vec_z, W* vec_w,
                float* lin_n, float* lin_z, float* lin_w, int E, int lane, Ftrl p,
                const int* __restrict__ hot) {
  extern __shared__ float smem[];
  __shared__ int seg_end;
  P* ring = reinterpret_cast<P*>(smem);
  float* lring = reinterpret_cast<float*>(ring + kRingElems);
  const int count = hot[0];
  const int slices = E > 0 ? (E + kSlice - 1) / kSlice : 1;
  const int ln = threadIdx.x & 31;
  const int pr = threadIdx.x >> 2;   // the chunk row this thread copies
  const int part = threadIdx.x & 3;  // its quads: g 0-3, g 4-7, g^2 0-3, g^2 4-7
  const size_t w2 = row_stride<Split>(E, stride);
  for (int unit = blockIdx.x; unit < count * slices; unit += gridDim.x) {
    const int seg = unit / slices;
    const int slice = unit - seg * slices;
    const int s = hot[1 + seg];
    const int sid = sids[s];
    if (threadIdx.x < 32) {
      // the segment's end by a 32-way search: sids[lo] == sid, and hi == N
      // or sids[hi] != sid
      int lo = s, hi = N;
      while (hi - lo > 1) {
        const int step = (hi - lo + 31) / 32;
        const int q = lo + (ln + 1) * step;
        const int k = __popc(__ballot_sync(kFull, q < hi && sids[q] == sid));
        hi = min(hi, lo + (k + 1) * step);
        lo += k * step;
      }
      if (ln == 0) seg_end = hi;
    }
    __syncthreads();
    const int end = seg_end;
    const int col0 = slice * kSlice;
    const bool lin_here = lane < 0 && slice == 0;
    const int chunks = (end - s + kChunkRows - 1) / kChunkRows;
    // the payload row this thread copies in chunk ci (-1: none)
    auto row_of = [&](int ci) -> long long {
      const int q = s + ci * kChunkRows + pr;
      return ci < chunks && q < end ? perm[q] : -1;
    };
    // start the copies of chunk ci from payload row `row` (one commit group,
    // empty past the end)
    auto start_copies = [&](int ci, long long row) {
      if (row >= 0) {
        const size_t src = static_cast<size_t>(row);
        const int at = (ci % kRing) * kChunkRows + pr;
        if (E > 0) {
          const P* from = Split ? (part >= 2 ? g2s : gg2) + src * w2 + col0
                                : gg2 + src * w2 + (part >= 2 ? E : 0) + col0;
          P* to = ring + at * 2 * kSlice + (part >= 2 ? kSlice : 0);
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int c4 = 4 * ((part & 1) * 4 + h);
            if (col0 + c4 < E) cp_quad(to + c4, from + c4);
          }
        }
        if (lin_here && part == 0) cp_async8(lring + 2 * at, gg2_lin + 2 * src);
      }
      cp_async_commit();
    };
    for (int ci = 0; ci < kRing - 1; ++ci) start_copies(ci, row_of(ci));
    // each perm entry is loaded one chunk before its copy starts, so its
    // latency hides behind the barriers and the sums
    long long next = row_of(kRing - 1);
    float g = 0.f, g2 = 0.f;
    for (int ci = 0; ci < chunks; ++ci) {
      start_copies(ci + kRing - 1, next);
      next = row_of(ci + kRing);
      cp_async_wait<kRing - 1>();
      __syncthreads();
      const int rows = min(kChunkRows, end - s - ci * kChunkRows);
      const int slot = (ci % kRing) * kChunkRows;
      if (threadIdx.x < 32) {
        if (col0 + ln < E) {
          const P* col = ring + slot * 2 * kSlice + ln;
#pragma unroll 8
          for (int r = 0; r < rows; ++r) {
            g = accumulate(g, col[r * 2 * kSlice]);
            g2 = accumulate(g2, col[r * 2 * kSlice + kSlice]);
          }
        }
      } else if (threadIdx.x == 32 && lin_here) {
        const float* pairs = lring + 2 * slot;
        for (int r = 0; r < rows; ++r) {
          g += pairs[2 * r];
          g2 += pairs[2 * r + 1];
        }
      }
      __syncthreads();
    }
    const int c = col0 + ln;
    if (threadIdx.x < 32 && c < E) {
      const size_t row = static_cast<size_t>(sid) * E;
      ftrl_step(vec_n + row + c, vec_z + row + c, vec_w + row + c, g, g2, p);
      if (c == lane) ftrl_step(lin_n + sid, lin_z + sid, lin_w + sid, g, g2, p);
    } else if (threadIdx.x == 32 && lin_here) {
      ftrl_step(lin_n + sid, lin_z + sid, lin_w + sid, g, g2, p);
    }
  }
}

// The segments that start in one tile of 32 sorted positions and are at
// most kHotRows rows long, listed in a warp's shared memory for the narrow
// forms: start, end and id, and the tile's perm entries.
struct TileSegs {
  int s[32], end[32], id[32];
  long long perm[32];
};

// Lists the valid segments that start in the tile at tile0 into t (the
// whole warp, converged) and returns their count; a segment longer than
// kHotRows goes to the hot list instead.  Each segment ends at the next
// position in the tile where the id changes (an invalid id or the end of
// the ids ends it too); only the tile's last segment can run past the
// tile, and the warp finds its end by ballots over the next positions, up
// to kHotRows past its start.
__device__ __forceinline__ int tile_segments(const int* __restrict__ sids,
                                             const long long* __restrict__ perm, int N, int R,
                                             int tile0, int ln, TileSegs& t,
                                             int* __restrict__ hot) {
  const int j = tile0 + ln;
  const int id = j < N ? sids[j] : -1;
  int prev = __shfl_up_sync(kFull, id, 1);
  if (ln == 0 && j > 0 && j < N) prev = sids[j - 1];
  const bool head = j < N && (j == 0 || prev != id);
  const bool start = head && id >= 0 && id < R;
  // where a segment begins, or the ids end
  const unsigned bounds = __ballot_sync(kFull, head || j >= N);
  t.perm[ln] = j < N ? perm[j] : 0;
  const unsigned above = ln == 31 ? 0u : bounds & (~0u << (ln + 1));
  int end = above ? tile0 + __ffs(above) - 1 : -1;
  const unsigned open = __ballot_sync(kFull, start && end < 0);
  if (open) {  // the tile's last segment runs to its end
    const int first = __ffs(open) - 1;
    const int s = tile0 + first;
    const int sid = __shfl_sync(kFull, id, first);
    int e = -1;
    for (int q0 = tile0 + 32; e < 0 && q0 <= s + kHotRows; q0 += 32) {
      const int q = q0 + ln;
      const unsigned other = __ballot_sync(kFull, q >= N || sids[q] != sid);
      if (other) e = q0 + __ffs(other) - 1;
    }
    if (ln == first) end = e;  // -1: more than kHotRows rows
  }
  const bool long_seg = start && (end < 0 || end - j > kHotRows);
  if (long_seg) hot[1 + atomicAdd(hot, 1)] = j;
  const bool keep = start && !long_seg;
  const unsigned kept = __ballot_sync(kFull, keep);
  if (keep) {
    const int k = __popc(kept & ((1u << ln) - 1));
    t.s[k] = j;
    t.end[k] = end;
    t.id[k] = id;
  }
  __syncwarp();
  return __popc(kept);
}

// The update for rows of E <= kNarrowCols columns (E % 4 == 0, aligned as
// ftrl_update_kernel needs; E = 0: the linear tables alone): groups of GS
// lanes, one segment a group, one quad a lane.
template <typename P, typename W, int GS, bool Split>
__global__ void __launch_bounds__(kThreads)
ftrl_update_narrow(const int* __restrict__ sids, const long long* __restrict__ perm, int N,
                   const P* __restrict__ gg2, const P* __restrict__ g2s, size_t stride,
                   const float* __restrict__ gg2_lin, float* vec_n, float* vec_z, W* vec_w,
                   float* lin_n, float* lin_z, float* lin_w, int R, int E, int lane, Ftrl p,
                   int* __restrict__ hot) {
  __shared__ TileSegs segs[kWarpsPerBlock];
  TileSegs& t = segs[threadIdx.x >> 5];
  const int ln = threadIdx.x & 31;
  const int qd = ln % GS;         // this lane's quad of the row
  const bool cols = qd < E / 4;   // none at E = 0
  const bool lin_sums = lane < 0 && qd == 0;
  const size_t w2 = row_stride<Split>(E, stride);
  const int tiles = gridDim.x * kWarpsPerBlock * 32;
  for (int tile0 = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * 32; tile0 < N;
       tile0 += tiles) {
    const int m = tile_segments(sids, perm, N, R, tile0, ln, t, hot);
    for (int k = ln / GS; k < m; k += 32 / GS) {
      const int s = t.s[k], end = t.end[k], sid = t.id[k];
      const size_t at = static_cast<size_t>(sid) * E + 4 * qd;
      float4 n4, z4;
      float w[4];
      if (cols) {  // the row's quad, loaded before the sums
        n4 = *reinterpret_cast<const float4*>(vec_n + at);
        z4 = *reinterpret_cast<const float4*>(vec_z + at);
        load_w4(vec_w + at, w);
      }
      float g[4] = {0.f, 0.f, 0.f, 0.f}, g2[4] = {0.f, 0.f, 0.f, 0.f};
      float lg = 0.f, lg2 = 0.f;
      auto row_at = [&](int q) { return q < tile0 + 32 ? t.perm[q - tile0] : perm[q]; };
      int q = s;
      // kBatchRows rows at a time: their loads in flight together, then
      // the adds in the rows' order
      for (; q + kBatchRows <= end; q += kBatchRows) {
        long long rows[kBatchRows];
#pragma unroll
        for (int u = 0; u < kBatchRows; ++u) rows[u] = row_at(q + u);
        if (cols) {
          decltype(load_quad(gg2)) x[kBatchRows], x2[kBatchRows];
#pragma unroll
          for (int u = 0; u < kBatchRows; ++u) {
            const size_t at = static_cast<size_t>(rows[u]) * w2;
            const P* src = gg2 + at + 4 * qd;
            x[u] = load_quad(src);
            x2[u] = load_quad(Split ? g2s + at + 4 * qd : src + E);
          }
#pragma unroll
          for (int u = 0; u < kBatchRows; ++u) {
            add_quad(g, x[u]);
            add_quad(g2, x2[u]);
          }
        }
        if (lin_sums) {
          float2 pr[kBatchRows];
#pragma unroll
          for (int u = 0; u < kBatchRows; ++u) {
            pr[u] = __ldcs(reinterpret_cast<const float2*>(gg2_lin) + rows[u]);
          }
#pragma unroll
          for (int u = 0; u < kBatchRows; ++u) {
            lg += pr[u].x;
            lg2 += pr[u].y;
          }
        }
      }
      for (; q < end; ++q) {
        const long long row = row_at(q);
        if (cols) {
          const size_t at = static_cast<size_t>(row) * w2;
          const P* src = gg2 + at + 4 * qd;
          add_quad(g, load_quad(src));
          add_quad(g2, load_quad(Split ? g2s + at + 4 * qd : src + E));
        }
        if (lin_sums) {
          const float2 pr = __ldcs(reinterpret_cast<const float2*>(gg2_lin) + row);
          lg += pr.x;
          lg2 += pr.y;
        }
      }
      if (cols) {
        ftrl_coord(n4.x, z4.x, w[0], g[0], g2[0], p);
        ftrl_coord(n4.y, z4.y, w[1], g[1], g2[1], p);
        ftrl_coord(n4.z, z4.z, w[2], g[2], g2[2], p);
        ftrl_coord(n4.w, z4.w, w[3], g[3], g2[3], p);
        *reinterpret_cast<float4*>(vec_n + at) = n4;
        *reinterpret_cast<float4*>(vec_z + at) = z4;
        store_w4(vec_w + at, w);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (4 * qd + c == lane) ftrl_step(lin_n + sid, lin_z + sid, lin_w + sid, g[c], g2[c], p);
        }
      }
      if (lin_sums) ftrl_step(lin_n + sid, lin_z + sid, lin_w + sid, lg, lg2, p);
    }
    __syncwarp();  // the groups are done with t before the next tile's list
  }
}

// One float4 quad of the split payload added into four sums, in order.
__device__ __forceinline__ void add4(float* acc, float4 q) {
  acc[0] += q.x;
  acc[1] += q.y;
  acc[2] += q.z;
  acc[3] += q.w;
}

// z[id] += the sums' quad, added once each (z4 as loaded), and A[id] = the
// g^2 sums' quad.
__device__ __forceinline__ void store_za(float* z, float* a, size_t at, float4 z4,
                                         const float* sg, const float* sg2) {
  z4.x = __fadd_rn(z4.x, sg[0]);
  z4.y = __fadd_rn(z4.y, sg[1]);
  z4.z = __fadd_rn(z4.z, sg[2]);
  z4.w = __fadd_rn(z4.w, sg[3]);
  *reinterpret_cast<float4*>(z + at) = z4;
  *reinterpret_cast<float4*>(a + at) = make_float4(sg2[0], sg2[1], sg2[2], sg2[3]);
}

__global__ void __launch_bounds__(kThreads)
za_scatter_rows(const int* __restrict__ sids, const long long* __restrict__ perm, int N,
                const float* __restrict__ g, const float* __restrict__ g2, float* __restrict__ z,
                float* __restrict__ a, int R, int E, int* __restrict__ hot) {
  const int ln = threadIdx.x & 31;
  const int quads = E / 4;
  const int stride = gridDim.x * kWarpsPerBlock * 32;
  for (int tile0 = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * 32; tile0 < N;
       tile0 += stride) {
    const int j = tile0 + ln;
    const int id = j < N ? sids[j] : -1;
    int prev = __shfl_up_sync(kFull, id, 1);
    if (ln == 0 && j > 0) prev = sids[j - 1];
    unsigned starts = __ballot_sync(kFull, j < N && id >= 0 && id < R && (j == 0 || prev != id));
    while (starts) {
      const int first = __ffs(starts) - 1;
      starts &= starts - 1;
      const int s = tile0 + first;
      const int sid = __shfl_sync(kFull, id, first);
      int end = -1;
      for (int c = 0; c < kHotRows / 32 && end < 0; ++c) {
        const int q = s + 1 + 32 * c + ln;
        const unsigned other = __ballot_sync(kFull, q >= N || sids[q] != sid);
        if (other) end = s + 32 * c + __ffs(other);
      }
      if (end < 0) {  // more than kHotRows payload rows: za_scatter_hot's
        if (ln == 0) hot[1 + atomicAdd(hot, 1)] = s;
        continue;
      }
      const size_t row = static_cast<size_t>(sid) * E;
      for (int q0 = 0; q0 < quads; q0 += kPassQuads) {
        float sg[4 * kQuadsPerLane], sg2[4 * kQuadsPerLane];
#pragma unroll
        for (int u = 0; u < 4 * kQuadsPerLane; ++u) sg[u] = sg2[u] = 0.f;
        for (int base = s; base < end; base += 32) {
          const int cnt = min(32, end - base);
          const long long mine = ln < cnt ? perm[base + ln] : 0;
          for (int r = 0; r < cnt; ++r) {
            const size_t src = static_cast<size_t>(__shfl_sync(kFull, mine, r)) * E;
#pragma unroll
            for (int u = 0; u < kQuadsPerLane; ++u) {
              const int qd = q0 + ln + 32 * u;
              if (qd < quads) {
                add4(sg + 4 * u, __ldcs(reinterpret_cast<const float4*>(g + src) + qd));
                add4(sg2 + 4 * u, __ldcs(reinterpret_cast<const float4*>(g2 + src) + qd));
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kQuadsPerLane; ++u) {
          const int qd = q0 + ln + 32 * u;
          if (qd >= quads) continue;
          const size_t at = row + 4 * static_cast<size_t>(qd);
          store_za(z, a, at, *reinterpret_cast<const float4*>(z + at), sg + 4 * u, sg2 + 4 * u);
        }
      }
    }
  }
}

template <int GS>
__global__ void __launch_bounds__(kThreads)
za_scatter_narrow(const int* __restrict__ sids, const long long* __restrict__ perm, int N,
                  const float* __restrict__ g, const float* __restrict__ g2,
                  float* __restrict__ z, float* __restrict__ a, int R, int E,
                  int* __restrict__ hot) {
  __shared__ TileSegs segs[kWarpsPerBlock];
  TileSegs& t = segs[threadIdx.x >> 5];
  const int ln = threadIdx.x & 31;
  const int qd = ln % GS;  // this lane's quad of the row
  const bool cols = qd < E / 4;
  const int stride = gridDim.x * kWarpsPerBlock * 32;
  for (int tile0 = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * 32; tile0 < N;
       tile0 += stride) {
    const int m = tile_segments(sids, perm, N, R, tile0, ln, t, hot);
    for (int k = ln / GS; cols && k < m; k += 32 / GS) {
      const int s = t.s[k], end = t.end[k];
      const size_t at = static_cast<size_t>(t.id[k]) * E + 4 * qd;
      const float4 z4 = *reinterpret_cast<const float4*>(z + at);
      float sg[4] = {0.f, 0.f, 0.f, 0.f}, sg2[4] = {0.f, 0.f, 0.f, 0.f};
      auto quad_at = [&](const float* x, int q) {
        const long long row = q < tile0 + 32 ? t.perm[q - tile0] : perm[q];
        return __ldcs(reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * E) + qd);
      };
      int q = s;
      // kBatchRows rows at a time: their loads in flight together, then
      // the adds in the rows' order
      for (; q + kBatchRows <= end; q += kBatchRows) {
        float4 x[kBatchRows], x2[kBatchRows];
#pragma unroll
        for (int u = 0; u < kBatchRows; ++u) {
          x[u] = quad_at(g, q + u);
          x2[u] = quad_at(g2, q + u);
        }
#pragma unroll
        for (int u = 0; u < kBatchRows; ++u) {
          add4(sg, x[u]);
          add4(sg2, x2[u]);
        }
      }
      for (; q < end; ++q) {
        add4(sg, quad_at(g, q));
        add4(sg2, quad_at(g2, q));
      }
      store_za(z, a, at, z4, sg, sg2);
    }
    __syncwarp();  // the groups are done with t before the next tile's list
  }
}

// Dynamic shared memory of za_scatter_hot: the ring of payload slices
// [kRing][kChunkRows][g slice | g^2 slice].
constexpr size_t kScatterHotBytes = kRingElems * sizeof(float);
// za_scatter_hot: chunks ahead of its copy that a perm entry is loaded
constexpr int kPermAhead = 3;

__global__ void __launch_bounds__(kThreads)
za_scatter_hot(const int* __restrict__ sids, const long long* __restrict__ perm, int N,
               const float* __restrict__ g, const float* __restrict__ g2, float* __restrict__ z,
               float* __restrict__ a, int E, const int* __restrict__ hot) {
  extern __shared__ float ring[];
  __shared__ int seg_end;
  const int count = hot[0];
  const int slices = (E + kSlice - 1) / kSlice;
  const int ln = threadIdx.x & 31;
  const int pr = threadIdx.x >> 2;   // the chunk row this thread copies
  const int part = threadIdx.x & 3;  // its quads: g 0-3, g 4-7, g^2 0-3, g^2 4-7
  for (int unit = blockIdx.x; unit < count * slices; unit += gridDim.x) {
    const int seg = unit / slices;
    const int slice = unit - seg * slices;
    const int s = hot[1 + seg];
    const int sid = sids[s];
    if (threadIdx.x < 32) {
      // the segment's end by a 32-way search: sids[lo] == sid, and hi == N
      // or sids[hi] != sid
      int lo = s, hi = N;
      while (hi - lo > 1) {
        const int step = (hi - lo + 31) / 32;
        const int q = lo + (ln + 1) * step;
        const int k = __popc(__ballot_sync(kFull, q < hi && sids[q] == sid));
        hi = min(hi, lo + (k + 1) * step);
        lo += k * step;
      }
      if (ln == 0) seg_end = hi;
    }
    __syncthreads();
    const int end = seg_end;
    const int col0 = slice * kSlice;
    const int chunks = (end - s + kChunkRows - 1) / kChunkRows;
    // the payload row this thread copies in chunk ci (-1: none)
    auto row_of = [&](int ci) -> long long {
      const int q = s + ci * kChunkRows + pr;
      return ci < chunks && q < end ? perm[q] : -1;
    };
    // start the copies of chunk ci from payload row `row` (one commit group,
    // empty past the end)
    auto start_copies = [&](int ci, long long row) {
      if (row >= 0) {
        const float* from = (part >= 2 ? g2 : g) + static_cast<size_t>(row) * E + col0;
        float* to = ring + ((ci % kRing) * kChunkRows + pr) * 2 * kSlice + (part >= 2 ? kSlice : 0);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int c4 = 4 * ((part & 1) * 4 + h);
          if (col0 + c4 < E) cp_async16(to + c4, from + c4);
        }
      }
      cp_async_commit();
    };
    for (int ci = 0; ci < kRing - 1; ++ci) start_copies(ci, row_of(ci));
    // each perm entry is loaded kPermAhead chunks before its copy starts:
    // one chunk's sums take less time than a load from memory
    long long next[kPermAhead];
#pragma unroll
    for (int u = 0; u < kPermAhead; ++u) next[u] = row_of(kRing - 1 + u);
    float sg = 0.f, sg2 = 0.f;
    for (int ci = 0; ci < chunks; ++ci) {
      start_copies(ci + kRing - 1, next[0]);
#pragma unroll
      for (int u = 0; u + 1 < kPermAhead; ++u) next[u] = next[u + 1];
      next[kPermAhead - 1] = row_of(ci + kRing - 1 + kPermAhead);
      cp_async_wait<kRing - 1>();
      __syncthreads();
      if (threadIdx.x < 32 && col0 + ln < E) {
        const int rows = min(kChunkRows, end - s - ci * kChunkRows);
        const float* col = ring + (ci % kRing) * kChunkRows * 2 * kSlice + ln;
#pragma unroll 8
        for (int r = 0; r < rows; ++r) {
          sg += col[r * 2 * kSlice];
          sg2 += col[r * 2 * kSlice + kSlice];
        }
      }
      __syncthreads();
    }
    const int c = col0 + ln;
    if (threadIdx.x < 32 && c < E) {
      const size_t at = static_cast<size_t>(sid) * E + c;
      z[at] = __fadd_rn(z[at], sg);
      a[at] = sg2;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
za_scatter_scalar(const int* __restrict__ sids, const long long* __restrict__ perm, int N,
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

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The current device and its SM count, read from the runtime once per device.
cudaError_t device_sms(int* dev, int* sms) {
  static int cache[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[*dev] == 0) {
    err = cudaDeviceGetAttribute(&cache[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cache[*dev];
  return cudaSuccess;
}

// The persistent grid of `kernel` over the tiles of N sorted positions: as
// many blocks as fit on the card (per_sm[dev], the occupancy API's count,
// read once per device into the caller's cache), or fewer when the tiles
// run out.
template <typename K>
cudaError_t persistent_grid(K kernel, int N, int* per_sm, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm[dev] == 0) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    per_sm[dev] = blocks > 0 ? blocks : 1;
  }
  const int tiles = (N + 31) / 32;
  const int needed = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  *grid = needed < per_sm[dev] * sms ? needed : per_sm[dev] * sms;
  return cudaSuccess;
}

// The kernel instances the launchers report, as ops/ftrl_cuda.py names them.
enum UpdateInstance { kUpdateRows = 0, kUpdateNarrow = 1, kUpdateLinear = 2, kUpdateScalar = 3 };
enum ScatterInstance { kScatterRows = 0, kScatterNarrow = 1, kScatterScalar = 2 };

// ftrl_update_narrow for groups of GS lanes.
template <typename P, typename W, int GS, bool Split>
cudaError_t launch_narrow(const int* sids, const long long* perm, int N, const P* pay,
                          const P* g2s, size_t stride, const float* gg2_lin, float* vec_n,
                          float* vec_z, W* w, float* lin_n, float* lin_z, float* lin_w, int R,
                          int E, int lane, Ftrl p, int* hot, cudaStream_t stream) {
  static int per_sm[kMaxDevices] = {};
  int grid = 0;
  const cudaError_t err =
      persistent_grid(ftrl_update_narrow<P, W, GS, Split>, N, per_sm, &grid);
  if (err != cudaSuccess) return err;
  ftrl_update_narrow<P, W, GS, Split><<<grid, kThreads, 0, stream>>>(
      sids, perm, N, pay, g2s, stride, gg2_lin, vec_n, vec_z, w, lin_n, lin_z, lin_w, R, E, lane,
      p, hot);
  return cudaGetLastError();
}

// The update's launches for one payload layout (Split: g at gg2 and g^2 at
// g2s, rows `stride` values apart; else the combined rows of 2E at gg2).
template <typename P, typename W, bool Split>
int launch_update(const int* sids, const long long* perm, int N, const void* gg2,
                  const void* g2, size_t stride, const float* gg2_lin, float* vec_n,
                  float* vec_z, void* vec_w, float* lin_n, float* lin_z, float* lin_w, int R,
                  int E, int lane, Ftrl p, int* hot, int* instance, cudaStream_t stream) {
  const P* pay = static_cast<const P*>(gg2);
  const P* g2s = static_cast<const P*>(g2);
  W* w = static_cast<W*>(vec_w);
  // quads need 4-column groups at 16-byte (f32) or 8-byte (bf16) addresses
  const bool quads = E % 4 == 0 && aligned(pay, 4 * sizeof(P)) && aligned(vec_n, 16) &&
                     aligned(vec_z, 16) && aligned(w, 4 * sizeof(W)) && aligned(gg2_lin, 8) &&
                     (!Split || (stride % 4 == 0 && aligned(g2s, 4 * sizeof(P))));
  if (!quads) {
    *instance = kUpdateScalar;
    ftrl_update_scalar<P, W, Split><<<segment_blocks(N), kThreads, 0, stream>>>(
        sids, perm, N, pay, g2s, stride, gg2_lin, vec_n, vec_z, w, lin_n, lin_z, lin_w, R, E,
        lane, p);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, sms = 0;
  cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // once per device: the hot kernel's shared memory allowance (above the
  // 48 KB default for f32)
  static bool hot_ready[kMaxDevices] = {};
  constexpr size_t bytes = hot_bytes<P>();
  if (!hot_ready[dev]) {
    err = cudaFuncSetAttribute(&ftrl_update_hot<P, W, Split>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    hot_ready[dev] = true;
  }
  err = cudaMemsetAsync(hot, 0, sizeof(int), stream);  // the hot list's length
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E <= kNarrowCols) {
    // one quad a lane: groups of 1, 2, 4 or 8 lanes (E = 0: 1)
    *instance = E == 0 ? kUpdateLinear : kUpdateNarrow;
    const int q = E / 4;
    err = q <= 1 ? launch_narrow<P, W, 1, Split>(sids, perm, N, pay, g2s, stride, gg2_lin, vec_n,
                                                 vec_z, w, lin_n, lin_z, lin_w, R, E, lane, p,
                                                 hot, stream)
        : q <= 2 ? launch_narrow<P, W, 2, Split>(sids, perm, N, pay, g2s, stride, gg2_lin, vec_n,
                                                 vec_z, w, lin_n, lin_z, lin_w, R, E, lane, p,
                                                 hot, stream)
        : q <= 4 ? launch_narrow<P, W, 4, Split>(sids, perm, N, pay, g2s, stride, gg2_lin, vec_n,
                                                 vec_z, w, lin_n, lin_z, lin_w, R, E, lane, p,
                                                 hot, stream)
                 : launch_narrow<P, W, 8, Split>(sids, perm, N, pay, g2s, stride, gg2_lin, vec_n,
                                                 vec_z, w, lin_n, lin_z, lin_w, R, E, lane, p,
                                                 hot, stream);
  } else {
    // once per device: the main kernel's blocks per SM (its persistent
    // grid fills the card once)
    *instance = kUpdateRows;
    static int per_sm[kMaxDevices] = {};
    if (per_sm[dev] == 0) {
      int blocks = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ftrl_update_kernel<P, W, Split>, kThreads, 0);
      if (err != cudaSuccess) return static_cast<int>(err);
      per_sm[dev] = blocks > 0 ? blocks : 1;
    }
    const int tiles = (N + 31) / 32;
    const int needed = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const int grid = needed < per_sm[dev] * sms ? needed : per_sm[dev] * sms;
    ftrl_update_kernel<P, W, Split><<<grid, kThreads, 0, stream>>>(
        sids, perm, N, pay, g2s, stride, gg2_lin, vec_n, vec_z, w, lin_n, lin_z, lin_w, R, E,
        lane, p, hot);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  ftrl_update_hot<P, W, Split><<<2 * sms, kThreads, bytes, stream>>>(
      sids, perm, N, pay, g2s, stride, gg2_lin, vec_n, vec_z, w, lin_n, lin_z, lin_w, E, lane, p,
      hot);
  return static_cast<int>(cudaGetLastError());
}

// za_scatter_narrow for groups of GS lanes.
template <int GS>
cudaError_t launch_scatter_narrow(const int* sids, const long long* perm, int N, const float* g,
                                  const float* g2, float* z, float* a, int R, int E, int* hot,
                                  cudaStream_t stream) {
  static int per_sm[kMaxDevices] = {};
  int grid = 0;
  const cudaError_t err = persistent_grid(za_scatter_narrow<GS>, N, per_sm, &grid);
  if (err != cudaSuccess) return err;
  za_scatter_narrow<GS><<<grid, kThreads, 0, stream>>>(sids, perm, N, g, g2, z, a, R, E, hot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ints of the scratch ftrl_update_launch and za_scatter_launch take for N
// payload rows: a count and the starts of at most N / (kHotRows + 1) long
// segments.
int ftrl_update_scratch_ints(int N) { return 1 + N / (kHotRows + 1); }

// Payload rows above which a segment is summed by columns (ftrl_update_hot,
// za_scatter_hot).
int ftrl_update_hot_rows() { return kHotRows; }

// Launch on `stream`: sids [N] int32 sorted stably, perm [N] int64, the
// payload, gg2_lin [N, 2] f32 (read only when lane < 0), vec tables [R, E]
// (unused when E = 0; vec_w f32, or bf16 when w_bf16) and lin tables [R]
// updated in place, hot [ftrl_update_scratch_ints(N)] int32 scratch, all
// contiguous on the current device.  The payload: with split = 0, gg2
// [N, 2E] (f32, or bf16 when payload_bf16; g2 and stride unused); with
// split = 1, g at gg2 and g^2 at g2, f32, each row `stride` values after the
// last (a multiple of 4 for the quad kernels).  Writes the instance it runs
// to *instance (an UpdateInstance).  Returns the CUDA error of the launches
// (0 on success).
int ftrl_update_launch(const int* sids, const long long* perm, int N, const void* gg2,
                       const void* g2, long long stride, int split, const float* gg2_lin,
                       float* vec_n, float* vec_z, void* vec_w, float* lin_n, float* lin_z,
                       float* lin_w, int R, int E, int lane, int payload_bf16, int w_bf16,
                       float alpha, float beta, float l1, float l2, int* hot, int* instance,
                       void* stream) {
  if (N == 0) return 0;
  const Ftrl p{alpha, beta, l1, l2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (split) {
    // the split layout has f32 instances only (the routed payload is f32)
    if (payload_bf16 || stride < E) return static_cast<int>(cudaErrorInvalidValue);
    const size_t st = static_cast<size_t>(stride);
    return w_bf16 ? launch_update<float, bf16, true>(sids, perm, N, gg2, g2, st, gg2_lin, vec_n,
                                                     vec_z, vec_w, lin_n, lin_z, lin_w, R, E,
                                                     lane, p, hot, instance, s)
                  : launch_update<float, float, true>(sids, perm, N, gg2, g2, st, gg2_lin,
                                                      vec_n, vec_z, vec_w, lin_n, lin_z, lin_w,
                                                      R, E, lane, p, hot, instance, s);
  }
  if (payload_bf16) {
    return w_bf16 ? launch_update<bf16, bf16, false>(sids, perm, N, gg2, nullptr, 0, gg2_lin,
                                                     vec_n, vec_z, vec_w, lin_n, lin_z, lin_w, R,
                                                     E, lane, p, hot, instance, s)
                  : launch_update<bf16, float, false>(sids, perm, N, gg2, nullptr, 0, gg2_lin,
                                                      vec_n, vec_z, vec_w, lin_n, lin_z, lin_w,
                                                      R, E, lane, p, hot, instance, s);
  }
  return w_bf16 ? launch_update<float, bf16, false>(sids, perm, N, gg2, nullptr, 0, gg2_lin,
                                                    vec_n, vec_z, vec_w, lin_n, lin_z, lin_w, R,
                                                    E, lane, p, hot, instance, s)
                : launch_update<float, float, false>(sids, perm, N, gg2, nullptr, 0, gg2_lin,
                                                     vec_n, vec_z, vec_w, lin_n, lin_z, lin_w, R,
                                                     E, lane, p, hot, instance, s);
}

// Launch on `stream`: sids [N] int32 sorted stably, perm [N] int64, g and
// g2 [N, E], z and a [R, E] (a zero on the rows no id touches), hot
// [ftrl_update_scratch_ints(N)] int32 scratch, all contiguous on the
// current device: z[id] += sum g, a[id] = sum g^2.  Writes the instance it
// runs to *instance (a ScatterInstance).  Returns the CUDA error of the
// launches (0 on success).
int za_scatter_launch(const int* sids, const long long* perm, int N, const float* g,
                      const float* g2, float* z, float* a, int R, int E, int* hot, int* instance,
                      void* stream) {
  if (N == 0 || E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quads = E % 4 == 0 && aligned(g, 16) && aligned(g2, 16) && aligned(z, 16) &&
                     aligned(a, 16);
  if (!quads) {
    *instance = kScatterScalar;
    za_scatter_scalar<<<segment_blocks(N), kThreads, 0, s>>>(sids, perm, N, g, g2, z, a, R, E);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, sms = 0;
  cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // once per device: the hot kernel's shared memory allowance (above the
  // 48 KB default) and its blocks per SM (its grid fills the card once)
  static int hot_per_sm[kMaxDevices] = {};
  if (hot_per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(&za_scatter_hot, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kScatterHotBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, za_scatter_hot, kThreads,
                                                        kScatterHotBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    hot_per_sm[dev] = blocks > 0 ? blocks : 1;
  }
  err = cudaMemsetAsync(hot, 0, sizeof(int), s);  // the hot list's length
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E <= kNarrowCols) {
    *instance = kScatterNarrow;
    const int q = E / 4;
    err = q <= 1   ? launch_scatter_narrow<1>(sids, perm, N, g, g2, z, a, R, E, hot, s)
          : q <= 2 ? launch_scatter_narrow<2>(sids, perm, N, g, g2, z, a, R, E, hot, s)
          : q <= 4 ? launch_scatter_narrow<4>(sids, perm, N, g, g2, z, a, R, E, hot, s)
                   : launch_scatter_narrow<8>(sids, perm, N, g, g2, z, a, R, E, hot, s);
  } else {
    *instance = kScatterRows;
    static int per_sm[kMaxDevices] = {};
    int grid = 0;
    err = persistent_grid(za_scatter_rows, N, per_sm, &grid);
    if (err == cudaSuccess) {
      za_scatter_rows<<<grid, kThreads, 0, s>>>(sids, perm, N, g, g2, z, a, R, E, hot);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  za_scatter_hot<<<hot_per_sm[dev] * sms, kThreads, kScatterHotBytes, s>>>(sids, perm, N, g, g2,
                                                                           z, a, E, hot);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
