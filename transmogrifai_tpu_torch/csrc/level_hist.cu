// K1: per-level split histogram of the tree builder, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel transmogrifai_tpu/models/pallas_hist.py
// (pallas_level_hist, body _hist_kernel). It computes the same function,
//
//     hist[c, b, s] = sum_r [slot_r == c] * stats[r, s] * bin_oh[r, b],
//
// but from the packed bin ids instead of the dense (n, TB) indicator:
// bin_oh[r, b] = [packed[r, feat_of[b]] == b], so row r adds stats[r] at
// bin packed[r, f] for each feature f. Rows whose slot lies outside
// [0, C) (the sentinel of histogram subtraction) and rows whose stats are
// all zero add nothing.
//
// Bound on this card: memory. The call must read packed (4*n*d bytes),
// slot (4*n) and stats (4*n*S) once and write the histogram (4*C*TB*S);
// at n = 1M, d = 100, S = 2, C = 256 that is about 0.41 GB, 0.12 ms at
// 3.35 TB/s. Its n*d*S additions are trivial for the ALUs. Rows outside
// [0, C) need neither stats nor bin ids read, rows with zero stats no bin
// ids, so inert rows lower the bound (hist_kernel.hist_bytes).
//
// Design (simple first): the TPU kernel keeps its accumulator in VMEM and
// feeds the MXU; Hopper has no shared-memory room for a dense one-hot
// contraction and Triton has no shared-memory atomics, so this is a
// scatter-add into privatized shared-memory histograms.
//   - grid (row chunk, slot tile, feature group); a block owns the
//     (slot tile x packed-bin range of its feature group x S) histogram in
//     dynamic shared memory (the wrapper sizes it to about 96 KB so two
//     blocks fit on an SM);
//   - a warp takes 32 rows at a time: each lane loads one row's slot and,
//     only if the slot is in the block's tile, its stats; the warp then
//     walks the rows that have work, broadcasting slot and stats with
//     shuffles, and its lanes split that row's features. The row's bin ids
//     are contiguous in the row-major packed matrix, so the read is
//     coalesced and the lanes of a warp add into different features' bins
//     (no intra-warp conflict on one address);
//   - one flush per block adds the non-zero shared entries into the output
//     with global atomics; the wrapper zeroes the output first.
// Float atomics add in an order that changes from run to run, so the sums
// are reproducible only to rounding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStats = 4;

__global__ void __launch_bounds__(kThreads)
level_hist_kernel(const int32_t* __restrict__ packed,
                  const int32_t* __restrict__ slot,
                  const float* __restrict__ stats,
                  float* __restrict__ out,
                  const int32_t* __restrict__ groups,
                  long long n, int d, int S, int C, int TB, int c_tile,
                  long long rows_per_chunk) {
  extern __shared__ float hist[];
  const int g = blockIdx.z;
  int f_lo = 0, f_hi = d, b_lo = 0, b_hi = TB;
  if (groups != nullptr) {
    f_lo = groups[4 * g];
    f_hi = groups[4 * g + 1];
    b_lo = groups[4 * g + 2];
    b_hi = groups[4 * g + 3];
  }
  const int width = b_hi - b_lo;
  const int c0 = blockIdx.y * c_tile;
  const int c1 = min(c0 + c_tile, C);
  const int slot_elems = width * S;
  const int tile_elems = (c1 - c0) * slot_elems;
  for (int i = threadIdx.x; i < tile_elems; i += kThreads) hist[i] = 0.f;
  __syncthreads();

  const long long r_begin = (long long)blockIdx.x * rows_per_chunk;
  const long long r_end = min(n, r_begin + rows_per_chunk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long base = r_begin + (long long)warp * 32; base < r_end;
       base += (long long)kWarps * 32) {
    const long long r = base + lane;
    int c = -1;
    float st[kMaxStats];
#pragma unroll
    for (int s = 0; s < kMaxStats; ++s) st[s] = 0.f;
    if (r < r_end) {
      const int sl = slot[r];
      if (sl >= c0 && sl < c1) {
        bool any = false;
#pragma unroll
        for (int s = 0; s < kMaxStats; ++s) {
          if (s < S) {
            st[s] = stats[r * S + s];
            any = any || (st[s] != 0.f);
          }
        }
        if (any) c = sl - c0;
      }
    }
    unsigned todo = __ballot_sync(0xffffffffu, c >= 0);
    while (todo != 0u) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int cj = __shfl_sync(0xffffffffu, c, j);
      float sj[kMaxStats];
#pragma unroll
      for (int s = 0; s < kMaxStats; ++s)
        sj[s] = __shfl_sync(0xffffffffu, st[s], j);
      const int32_t* row = packed + (base + j) * (long long)d;
      float* h = hist + cj * slot_elems;
      for (int f = f_lo + lane; f < f_hi; f += 32) {
        const int b = row[f] - b_lo;
        // the design keeps every bin of the group's features inside
        // [b_lo, b_hi); the guard keeps a corrupt id out of shared memory
        if ((unsigned)b < (unsigned)width) {
#pragma unroll
          for (int s = 0; s < kMaxStats; ++s)
            if (s < S) atomicAdd(h + b * S + s, sj[s]);
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tile_elems; i += kThreads) {
    const float v = hist[i];
    if (v != 0.f) {
      const int cl = i / slot_elems;
      const int k = i - cl * slot_elems;
      atomicAdd(out + ((long long)(c0 + cl) * TB + b_lo) * S + k, v);
    }
  }
}

}  // namespace

// Launches K1 on ``stream``. ``groups`` is null (one group: every feature,
// every packed bin) or a device array of n_groups rows
// (f_lo, f_hi, b_lo, b_hi). ``out`` must hold C*TB*S zeroed floats.
// Returns the CUDA error of the launch (0 on success).
extern "C" int tx_level_hist(const void* packed, const void* slot,
                             const void* stats, void* out,
                             const void* groups, long long n, int d, int S,
                             int C, int TB, int n_groups, int c_tile,
                             int w_max, int row_chunks, void* stream) {
  if (n <= 0 || d <= 0 || S <= 0 || S > kMaxStats || C <= 0 || TB <= 0 ||
      n_groups <= 0 || c_tile <= 0 || w_max <= 0 || row_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  const long long rows_per_chunk = (n + row_chunks - 1) / row_chunks;
  const size_t smem = (size_t)c_tile * w_max * S * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      level_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)row_chunks, (unsigned)((C + c_tile - 1) / c_tile),
                  (unsigned)n_groups);
  level_hist_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)packed, (const int32_t*)slot, (const float*)stats,
      (float*)out, (const int32_t*)groups, n, d, S, C, TB, c_tile,
      rows_per_chunk);
  return (int)cudaGetLastError();
}
