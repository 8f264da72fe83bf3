// K1: per-level split histogram of the tree builder, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel transmogrifai_tpu/models/pallas_hist.py
// (pallas_level_hist, body _hist_kernel). It computes the same function,
//
//     hist[c, b, s] = sum_r [slot_r == c] * stats[r, s] * bin_oh[r, b],
//
// from compact bin ids instead of the dense (n, TB) indicator:
// bin_oh[r, b] = [offsets[f] + ids[r, f] == b] for the feature f that owns
// bin b. ids is row-major (n, stride) uint8 (every feature <= 256 bins) or
// uint16, its rows padded to a multiple of 16 bytes. Rows whose slot lies
// outside [0, C) (the sentinel of histogram subtraction) and rows whose
// stats are all zero add nothing.
//
// Bound on this card: memory. The call must read the ids (d * id bytes a
// row; the pad is the kernel's own), slot (4 a row) and stats (4*S a row)
// once and write the histogram (4*C*TB*S); at n = 1M, d = 100 (uint8
// ids), S = 2, C = 256 that is about 113.6 MB, 0.0339 ms at 3.35 TB/s
// (0.123 ms for the int32 packed ids the first design read). What sets the time instead is
// the n*d*S shared-memory float adds: Hopper has no shared-memory float
// atomic, so each add is a load and compare-and-swap loop
// (ATOMS.CAST.SPIN), and adds that meet on one address retry.
//
// Design:
//   - staged row tiles: a producer warp keeps a ring of 2-4 stages of row
//     tiles in flight with cp.async.bulk (1-D TMA) and mbarriers. 31
//     consumer warps work from shared memory: a thread owns one 32-bit
//     word of a row (4 uint8 or 2 uint16 features, their packed offsets
//     in registers) and its rows run on from one tile into the next, so
//     975 of 992 threads are busy at d = 100 and none waits on a global
//     load of its own;
//   - statistic-planar histograms, hist[s][slot][pos], with feature f's
//     bins at pos = offsets[f] + f / K (K features a word): the one-float
//     skew per word puts the lanes of a warp, which hold consecutive
//     words, on different banks when their bins have equal local ids;
//   - a block owns a (slot tile x feature group) histogram sized from the
//     227 KB a block may use less the ring (HistPlan.launch in
//     models/hist_kernel.py). Where it is small (C <= 16 at TB = 800) the
//     block keeps up to 31 copies, one per group of warps, so that adds
//     of different warps to the hot bins (a binary feature's 0 at C = 1)
//     do not meet; the copies are summed at the flush;
//   - large C without rescans: where C needs several slot tiles (C >= 64
//     at TB = 800, C = 256 eight), two small kernels first bucket the row
//     ids by slot tile (a counting pass, then a scatter), and each tile's
//     blocks stage only their bucket's rows: the producer warp's lanes
//     issue one bulk copy per row of ids and load its slot and stats.
//     With one slot tile the rows stream as three contiguous copies a
//     tile;
//   - the grid is (row split x tile), tiles fastest; the split count fills
//     the card's resident blocks (occupancy query) in one wave;
//   - each block adds its non-zero histogram entries into the output with
//     global float atomics; the wrapper zeroes the output first.
// Float atomics (shared and global) add in an order that changes from run
// to run, so the sums are reproducible only to rounding.
//
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3 at 700 W; 1M rows
// x 100 features, TB = 800, S = 2): 0.39-0.41 ms a launch at C = 1-32 and
// 0.47-0.49 ms at C = 64-256, against 1.05-2.86 ms for the first design
// (int32 ids, a row a warp step) and 1.6-11.6 ms for one index_add_. The
// floor is the ~200M compare-and-swap adds, not the 0.034 ms of bytes;
// PERF.md lists the variants timed (chip_smoke.py --k1-only in edited
// copies).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kConsumers = kThreads - 32;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kMaxStats = 4;
constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 128;  // 8 mbarriers, then the block's row span
constexpr int kMaxSlotTiles = 4096;
constexpr int kBucketThreads = 512;

struct Args {
  const unsigned char* ids;
  const int32_t* slot;
  const float* stats;
  const int32_t* offsets;
  const int32_t* pos_of_bin;
  const int32_t* groups;
  const int32_t* perm;      // rows bucketed by slot tile, or null
  const int32_t* counts;    // rows of each slot tile (with perm)
  float* out;
  long long n;
  int d, stride_bytes, C, TB;
  int n_ct, n_tiles, c_tile, copies, stages, rows, splits;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// one bulk copy global -> shared; completion counts on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// slot tile of row r, or -1 for a row outside [0, C)
__device__ __forceinline__ int tile_of(const int32_t* slot, long long r,
                                       long long n, int C, int c_tile) {
  if (r >= n) return -1;
  const int s = slot[r];
  return (unsigned)s < (unsigned)C ? s / c_tile : -1;
}

// Adds one to local[t] for every lane with t >= 0, one shared atomic per
// distinct t in the warp; returns the lane's rank among its peers plus the
// count before the warp's add (all lanes of the warp must call it).
__device__ __forceinline__ int warp_count(int* local, int t) {
  const unsigned peers = __match_any_sync(0xffffffffu, t);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int before = 0;
  if (t >= 0 && lane == leader) before = atomicAdd(&local[t], __popc(peers));
  before = __shfl_sync(0xffffffffu, before, leader);
  return before + __popc(peers & ((1u << lane) - 1u));
}

// Rows of each slot tile: counts[t] += rows whose slot lies in tile t.
__global__ void __launch_bounds__(kBucketThreads)
count_tiles(const int32_t* __restrict__ slot, long long n, int C,
            int c_tile, int n_ct, int* __restrict__ counts) {
  extern __shared__ int local[];
  for (int i = threadIdx.x; i < n_ct; i += kBucketThreads) local[i] = 0;
  __syncthreads();
  const long long step = (long long)gridDim.x * kBucketThreads;
  for (long long r = (long long)blockIdx.x * kBucketThreads + threadIdx.x;
       r - threadIdx.x < n; r += step)
    warp_count(local, tile_of(slot, r, n, C, c_tile));
  __syncthreads();
  for (int i = threadIdx.x; i < n_ct; i += kBucketThreads)
    if (local[i]) atomicAdd(&counts[i], local[i]);
}

// Scatters the row ids into perm, grouped by slot tile (tile t holds
// perm[sum(counts[:t]) : sum(counts[:t+1])]); ``cursor`` starts at zero.
__global__ void __launch_bounds__(kBucketThreads)
scatter_rows(const int32_t* __restrict__ slot, long long n, int C,
             int c_tile, int n_ct, const int* __restrict__ counts,
             int* __restrict__ cursor, int32_t* __restrict__ perm) {
  extern __shared__ int local[];                 // n_ct counts, n_ct bases
  int* base = local + n_ct;
  for (int i = threadIdx.x; i < n_ct; i += kBucketThreads) local[i] = 0;
  __syncthreads();
  const long long chunk = (n + gridDim.x - 1) / gridDim.x;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = min(n, lo + chunk);
  for (long long r = lo + threadIdx.x; r - threadIdx.x < hi;
       r += kBucketThreads)
    warp_count(local, r < hi ? tile_of(slot, r, n, C, c_tile) : -1);
  __syncthreads();
  for (int i = threadIdx.x; i < n_ct; i += kBucketThreads) {
    int start = 0;
    for (int j = 0; j < i; ++j) start += counts[j];
    base[i] = local[i] ? start + atomicAdd(&cursor[i], local[i]) : 0;
    local[i] = 0;
  }
  __syncthreads();
  for (long long r = lo + threadIdx.x; r - threadIdx.x < hi;
       r += kBucketThreads) {
    const int t = r < hi ? tile_of(slot, r, n, C, c_tile) : -1;
    const int rank = warp_count(local, t);
    if (t >= 0) perm[base[t] + rank] = (int32_t)r;
  }
}

template <int kIdBytes, int kS>
__global__ void __launch_bounds__(kThreads)
level_hist_kernel(const Args a) {
  constexpr int K = 4 / kIdBytes;                 // features per word
  constexpr uint32_t kMask = (1u << (8 * kIdBytes)) - 1u;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const int ids_bytes = a.rows * a.stride_bytes;
  const int stage_bytes = ids_bytes + a.rows * 4 + a.rows * kS * 4;
  unsigned char* ring = smem + kBarrierBytes;
  float* hist = reinterpret_cast<float*>(ring + a.stages * stage_bytes);
  long long* span = reinterpret_cast<long long*>(smem + 64);  // its rows

  const int tile = blockIdx.x % a.n_tiles;
  const int split = blockIdx.x / a.n_tiles;
  const int ct = tile % a.n_ct;
  const int* grp = a.groups + 6 * (tile / a.n_ct);
  const int f_lo = grp[0], f_hi = grp[1], b_lo = grp[2], b_hi = grp[3];
  const int p_lo = grp[4], width = grp[5] - grp[4];
  const int c0 = ct * a.c_tile;
  const int nc = min(a.c_tile, a.C - c0);
  const int plane = nc * width;
  const int copy_floats = kS * plane;
  for (int i = threadIdx.x; i < a.copies * copy_floats; i += kThreads)
    hist[i] = 0.f;
  if (threadIdx.x == 0) {
    // the rows this block walks: its share of the whole design, or of its
    // slot tile's bucket
    long long lo = 0, len = a.n;
    if (a.perm != nullptr) {
      lo = 0;
      for (int j = 0; j < ct; ++j) lo += a.counts[j];
      len = a.counts[ct];
    }
    // whole row tiles a split, so that contiguous copies stay aligned
    const long long per =
        ((len + a.splits - 1) / a.splits + a.rows - 1) / a.rows * a.rows;
    span[0] = lo + min(len, (long long)split * per);
    span[1] = lo + min(len, (long long)(split + 1) * per);
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], a.perm != nullptr ? 32 : 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long r_lo = span[0];
  const long long r_hi = span[1];
  // contiguous rows stream in whole tiles (the rows past the last one are
  // read from global memory); bucketed rows in tiles of up to a.rows
  const long long r_staged =
      a.perm != nullptr ? r_hi
                        : r_lo + (r_hi - r_lo) / a.rows * a.rows;
  const int n_stages = (int)((r_staged - r_lo + a.rows - 1) / a.rows);

  if (threadIdx.x >= kConsumers) {                // the producer warp
    const int lane = threadIdx.x - kConsumers;
    // bucketed rows: each lane gathers rows lane and lane + 32 of a tile;
    // their ids in the bucket are loaded one stage ahead
    int next[2] = {-1, -1};
    auto fetch = [&](int i) {
      const long long r0 = r_lo + (long long)i * a.rows;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long q = r0 + lane + 32 * h;
        next[h] = i < n_stages && lane + 32 * h < a.rows && q < r_staged
                      ? a.perm[q] : -1;
      }
    };
    if (a.perm != nullptr) fetch(0);
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % a.stages;
      mbar_wait(&empty[st], ((i / a.stages) & 1) ^ 1);
      unsigned char* buf = ring + st * stage_bytes;
      int32_t* slots = reinterpret_cast<int32_t*>(buf + ids_bytes);
      float* stats = reinterpret_cast<float*>(buf + ids_bytes + a.rows * 4);
      const long long r0 = r_lo + (long long)i * a.rows;
      if (a.perm == nullptr) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], (uint32_t)stage_bytes);
          bulk_load(buf, a.ids + r0 * a.stride_bytes, ids_bytes, &full[st]);
          bulk_load(slots, a.slot + r0, a.rows * 4, &full[st]);
          bulk_load(stats, a.stats + r0 * kS, a.rows * kS * 4, &full[st]);
        }
      } else {
        const int nr = (int)min((long long)a.rows, r_staged - r0);
        if (lane == 0)
          mbar_expect_tx(&full[st], (uint32_t)(nr * a.stride_bytes));
        __syncwarp();
        const int row[2] = {next[0], next[1]};
        fetch(i + 1);
        int sl[2];
        float sv[2][kS];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (row[h] < 0) continue;
          bulk_load(buf + (lane + 32 * h) * a.stride_bytes,
                    a.ids + (long long)row[h] * a.stride_bytes,
                    a.stride_bytes, &full[st]);
          sl[h] = a.slot[row[h]];
#pragma unroll
          for (int s = 0; s < kS; ++s)
            sv[h][s] = a.stats[(long long)row[h] * kS + s];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (row[h] < 0) continue;
          slots[lane + 32 * h] = sl[h];
#pragma unroll
          for (int s = 0; s < kS; ++s) stats[(lane + 32 * h) * kS + s] = sv[h][s];
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // this thread's word of a row: features (w_lo + col) * K + k; the
    // consumers take ``pass`` rows at a time; warp w adds into copy
    // w % copies
    const int w_lo = f_lo / K;
    const int words = (f_hi + K - 1) / K - w_lo;
    const int col = threadIdx.x % words;
    const int sub = threadIdx.x / words;
    const int pass = kConsumers / words;
    const bool active = sub < pass;
    float* mine = hist + ((threadIdx.x >> 5) % a.copies) * copy_floats;
    int pos[K], wid[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int f = (w_lo + col) * K + k;
      wid[k] = 0;
      pos[k] = 0;
      if (f >= f_lo && f < f_hi) {
        const int o = a.offsets[f];
        wid[k] = (f + 1 < a.d ? a.offsets[f + 1] : a.TB) - o;
        pos[k] = o + f / K - p_lo;
      }
    }
    // row r of (ids with the padded stride, slots, stats)
    auto add = [&](const unsigned char* ids, const int32_t* slots,
                   const float* stats, int r) {
      const int c = slots[r] - c0;
      if ((unsigned)c >= (unsigned)nc) return;
      float v[kS];
      bool any = false;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        v[s] = stats[r * kS + s];
        any = any || v[s] != 0.f;
      }
      if (!any) return;
      const uint32_t word = *reinterpret_cast<const uint32_t*>(
          ids + (long long)r * a.stride_bytes + 4 * (w_lo + col));
      float* h = mine + c * width;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int id = (int)((word >> (8 * kIdBytes * k)) & kMask);
        // the width guard keeps a corrupt id (and the pad features,
        // width 0) out of shared memory
        if (id < wid[k]) {
#pragma unroll
          for (int s = 0; s < kS; ++s) atomicAdd(h + s * plane + pos[k] + id, v[s]);
        }
      }
    };
    // the thread's rows run on from one staged tile into the next, so no
    // lane idles at a tile's end
    int r = sub;
    for (int i = 0; i < n_stages; ++i) {
      const int st = i % a.stages;
      const int nr = (int)min((long long)a.rows,
                              r_staged - r_lo - (long long)i * a.rows);
      mbar_wait(&full[st], (i / a.stages) & 1);
      const unsigned char* buf = ring + st * stage_bytes;
      if (active) {
        for (; r < nr; r += pass)
          add(buf, reinterpret_cast<const int32_t*>(buf + ids_bytes),
              reinterpret_cast<const float*>(buf + ids_bytes + a.rows * 4),
              r);
        r -= nr;
      }
      mbar_arrive(&empty[st]);
    }
    // contiguous rows past the last whole tile, read from global memory
    if (active)
      for (int q = sub; q < (int)(r_hi - r_staged); q += pass)
        add(a.ids + r_staged * a.stride_bytes, a.slot + r_staged,
            a.stats + r_staged * kS, q);
  }
  __syncthreads();

  // sum the copies in a fixed order and add the block's entries out
  const int bw = b_hi - b_lo;
  const int per_slot = bw * kS;
  for (int i = threadIdx.x; i < nc * per_slot; i += kThreads) {
    const int cl = i / per_slot;
    const int k = i - cl * per_slot;
    const int j = k / kS;
    const int s = k - j * kS;
    const int b = b_lo + j;
    const int at = s * plane + cl * width + (a.pos_of_bin[b] - p_lo);
    float v = 0.f;
    for (int m = 0; m < a.copies; ++m) v += hist[m * copy_floats + at];
    if (v != 0.f)
      atomicAdd(a.out + ((long long)(c0 + cl) * a.TB + b) * kS + s, v);
  }
}

template <int kIdBytes, int kS>
cudaError_t launch(Args a, int smem, int sms, cudaStream_t stream) {
  // the attribute and the occupancy query once per shared-memory size
  static int known_smem = -1, per_sm = 0;
  const void* kernel = (const void*)level_hist_kernel<kIdBytes, kS>;
  if (smem != known_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    known_smem = smem;
  }
  // one wave: as many row splits as the resident blocks hold, at least
  // one and at most one per tile of rows
  const long long row_tiles = (a.n + a.rows - 1) / a.rows;
  long long splits = (long long)sms * per_sm / a.n_tiles;
  if (splits > row_tiles) splits = row_tiles;
  a.splits = (int)(splits < 1 ? 1 : splits);
  const long long grid = (long long)a.n_tiles * a.splits;
  level_hist_kernel<kIdBytes, kS><<<(unsigned)grid, kThreads, smem,
                                    stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches K1 on ``stream``. ``ids`` (n, stride_bytes / id_bytes) compact
// bin ids, ``offsets`` (d,) int32, ``pos_of_bin`` (TB,) int32 skewed
// position of each packed bin, ``groups`` (n_groups, 6) int32 rows
// (f_lo, f_hi, b_lo, b_hi, p_lo, p_hi), ``out`` C*TB*S zeroed floats.
// A block holds ``copies`` copies of c_tile slots x w_max positions and a
// ring of ``stages`` tiles of ``rows`` rows. With more than one slot tile
// ``perm`` (n int32) and ``work`` (2 * n_tiles_of_slots int32, zeroed)
// take the bucketed row ids. Returns the CUDA error of the launches (0 on
// success).
extern "C" int tx_level_hist(const void* ids, const void* slot,
                             const void* stats, const void* offsets,
                             const void* pos_of_bin, const void* groups,
                             void* perm, void* work, void* out, long long n,
                             int d, int stride_bytes, int id_bytes, int S,
                             int C, int TB, int n_groups, int c_tile,
                             int w_max, int copies, int stages, int rows,
                             int consumers, void* stream) {
  const int n_ct = C > 0 && c_tile > 0 ? (C + c_tile - 1) / c_tile : 0;
  if (n <= 0 || n >= (1ll << 31) || d <= 0 || S <= 0 || S > kMaxStats ||
      C <= 0 || TB <= 0 || n_groups <= 0 || c_tile <= 0 || w_max <= 0 ||
      copies < 1 || copies > kConsumerWarps || stages < 2 ||
      stages > kMaxStages || rows <= 0 || rows % 4 != 0 ||
      stride_bytes % 16 != 0 || stride_bytes < d * id_bytes ||
      rows > 64 || consumers != kConsumers ||
      (id_bytes != 1 && id_bytes != 2) ||
      n_ct > kMaxSlotTiles || (n_ct > 1 && (perm == nullptr ||
                                            work == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long stage_bytes =
      (long long)rows * (stride_bytes + 4 + 4 * S);
  const long long smem = kBarrierBytes + stages * stage_bytes +
                         (long long)copies * c_tile * w_max * S * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  int dev = 0;
  static int sms = 0;
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  Args a;
  a.ids = (const unsigned char*)ids;
  a.slot = (const int32_t*)slot;
  a.stats = (const float*)stats;
  a.offsets = (const int32_t*)offsets;
  a.pos_of_bin = (const int32_t*)pos_of_bin;
  a.groups = (const int32_t*)groups;
  a.perm = nullptr;
  a.counts = nullptr;
  if (n_ct > 1) {
    int* counts = (int*)work;
    const long long blocks_ll = (n + 8 * kBucketThreads - 1)
                                / (8 * kBucketThreads);
    const int blocks = (int)(blocks_ll < 4 * sms ? blocks_ll : 4 * sms);
    count_tiles<<<blocks, kBucketThreads, n_ct * sizeof(int), st>>>(
        (const int32_t*)slot, n, C, c_tile, n_ct, counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scatter_rows<<<blocks, kBucketThreads, 2 * n_ct * sizeof(int), st>>>(
        (const int32_t*)slot, n, C, c_tile, n_ct, counts, counts + n_ct,
        (int32_t*)perm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    a.perm = (const int32_t*)perm;
    a.counts = counts;
  }
  a.out = (float*)out;
  a.n = n;
  a.d = d;
  a.stride_bytes = stride_bytes;
  a.C = C;
  a.TB = TB;
  a.n_ct = n_ct;
  a.n_tiles = n_ct * n_groups;
  a.c_tile = c_tile;
  a.copies = copies;
  a.stages = stages;
  a.rows = rows;
  a.splits = 1;
  const int m = (int)smem;
  switch (id_bytes * 8 + S) {
    case 9: return (int)launch<1, 1>(a, m, sms, st);
    case 10: return (int)launch<1, 2>(a, m, sms, st);
    case 11: return (int)launch<1, 3>(a, m, sms, st);
    case 12: return (int)launch<1, 4>(a, m, sms, st);
    case 17: return (int)launch<2, 1>(a, m, sms, st);
    case 18: return (int)launch<2, 2>(a, m, sms, st);
    case 19: return (int)launch<2, 3>(a, m, sms, st);
    default: return (int)launch<2, 4>(a, m, sms, st);
  }
}
