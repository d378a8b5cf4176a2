// K4 round_append: one chunk's rows appended to the round buffers of the
// streamed graph stage, for Hopper (sm_90a).
//
// Replaces the append of sibeliaz_tpu/graph/streamed.py::_round_scan_pass
// (its key sort, counts and prefix, :387-418, and its per-round append loop
// with the overflow test and cursor update, :448-486), an XLA program.
//
// The streamed stage splits the vertex classes into n_rounds rounds by a
// Fibonacci hash of the canonical key and fills G round buffers (rounds r0
// .. r0 + G - 1) per pass over the genome. Per row i of a chunk (K1's
// outputs: one or two int64 key limbs and the int32 word):
//   round = (((key * MIX) >> 32) & 0x7FFFFFFF) % n_rounds, or for two limbs
//           (((hi * MIX) ^ (lo * MIX2)) >> 32) & 0x7FFFFFFF, the products
//           wrapping at 64 bits (streamed.py _round_bucket:312,
//           _round_bucket2:324; the mask drops the bits where an arithmetic
//           and a logical shift differ);
//   the row is kept when its key is not the invalid key 2^62 and round - r0
//   lies in [0, G); it goes to buffer g = round - r0 at row cursor[g] + its
//   rank among the chunk's kept rows of round g, so that a round's rows
//   stay in ascending genome position across tiles and across chunks (the
//   class analysis takes a class's first row as its first occurrence);
//   written: the key limb(s) and the payload (gpos0 + i) << 12 | (word &
//   0xFFF). Rows at or past the cap are not written; the overflow flag is
//   set when a round's cursor passes the cap; cursors always advance by the
//   kept rows, so the host reads every round's true size.
//
// What bounds it: device memory. The function reads every row's keys once
// (8 B a row, 16 B with two limbs) and each kept row's word (4 B), and writes
// 16 B (24 B) per kept row; a hash, a modulo and a compare per row are far
// below the card's integer rate for those bytes. Three launches:
//   1. count: a block takes a tile of kTile rows, each warp 256 consecutive
//      rows in 8 steps of 32; per step the lanes of one round find each
//      other with __match_any_sync and the lowest adds their number to the
//      block's count of that round in shared memory. Out: per tile, per
//      round counts.
//   2. scan: one block per round scans its counts over the tiles from the
//      round's cursor (an exclusive prefix: each tile's first destination
//      row), then moves the cursor on and sets the overflow flag.
//   3. scatter: the tile again, each row loaded once and kept in registers;
//      the warps' counts per round (match, as in 1) give each warp its first
//      row per round, and each step's lanes of a round take consecutive rows
//      by their rank in the match mask (a __popc under the lane mask). A
//      round's rows of one warp step are consecutive in memory, so the
//      stores of a step fall into few segments.
// Scratch: per tile and round one int64 first row and one int32 count; no
// zeroing (every entry is written before it is read). Keys and words are
// read with scalar loads, so views at any offset work (the stage passes
// K1's outputs from window offset 1 on).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 8;                    // rows per thread, one a warp step
constexpr int kWarpRows = 32 * kSteps;       // consecutive rows per warp
constexpr int kTile = kThreads * kSteps;     // rows per tile
constexpr int kMaxRounds = 64;               // rounds per launch (shared counters)
constexpr int kScanThreads = 1024;
constexpr long long kInvalidCanon = 1LL << 62;
constexpr u64 kMix = 0x9E3779B97F4A7C15ull;
constexpr u64 kMix2 = 0xC2B2AE3D27D4EB4Full;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Round {
  int r0;
  unsigned n_rounds;
  int G;
};

// Round of a row relative to r0, or -1 where the row is not kept.
template <int LIMBS>
__device__ __forceinline__ int round_of(long long a, long long b, const Round& rd) {
  if (a == kInvalidCanon) return -1;
  u64 h = static_cast<u64>(a) * kMix;
  if (LIMBS == 2) h ^= static_cast<u64>(b) * kMix2;
  const int g =
      static_cast<int>(static_cast<unsigned>((h >> 32) & 0x7FFFFFFFull) % rd.n_rounds) - rd.r0;
  return (g >= 0 && g < rd.G) ? g : -1;
}

template <int LIMBS>
__global__ void __launch_bounds__(kThreads)
    round_count_kernel(const long long* __restrict__ k0, const long long* __restrict__ k1,
                       long long m, Round rd, int* __restrict__ tile_counts) {
  __shared__ int count[kMaxRounds];
  for (int g = threadIdx.x; g < rd.G; g += kThreads) count[g] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + (threadIdx.x >> 5) * kWarpRows + lane;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long i = base + s * 32;
    int g = -1;
    if (i < m) g = round_of<LIMBS>(k0[i], LIMBS == 2 ? k1[i] : 0, rd);
    const unsigned same = __match_any_sync(kFull, g);
    if (g >= 0 && lane == __ffs(same) - 1) atomicAdd(&count[g], __popc(same));
  }
  __syncthreads();
  for (int g = threadIdx.x; g < rd.G; g += kThreads) {
    tile_counts[static_cast<long long>(blockIdx.x) * rd.G + g] = count[g];
  }
}

// One block per round: first[t] = cursor + the counts of tiles before t.
__global__ void __launch_bounds__(kScanThreads)
    round_scan_kernel(const int* __restrict__ tile_counts, long long tiles, int G, long long cap,
                      long long* __restrict__ tile_first, long long* __restrict__ cursors,
                      int* __restrict__ overflow) {
  __shared__ long long warp_sum[kScanThreads / 32];
  __shared__ long long carry;
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = cursors[g];
  __syncthreads();
  for (long long t0 = 0; t0 < tiles; t0 += kScanThreads) {
    const long long t = t0 + threadIdx.x;
    const long long v = t < tiles ? tile_counts[t * G + g] : 0;
    long long x = v;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += y;
      }
      warp_sum[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const long long before = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - v;
    if (t < tiles) tile_first[t * G + g] = before;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (carry > cap) *overflow = 1;
    cursors[g] = carry;
  }
}

template <int LIMBS>
__global__ void __launch_bounds__(kThreads)
    round_scatter_kernel(const long long* __restrict__ k0, const long long* __restrict__ k1,
                         const int32_t* __restrict__ packed, long long m, long long gpos0,
                         Round rd, long long cap, const long long* __restrict__ tile_first,
                         long long* __restrict__ b0, long long* __restrict__ b1,
                         long long* __restrict__ payload) {
  __shared__ int count[kWarps][kMaxRounds];
  __shared__ long long next[kWarps][kMaxRounds];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = lane; g < rd.G; g += 32) count[warp][g] = 0;
  __syncwarp();
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + warp * kWarpRows + lane;
  int g[kSteps];
  unsigned same[kSteps];
  long long a[kSteps], b[kSteps];
  int32_t w[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long i = base + s * 32;
    g[s] = -1;
    a[s] = 0;
    b[s] = 0;
    w[s] = 0;
    if (i < m) {
      a[s] = k0[i];
      if (LIMBS == 2) b[s] = k1[i];
      g[s] = round_of<LIMBS>(a[s], b[s], rd);
      if (g[s] >= 0) w[s] = packed[i];
    }
    same[s] = __match_any_sync(kFull, g[s]);
    if (g[s] >= 0 && lane == __ffs(same[s]) - 1) count[warp][g[s]] += __popc(same[s]);
    __syncwarp();
  }
  __syncthreads();
  // each warp's first destination row per round: the tile's, plus the rows
  // of the warps before it
  for (int r = threadIdx.x; r < rd.G; r += kThreads) {
    long long at = tile_first[static_cast<long long>(blockIdx.x) * rd.G + r];
    for (int v = 0; v < kWarps; ++v) {
      next[v][r] = at;
      at += count[v][r];
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    long long dst = 0;
    if (g[s] >= 0) {
      dst = next[warp][g[s]] + __popc(same[s] & below);
      if (dst < cap) {
        const long long row = static_cast<long long>(g[s]) * cap + dst;
        b0[row] = a[s];
        if (LIMBS == 2) b1[row] = b[s];
        payload[row] = ((gpos0 + base + s * 32) << 12) | static_cast<long long>(w[s] & 0xFFF);
      }
    }
    __syncwarp();
    if (g[s] >= 0 && lane == __ffs(same[s]) - 1) next[warp][g[s]] += __popc(same[s]);
    __syncwarp();
  }
}

long long tiles_of(long long m) { return (m + kTile - 1) / kTile; }

template <int LIMBS>
int launch(const long long* k0, const long long* k1, const int32_t* packed, long long m,
           long long gpos0, Round rd, long long cap, long long* b0, long long* b1,
           long long* payload, long long* cursors, int* overflow, void* scratch,
           cudaStream_t s) {
  const long long tiles = tiles_of(m);
  auto* tile_first = static_cast<long long*>(scratch);
  auto* tile_counts = reinterpret_cast<int*>(tile_first + tiles * rd.G);
  const auto grid = static_cast<unsigned>(tiles);
  round_count_kernel<LIMBS><<<grid, kThreads, 0, s>>>(k0, k1, m, rd, tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  round_scan_kernel<<<rd.G, kScanThreads, 0, s>>>(tile_counts, tiles, rd.G, cap, tile_first,
                                                  cursors, overflow);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  round_scatter_kernel<LIMBS><<<grid, kThreads, 0, s>>>(k0, k1, packed, m, gpos0, rd, cap,
                                                        tile_first, b0, b1, payload);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rounds one launch appends into at most.
extern "C" int sz_round_max_rounds() { return kMaxRounds; }

// Rows per tile: the card's tests lay their rounds out across tiles by it.
extern "C" int sz_round_tile_rows() { return kTile; }

// Bytes of scratch sz_round_append takes for m rows and G rounds: an int64
// first row and an int32 count per tile and round.
extern "C" long long sz_round_scratch_bytes(long long m, int G) {
  return tiles_of(m) * G * 12;
}

// key0 (and key1, the low limb of two-limb keys, else null): m int64;
// packed: m int32; row i at global position gpos0 + i. 0 <= r0 < n_rounds
// < 2^31, 1 <= G <= sz_round_max_rounds(). buf0 (and buf1) and payload:
// [G, cap] int64, row-major; cursors: G int64, in and out; overflow: one
// int32, set to 1 on overflow and never cleared here; scratch:
// sz_round_scratch_bytes(m, G) bytes, 8-byte aligned. Returns
// cudaGetLastError() after the first launch that fails, else after the last.
extern "C" int sz_round_append(const void* key0, const void* key1, const void* packed,
                               long long m, long long gpos0, int r0, int n_rounds, int G,
                               long long cap, void* buf0, void* buf1, void* payload,
                               void* cursors, void* overflow, void* scratch, void* stream) {
  if (G < 1 || G > kMaxRounds || n_rounds < 1 || r0 < 0 || r0 >= n_rounds || cap < 0 ||
      gpos0 < 0 || (key1 == nullptr) != (buf1 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m <= 0) return 0;
  const Round rd{r0, static_cast<unsigned>(n_rounds), G};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k0 = static_cast<const long long*>(key0);
  const auto* k1 = static_cast<const long long*>(key1);
  const auto* pk = static_cast<const int32_t*>(packed);
  auto* b0 = static_cast<long long*>(buf0);
  auto* b1 = static_cast<long long*>(buf1);
  auto* pl = static_cast<long long*>(payload);
  auto* cur = static_cast<long long*>(cursors);
  auto* ovf = static_cast<int*>(overflow);
  if (k1 != nullptr) {
    return launch<2>(k0, k1, pk, m, gpos0, rd, cap, b0, b1, pl, cur, ovf, scratch, s);
  }
  return launch<1>(k0, k1, pk, m, gpos0, rd, cap, b0, b1, pl, cur, ovf, scratch, s);
}
