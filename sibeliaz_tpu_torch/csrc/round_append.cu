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
// below the card's integer rate for those bytes. The design moves each of
// those bytes once, in one launch (after a memset of the scratch):
//   1. A block takes the next tile of kTile = 4,096 rows (512 threads, 8
//      rows each: the fastest of the sweep over 2,048 to 8,192 rows and 8 or
//      16 rows a thread that PERF.md records) from a global counter
//      (never from blockIdx: the look-back below waits on earlier tiles, and
//      only this order guarantees that they are running or done). Each warp
//      owns kSteps x 32 consecutive rows, one per lane a step; it loads every
//      row's key limbs once (a step reads 256 contiguous bytes a limb),
//      stages them in shared memory in row order, and loads the word of each
//      kept row alone. Loads are scalar: the stage passes views from window
//      offset 1 on, which 16-byte loads would not take, and coalesced 8-byte
//      loads fill whole sectors all the same.
//   2. A stable multisplit by round inside the tile. Within a warp each kept
//      row is ranked among the warp's earlier rows of its round: the lanes of
//      one round find each other with __match_any_sync, the lowest adds their
//      number to the warp's count of the round in shared memory, and a lane's
//      rank is that count before the step plus the lanes of its round below
//      it. (The other way, ceil(log2 G) + 1 ballots ANDed under the lane mask,
//      the warp-level multisplit of Ashkiani et al., PPoPP 2016, measured
//      slower in 49 of the sweep's 50 cells, PERF.md.) A row is held in
//      registers as one 32-bit tag (rank, round) alone. Warp 0 turns the
//      warps' counts into each warp's first slot per round, rounds laid out
//      one after the other; each kept row's slot gets its tile-local row, so
//      each round's rows of the tile leave as one contiguous run, the keys
//      gathered from shared memory, with coalesced 8-byte stores.
//   3. A decoupled look-back (Merrill & Garland 2016) over one 64-bit status
//      word per (tile, round), round-major: flag (2 bits: aggregate or
//      inclusive) and value (62 bits), written and read whole with relaxed
//      loads and stores. One word carries all a reader needs, so no other
//      memory has to be ordered by it and no release or fence is paid; the
//      one pair of plain locations that the chain orders, the cursors (step
//      4), is read and written relaxed too, and relaxed accesses do not race.
//      Warp 0 publishes the tile's G aggregates as soon as the warps' counts
//      are in, and looks back for up to 32 rounds at a time: a round takes a
//      power of two of lanes, each reading kLookTiles earlier tiles a round
//      trip (128 tiles a round trip at G = 1, 16 at G = 8), backing off with
//      __nanosleep while a word it needs is empty. Only warp 0 looks back:
//      a look-back on every warp ran slower, its spinning slowing the tiles
//      it waited on. The value of tile 0's inclusive words holds the
//      round's cursor, so a tile's exclusive prefix is its first destination
//      row and no other tile reads the cursors.
//   4. The tile that takes the last counter index writes the cursors and
//      the overflow flag once its inclusive prefixes are known; nothing
//      else writes them. Tile 0's read of the cursors comes before that
//      write through the values of the look-back's chain.
// What the design does about the kernel it replaced (count, scan, scatter):
// one launch instead of three; the keys read once, not twice; no serial scan
// over the tiles; a round's rows of a tile leave as one run instead of a
// warp step's lanes spread over G buffers; a row held in registers as one
// 32-bit tag instead of its keys, round and word.
// What holds it: the look-back's wait for earlier tiles' aggregates, which
// no polling depth or back-off shortened, and a block's serial load, rank,
// look-back and store (PERF.md).
// Scratch: tiles x G status words and the tile counter, zeroed on the stream
// at each call (sz_round_scratch_bytes).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 4096;                  // rows per tile
constexpr int kSteps = 8;                    // rows per thread, one a warp step
constexpr int kThreads = kTile / kSteps;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 32 * kSteps;       // consecutive rows per warp
constexpr int kMaxRounds = 64;               // rounds per launch
constexpr long long kInvalidCanon = 1LL << 62;
constexpr u64 kMix = 0x9E3779B97F4A7C15ull;
constexpr u64 kMix2 = 0xC2B2AE3D27D4EB4Full;
constexpr unsigned kFull = 0xFFFFFFFFu;
// status word: flag in bits 0-1, the value in bits 2-63
constexpr u64 kFlagAggregate = 1, kFlagInclusive = 2;
constexpr int kLookTiles = 4;  // earlier tiles a look-back lane reads a round trip
static_assert(kTile % kSteps == 0 && kThreads % 32 == 0 && kThreads <= 1024 && kTile <= 65536,
              "whole warps, at most 1,024 threads, a tile-local row in 16 bits");

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

// Status words and the cursors are read and written relaxed: a status word
// carries its flag and value whole, and tile 0's read of the cursors comes
// before the last tile's write of them through the status words' values.
__device__ __forceinline__ u64 load_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One warp of tile `tile` > 0, for its rounds rbase .. rbase + nr - 1 (of
// G): each round's exclusive prefix over the tiles before it (the value of
// the nearest inclusive word plus the aggregates after it). A round takes
// `depth` lanes (a power of two, depth * nr <= 32), each reading kLookTiles
// consecutive earlier tiles a round trip; lane d of round j reads the tiles
// d * kLookTiles + k before the window's start. Returns the prefix on lane
// j < nr (of round rbase + j), with the round in *round (>= G: none).
__device__ u64 look_back(const u64* status, long long tiles, long long tile, int rbase, int nr,
                         int G, int lane, int* round) {
  int depth = 1;
  while (2 * depth * nr <= 32) depth *= 2;
  const int j = lane % nr, d = lane / nr;
  const int r = rbase + j;
  *round = r;
  unsigned group = 0;  // the lanes that read round r
  for (int k = 0; k < depth; ++k) group |= 1u << (k * nr);
  group <<= j;
  const u64* words = status + static_cast<long long>(r) * tiles;
  bool done = !(d < depth && r < G);
  u64 acc = 0;
  unsigned sleep_ns = 32;
  for (long long p = tile - 1 - static_cast<long long>(d) * kLookTiles;;
       p -= static_cast<long long>(depth) * kLookTiles) {
    u64 w[kLookTiles];
    int first;     // the lane's nearest inclusive word (kLookTiles: none)
    unsigned inc;  // the round's lanes that hold an inclusive word
    unsigned need;  // the round's lanes up to its nearest inclusive word
    for (;;) {
      // words before tile 0 read as an inclusive 0: tile 0 is inclusive,
      // so none of them is ever summed or waited on
#pragma unroll
      for (int k = 0; k < kLookTiles; ++k) {
        w[k] = (!done && p - k >= 0) ? load_relaxed(words + p - k) : kFlagInclusive;
      }
      first = kLookTiles;
      bool empty = false;  // an empty word at or before `first`
#pragma unroll
      for (int k = kLookTiles - 1; k >= 0; --k) {
        if ((w[k] & 3ull) == kFlagInclusive) first = k;
      }
#pragma unroll
      for (int k = 0; k < kLookTiles; ++k) empty = empty || (k <= first && (w[k] & 3ull) == 0);
      inc = __ballot_sync(kFull, first < kLookTiles) & group;
      need = inc ? (((inc & (0u - inc)) << 1) - 1u) & group : group;
      if (!__any_sync(kFull, !done && empty && ((need >> lane) & 1u))) break;
      __nanosleep(sleep_ns);  // back off: spinning warps slow the tiles they wait on
      sleep_ns = sleep_ns < 1024 ? 2 * sleep_ns : sleep_ns;
    }
    u64 v = 0;
    if (!done && ((need >> lane) & 1u)) {
#pragma unroll
      for (int k = 0; k < kLookTiles; ++k) v += k <= first ? w[k] >> 2 : 0;
    }
    for (int s = depth / 2; s > 0; s >>= 1) v += __shfl_down_sync(kFull, v, s * nr);
    v = __shfl_sync(kFull, v, j);  // the round's sum over the window
    if (!done) {
      acc += v;
      done = inc != 0;
    }
    if (__all_sync(kFull, done)) break;
  }
  return acc;
}

// key1, buf1 are null at LIMBS 1. Dynamic shared memory, kTile x (8 B a
// limb + 5 B): the tile's keys and word bits in row order, and its kept rows
// grouped by round as (row, round).
template <int LIMBS>
__global__ void __launch_bounds__(kThreads)
    round_append_kernel(const long long* __restrict__ k0, const long long* __restrict__ k1,
                        const int32_t* __restrict__ packed, long long m, long long gpos0,
                        Round rd, long long cap, long long* __restrict__ b0,
                        long long* __restrict__ b1, long long* __restrict__ payload,
                        long long* cursors, int* overflow, u64* status, unsigned* counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_key0 = reinterpret_cast<long long*>(smem);  // [kTile] a limb, row order
  long long* s_key1 = s_key0 + kTile;                       // LIMBS 2 only
  auto* s_w12 = reinterpret_cast<uint16_t*>(s_key0 + LIMBS * kTile);  // word & 0xFFF, row order
  auto* s_row = s_w12 + kTile;                              // a slot's row
  auto* s_round = reinterpret_cast<uint8_t*>(s_row + kTile);  // a slot's round
  __shared__ int s_first[kWarps][kMaxRounds];  // a warp's rows of a round, then its first slot
  __shared__ int s_off[kMaxRounds + 1];          // a round's first slot; [G]: the kept rows
  __shared__ int s_cnt[kMaxRounds];              // a round's rows of the tile
  __shared__ long long s_dst[kMaxRounds];        // a round's first destination row
  __shared__ unsigned s_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = rd.G;
  if (tid == 0) s_tile = atomicAdd(counter, 1u);
  for (int i = tid; i < kWarps * kMaxRounds; i += kThreads) (&s_first[0][0])[i] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kTile;
  const int row0 = warp * kWarpRows + lane;  // tile-local row of step 0

  // ---- 1. keys once, staged in row order; the words of kept rows ----
  int g[kSteps];
  {
    long long a[kSteps], b[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const long long i = base + row0 + s * 32;
      a[s] = i < m ? k0[i] : kInvalidCanon;
      b[s] = (LIMBS == 2 && i < m) ? k1[i] : 0;
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      g[s] = round_of<LIMBS>(a[s], b[s], rd);
      s_key0[row0 + s * 32] = a[s];
      if (LIMBS == 2) s_key1[row0 + s * 32] = b[s];
    }
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (g[s] >= 0) s_w12[row0 + s * 32] = packed[base + row0 + s * 32] & 0xFFF;
  }

  // ---- 2. rank each kept row among the warp's earlier rows of its round ----
  // tag: rank << 8 | round, or -1 (not kept)
  const unsigned below = (1u << lane) - 1u;
  int tag[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const unsigned same = __match_any_sync(kFull, g[s]);
    const int leader = __ffs(same) - 1;
    int before = 0;
    if (g[s] >= 0 && lane == leader) {
      before = s_first[warp][g[s]];
      s_first[warp][g[s]] = before + __popc(same);
    }
    const int rank = __shfl_sync(kFull, before, leader) + __popc(same & below);
    tag[s] = g[s] < 0 ? -1 : (rank << 8) | g[s];
    __syncwarp();
  }
  __syncthreads();

  // ---- 3. warp 0: the aggregates (tile 0: the inclusive words), slots ----
  const long long tiles = gridDim.x;
  const bool last = tile == tiles - 1;
  if (warp == 0) {
    int first[2][kWarps], cnt[2] = {0, 0};  // the tile's rows of rounds lane, lane + 32
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = lane + 32 * j;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        first[j][v] = cnt[j];
        cnt[j] += r < G ? s_first[v][r] : 0;
      }
      // publish first: later tiles wait on these words. Tile 0's inclusive
      // words hold the cursors.
      if (r < G) {
        if (tile == 0) {
          const auto ex =
              static_cast<long long>(load_relaxed(reinterpret_cast<const u64*>(cursors + r)));
          store_relaxed(status + r * tiles, (u64(ex + cnt[j]) << 2) | kFlagInclusive);
          s_dst[r] = ex;
        } else {
          store_relaxed(status + r * tiles + tile, (u64(cnt[j]) << 2) | kFlagAggregate);
        }
        s_cnt[r] = cnt[j];
      }
    }
    int x0 = cnt[0], x1 = cnt[1];  // inclusive scans over the rounds
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y0 = __shfl_up_sync(kFull, x0, d), y1 = __shfl_up_sync(kFull, x1, d);
      if (lane >= d) {
        x0 += y0;
        x1 += y1;
      }
    }
    const int sum0 = __shfl_sync(kFull, x0, 31);
    const int off[2] = {x0 - cnt[0], sum0 + x1 - cnt[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = lane + 32 * j;
      if (r < G) {
        s_off[r] = off[j];
#pragma unroll
        for (int v = 0; v < kWarps; ++v) s_first[v][r] = off[j] + first[j][v];
      }
    }
    if (lane == 31) s_off[G] = sum0 + x1;
  }
  __syncthreads();

  // ---- 4. each kept row's slot, grouped by round; look back ----
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (tag[s] >= 0) {
      const int r = tag[s] & 63;
      const int slot = s_first[warp][r] + (tag[s] >> 8);
      s_row[slot] = static_cast<uint16_t>(row0 + s * 32);
      s_round[slot] = static_cast<uint8_t>(r);
    }
  }
  if (tile > 0 && warp == 0) {  // one warp: spinning slows the others
    for (int rbase = 0; rbase < G; rbase += 32) {
      const int nr = G - rbase < 32 ? G - rbase : 32;
      int r;
      const u64 ex = look_back(status, tiles, tile, rbase, nr, G, lane, &r);
      if (lane < nr) {
        store_relaxed(status + r * tiles + tile, (u64(ex + s_cnt[r]) << 2) | kFlagInclusive);
        s_dst[r] = static_cast<long long>(ex);
      }
    }
  }
  __syncthreads();
  if (last && tid < G) {
    const long long inclusive = s_dst[tid] + s_cnt[tid];
    store_relaxed(reinterpret_cast<u64*>(cursors + tid), static_cast<u64>(inclusive));
    if (inclusive > cap) *overflow = 1;
  }

  // ---- 5. each round's rows of the tile as one run ----
  const int kept = s_off[G];
  for (int i = tid; i < kept; i += kThreads) {
    const int r = s_round[i];
    const long long dst = s_dst[r] - s_off[r] + i;
    if (dst < cap) {
      const int row = s_row[i];
      const long long at = r * cap + dst;
      b0[at] = s_key0[row];
      if (LIMBS == 2) b1[at] = s_key1[row];
      payload[at] = ((gpos0 + base + row) << 12) | s_w12[row];
    }
  }
}

long long tiles_of(long long m) { return (m + kTile - 1) / kTile; }

template <int LIMBS>
int launch(const long long* k0, const long long* k1, const int32_t* packed, long long m,
           long long gpos0, Round rd, long long cap, long long* b0, long long* b1,
           long long* payload, long long* cursors, int* overflow, void* scratch,
           cudaStream_t s) {
  constexpr int smem = kTile * (8 * LIMBS + 5);
  // set at every launch: the attributes belong to the current device's
  // context, and a host call costs little beside the kernel
  cudaError_t err = cudaFuncSetAttribute(round_append_kernel<LIMBS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {  // as many blocks an SM as shared memory holds
    err = cudaFuncSetAttribute(round_append_kernel<LIMBS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = tiles_of(m);
  auto* status = static_cast<u64*>(scratch);
  auto* counter = reinterpret_cast<unsigned*>(status + tiles * rd.G);
  err = cudaMemsetAsync(scratch, 0, (tiles * rd.G + 1) * 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  round_append_kernel<LIMBS><<<static_cast<unsigned>(tiles), kThreads, smem, s>>>(
      k0, k1, packed, m, gpos0, rd, cap, b0, b1, payload, cursors, overflow, status, counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rounds one launch appends into at most.
extern "C" int sz_round_max_rounds() { return kMaxRounds; }

// Rows per tile: the card's tests lay their rounds out across tiles by it.
extern "C" int sz_round_tile_rows() { return kTile; }

// Bytes of scratch sz_round_append takes for m rows and G rounds: a status
// word per tile and round, and the tile counter (one word).
extern "C" long long sz_round_scratch_bytes(long long m, int G) {
  return (tiles_of(m) * G + 1) * 8;
}

// key0 (and key1, the low limb of two-limb keys, else null): m int64;
// packed: m int32; row i at global position gpos0 + i. 0 <= r0 < n_rounds
// < 2^31, 1 <= G <= sz_round_max_rounds(), cursors + m < 2^61 (a status
// word holds them in 62 bits). buf0 (and buf1) and payload: [G, cap] int64,
// row-major; cursors: G int64, in and out; overflow: one int32, set to 1 on
// overflow and never cleared here; scratch: sz_round_scratch_bytes(m, G)
// bytes, 8-byte aligned, zeroed here. Returns cudaGetLastError() after the
// launch, or the first error before it.
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
