// K2 class_analysis: per-class junction verdict and class-first position over
// the key-sorted rows, for Hopper (sm_90a).
//
// Replaces the class analysis of sibeliaz_tpu/graph/construct.py::
// _v7_core_cummax2 (its cummax and reversed cummax, :469-510). A class is a
// run of equal adjacent keys; its OR is the bitwise OR of the verdict bits
// (0-3, 5-8, 10) of its valid rows' packed words; the class is a junction
// when that OR holds two or more right extensions (bits 0-3), two or more
// left extensions (bits 5-8) or a run boundary (bit 10). Rows of the
// invalid-window key (2^62) contribute nothing, so their class never is one.
// first[i] is the position at row i's class start row.
//
// What bounds it: device memory. The function needs 21 B per row, each byte
// once: key 8 + word 4 + position 4 in, flag 1 + first 4 out. The design
// moves each of them once, in one pass over tiles of T = 256 x 8 rows:
//   1. A block takes the next tile from a global counter (never from
//      blockIdx: the look-back below spins on earlier tiles, and only this
//      order guarantees that they are running or done). It loads the tile
//      with 16-byte loads, striped, turns keys and words into a 16-bit row
//      state (verdict bits, class-start flag) in shared memory, and reads the
//      states back blocked, 8 consecutive rows per thread. Besides the tile
//      it reads key[start - 1], key[end - 1] and key[end]: whether its head
//      class began in an earlier tile and whether its tail class runs on.
//   2. A forward segmented scan (thread, warp shuffles, warps through shared
//      memory) carries each class's OR and tile-local start row; the verdict
//      is taken at class end rows and spread back over the class by a
//      reverse segmented scan (ballots).
//   3. A decoupled look-back (Merrill & Garland 2016) over one 64-bit status
//      word per tile: flag (aggregate / inclusive), tail-runs-on bit, the OR
//      and the start row of the tile's tail class. A tile that holds a class
//      start publishes its inclusive word before looking back, so a
//      look-back stops at the first tile with a start; in a class that
//      spans hundreds of tiles, one warp reads 32 words a round trip. The
//      word is stored with st.release and read with ld.acquire, whole.
//   4. Every class that ends inside the tile gets its flags and first
//      positions; a tail class that runs past the tile gets its first
//      positions and flags of 0. The tile where a spanning class ends puts
//      its verdict into a slot of the tile where it started. A second, small
//      launch sets the flags of exactly those tail rows whose verdict is 1:
//      it reads one status word and one slot per tile.
// Scratch is n / T status words, n / T slots and the counter, zeroed on the
// stream at each call; sz_class_scratch_bytes gives its size.
// Two-limb keys (32 <= k <= 61, construct.py:466-476): a class starts where
// either limb changes, and a row is invalid where the high limb is 2^62.
// Keys are read in stage 1 alone, so the instance of two limbs differs from
// the one-limb instance only there: each compare takes both limbs, and the
// bound grows to 29 B per row.
// Tiles of 8 rows a thread measured fastest on the random, poly-A and strains
// rows; 4 pays twice the look-backs, 16 loses occupancy to registers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                  // consecutive rows per thread
constexpr int kTile = kThreads * kRows;   // rows per tile
constexpr long long kInvalidCanon = 1LL << 62;
constexpr uint32_t kVerdictBits = 0x5EFu;  // bits 0-3, 5-8, 10 of a word

// A row's state (16 bits): its verdict bits (bits 0-10; zero for an invalid
// row) and, at bit 11, whether it starts a class.
constexpr uint32_t kStart = 1u << 11;
// A scan value (32 bits): the OR (bits 0-10); bit 11 set when the span holds
// a class start; then bits 12-23 hold the tile-local row of the last start.
constexpr uint32_t kOrMask = 0x7FFu;
constexpr uint32_t kHas = kStart;

// Status word: flag (bits 0-1), tail runs on (bit 2), OR (bits 3-13), start
// row of the tail class (bits 32-62; inclusive words only).
constexpr unsigned long long kFlagAggregate = 1, kFlagInclusive = 2, kTailRunsOn = 4;

__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  return (b & kHas) ? b : (a | b);
}

__device__ __forceinline__ uint32_t row_value(uint32_t state, int row) {
  return (state & kStart) ? (state | (static_cast<uint32_t>(row) << 12)) : state;
}

__device__ __forceinline__ uint32_t verdict(uint32_t w) {
  return static_cast<uint32_t>(__popc(w & 0xFu) > 1) |
         static_cast<uint32_t>(__popc(w & 0x1E0u) > 1) | ((w >> 10) & 1u);
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(
    unsigned long long flag, bool tail_on, uint32_t or_bits, long long start) {
  return flag | (tail_on ? kTailRunsOn : 0ull) |
         (static_cast<unsigned long long>(or_bits & kOrMask) << 3) |
         (static_cast<unsigned long long>(start) << 32);
}

// One warp: the OR and start row of the class that runs into `tile`, from the
// words of the tiles before it (all lanes return the same). Each round reads
// the 32 words before the last, and ends at the nearest inclusive word once
// every word before it holds at least an aggregate.
__device__ void look_back(const unsigned long long* status, long long tile, int lane,
                          uint32_t* or_out, long long* start_out) {
  uint32_t acc = 0;
  for (long long p = tile - 1;; p -= 32) {
    const long long t = p - lane;
    unsigned long long w;
    unsigned inclusive, need;
    for (;;) {
      w = t >= 0 ? load_acquire(status + t) : kFlagInclusive;
      const unsigned empty = __ballot_sync(0xffffffffu, (w & 3ull) == 0);
      inclusive = __ballot_sync(0xffffffffu, (w & 3ull) == kFlagInclusive);
      // lanes up to the nearest inclusive word (all lanes if none)
      need = inclusive ? ((inclusive & (0u - inclusive)) << 1) - 1u : 0xffffffffu;
      if (!(empty & need)) break;
    }
    uint32_t part = ((need >> lane) & 1u) ? static_cast<uint32_t>(w >> 3) & kOrMask : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) part |= __shfl_xor_sync(0xffffffffu, part, d);
    acc |= part;
    if (inclusive) {
      const unsigned long long src =
          __shfl_sync(0xffffffffu, w, __ffs(inclusive) - 1);
      *or_out = acc;
      *start_out = static_cast<long long>(src >> 32);
      return;
    }
  }
}

// key1 is null at LIMBS 1.
template <int LIMBS, bool VEC>
__global__ void __launch_bounds__(kThreads)
class_tile_kernel(const long long* __restrict__ key0, const long long* __restrict__ key1,
                  const int32_t* __restrict__ packed,
                  const int32_t* __restrict__ pos, long long n,
                  uint8_t* __restrict__ junction, int32_t* __restrict__ first,
                  unsigned long long* status, uint8_t* slot, unsigned int* counter) {
  constexpr int R = kRows, T = kTile;
  constexpr int Q = R / 4;  // quads of rows per thread, striped
  __shared__ __align__(16) uint16_t s_state[T + 8];  // [T]: does row `end` start a class
  __shared__ __align__(16) int32_t s_pos[T];          // positions, then first
  __shared__ long long s_last[LIMBS][T / 4];         // last key of each quad
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_rev[kWarps];
  __shared__ long long s_prev_key[LIMBS];
  __shared__ long long s_tile, s_head_start;
  __shared__ uint32_t s_head_or;
  __shared__ int32_t s_head_first;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * T;

  // ---- 1. load striped (quad q = rows 4q..4q+3), stage the row states ----
  auto keys = [&](int l) { return l == 0 ? key0 : key1; };  // l is known at compile time
  if (tid == 0 && base > 0) {
#pragma unroll
    for (int l = 0; l < LIMBS; ++l) s_prev_key[l] = keys(l)[base - 1];
  }
  if (tid == kThreads - 1) {
    bool on = base + T < n;
#pragma unroll
    for (int l = 0; l < LIMBS; ++l) on = on && keys(l)[base + T] == keys(l)[base + T - 1];
    s_state[T] = on ? 0 : static_cast<uint16_t>(kStart);
  }
  long long k0[LIMBS][Q];
  uint32_t st01[Q], st23[Q];
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    const int q = tid + m * kThreads;
    const long long r0 = base + 4LL * q;
    long long k[LIMBS][4];
    int32_t w[4], p[4];
    if (VEC && r0 + 3 < n) {
#pragma unroll
      for (int l = 0; l < LIMBS; ++l) {
        const longlong2 a = *reinterpret_cast<const longlong2*>(keys(l) + r0);
        const longlong2 b = *reinterpret_cast<const longlong2*>(keys(l) + r0 + 2);
        k[l][0] = a.x; k[l][1] = a.y; k[l][2] = b.x; k[l][3] = b.y;
      }
      const int4 wv = *reinterpret_cast<const int4*>(packed + r0);
      const int4 pv = *reinterpret_cast<const int4*>(pos + r0);
      w[0] = wv.x; w[1] = wv.y; w[2] = wv.z; w[3] = wv.w;
      p[0] = pv.x; p[1] = pv.y; p[2] = pv.z; p[3] = pv.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = r0 + j < n;
#pragma unroll
        for (int l = 0; l < LIMBS; ++l) k[l][j] = in ? keys(l)[r0 + j] : 0;
        w[j] = in ? packed[r0 + j] : 0;
        p[j] = in ? pos[r0 + j] : 0;
      }
    }
    uint32_t s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = k[0][j] != kInvalidCanon ? static_cast<uint32_t>(w[j]) & kVerdictBits : 0u;
      bool differs = false;
#pragma unroll
      for (int l = 0; l < LIMBS; ++l) differs = differs || (j > 0 && k[l][j] != k[l][j - 1]);
      if (differs) s[j] |= kStart;
      if (r0 + j >= n) s[j] = kStart;  // past the end: rows of their own
    }
#pragma unroll
    for (int l = 0; l < LIMBS; ++l) {
      k0[l][m] = k[l][0];
      s_last[l][q] = k[l][3];
    }
    st01[m] = s[0] | (s[1] << 16);
    st23[m] = s[2] | (s[3] << 16);
    *reinterpret_cast<int4*>(s_pos + 4 * q) = make_int4(p[0], p[1], p[2], p[3]);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    const int q = tid + m * kThreads;
    const long long r0 = base + 4LL * q;
    bool differs = false;
#pragma unroll
    for (int l = 0; l < LIMBS; ++l) {
      differs = differs || (q > 0 ? s_last[l][q - 1] : s_prev_key[l]) != k0[l][m];
    }
    if (r0 == 0 || r0 >= n || differs) st01[m] |= kStart;
    *reinterpret_cast<uint2*>(s_state + 4 * q) = make_uint2(st01[m], st23[m]);
  }
  __syncthreads();

  // ---- 2. blocked: rows tid*R .. tid*R + R-1; forward segmented scan ----
  const uint4 sx = *reinterpret_cast<const uint4*>(s_state + tid * R);
  const uint32_t sw[R / 2] = {sx.x, sx.y, sx.z, sx.w};
  const uint32_t next_state = s_state[tid * R + R];
  auto state = [&](int r) { return (sw[r >> 1] >> (16 * (r & 1))) & 0xFFFFu; };

  uint32_t agg = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) agg = combine(agg, row_value(state(r), tid * R + r));
  uint32_t inc = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc = combine(o, inc);
  }
  uint32_t excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0;
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  uint32_t prefix = 0, tile_agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) prefix = tile_agg;
    tile_agg = combine(tile_agg, s_warp[w]);
  }
  prefix = combine(prefix, excl);

  // ---- 3. publish, and look back for the head class ----
  const bool head = !(s_state[0] & kStart);  // the first row continues a class
  if (warp == 0) {
    const bool tail_on = !(s_state[T] & kStart);
    if (lane == 0) {
      store_release(status + tile,
                    (tile_agg & kHas)
                        ? status_word(kFlagInclusive, tail_on, tile_agg,
                                      base + (tile_agg >> 12))
                        : status_word(kFlagAggregate, tail_on, tile_agg, 0));
    }
    if (head) {
      uint32_t head_or;
      long long head_start;
      look_back(status, tile, lane, &head_or, &head_start);
      if (lane == 0) {
        if (!(tile_agg & kHas)) {
          store_release(status + tile, status_word(kFlagInclusive, tail_on,
                                                   head_or | tile_agg, head_start));
        }
        s_head_or = head_or;
        s_head_start = head_start;
        s_head_first = pos[head_start];
      }
    }
  }
  __syncthreads();

  // ---- 4. verdicts at class ends, first positions ----
  const uint32_t head_or = head ? s_head_or : 0u;
  const int32_t head_first = head ? s_head_first : 0;
  uint32_t x = prefix, ends = 0, verdicts = 0;
  int32_t fst[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x = combine(x, row_value(state(r), tid * R + r));
    const bool has = x & kHas;
    fst[r] = has ? s_pos[x >> 12] : head_first;
    const uint32_t nx = r + 1 < R ? state(r + 1) : next_state;
    if (nx & kStart) {  // the row ends its class
      const uint32_t v = verdict(has ? x : (x | head_or));
      ends |= 1u << r;
      verdicts |= v << r;
      // the head class, begun in an earlier tile, ends here
      if (!has) slot[s_head_start / T] = static_cast<uint8_t>(v);
    }
  }
  // reverse segmented scan: each row takes the verdict of the nearest end at
  // or after it; rows of a tail class that runs on take 0 (see the fix-up)
  const uint32_t first_v = ends ? (verdicts >> (__ffs(ends) - 1)) & 1u : 0u;
  const unsigned wend = __ballot_sync(0xffffffffu, ends != 0);
  const unsigned wver = __ballot_sync(0xffffffffu, first_v != 0);
  if (lane == 0) s_rev[warp] = wend ? 2u | ((wver >> (__ffs(wend) - 1)) & 1u) : 0u;
  __syncthreads();  // also: every read of s_pos is done
  const unsigned later = lane == 31 ? 0u : wend & (0xffffffffu << (lane + 1));
  uint32_t cur = 0;
  if (later) {
    cur = (wver >> (__ffs(later) - 1)) & 1u;
  } else {
    for (int w = warp + 1; w < kWarps; ++w) {
      if (s_rev[w]) {
        cur = s_rev[w] & 1u;
        break;
      }
    }
  }
  uint32_t jb[R / 4];
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    if ((ends >> r) & 1u) cur = (verdicts >> r) & 1u;
    if ((r & 3) == 3) jb[r >> 2] = 0;
    jb[r >> 2] |= cur << (8 * (r & 3));
  }

  // ---- 5. write: flags straight from registers, first through shared ----
  const long long row0 = base + static_cast<long long>(tid) * R;
  if (row0 + R <= n) {
    *reinterpret_cast<uint2*>(junction + row0) = make_uint2(jb[0], jb[1]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r < n) junction[row0 + r] = static_cast<uint8_t>((jb[r >> 2] >> (8 * (r & 3))) & 1u);
    }
  }
#pragma unroll
  for (int v = 0; v < R / 4; ++v) {
    *reinterpret_cast<int4*>(s_pos + tid * R + 4 * v) =
        make_int4(fst[4 * v], fst[4 * v + 1], fst[4 * v + 2], fst[4 * v + 3]);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    const int q = tid + m * kThreads;
    const long long r0 = base + 4LL * q;
    const int4 f = *reinterpret_cast<const int4*>(s_pos + 4 * q);
    if (r0 + 3 < n) {
      *reinterpret_cast<int4*>(first + r0) = f;
    } else {
      const int32_t fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r0 + j < n) first[r0 + j] = fv[j];
      }
    }
  }
}

// One warp per tile: a tile whose tail class runs on sets that class's rows in
// the tile to its verdict, when the verdict is 1 (the tile wrote 0).
__global__ void class_fixup_kernel(const unsigned long long* __restrict__ status,
                                   const uint8_t* __restrict__ slot, long long tiles,
                                   uint8_t* __restrict__ junction) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long t = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
       t < tiles; t += warps) {
    const unsigned long long w = status[t];
    if (!(w & kTailRunsOn)) continue;
    const long long start = static_cast<long long>(w >> 32);
    if (!slot[start / kTile]) continue;
    // the class's rows in the tile: bytes up to a 16-byte boundary, then
    // 16 bytes a store (a tile's end is a multiple of 16 rows)
    const long long lo = start > t * kTile ? start : t * kTile;
    const long long hi = (t + 1) * kTile;
    const long long mid = (lo + 15) & ~15LL;
    if (lane < mid - lo) junction[lo + lane] = 1;
    uint4* v = reinterpret_cast<uint4*>(junction + mid);
    const uint4 ones = make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
    for (long long i = lane; i < (hi - mid) / 16; i += 32) v[i] = ones;
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

template <int LIMBS>
void launch(const long long* k0, const long long* k1, const int32_t* packed,
            const int32_t* pos, long long n, uint8_t* jn, int32_t* fs,
            unsigned long long* status, uint8_t* slot, unsigned int* counter, bool vec,
            unsigned grid, cudaStream_t s) {
  if (vec) {
    class_tile_kernel<LIMBS, true><<<grid, kThreads, 0, s>>>(k0, k1, packed, pos, n, jn, fs,
                                                             status, slot, counter);
  } else {
    class_tile_kernel<LIMBS, false><<<grid, kThreads, 0, s>>>(k0, k1, packed, pos, n, jn, fs,
                                                              status, slot, counter);
  }
}

}  // namespace

// Rows per tile: the card's tests lay their class runs out by it.
extern "C" int sz_class_tile_rows() { return kTile; }

// Bytes of scratch sz_class_analysis takes for n rows: a status word per
// tile, the tile counter (one word) and a verdict byte per tile.
extern "C" long long sz_class_scratch_bytes(long long n) {
  return (tiles_of(n) + 1) * 8 + tiles_of(n);
}

// key0_s int64 (and key1_s, the low limb of two-limb keys, else null),
// packed_s and pos_s int32: n rows; junction: n uint8 out; first: n int32 out
// (both 16-byte aligned); scratch: sz_class_scratch_bytes(n) bytes, 8-byte
// aligned, zeroed here. Returns cudaGetLastError().
extern "C" int sz_class_analysis(const void* key0_s, const void* key1_s, const void* packed_s,
                                 const void* pos_s, long long n, void* junction,
                                 void* first, void* scratch, void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long tiles = tiles_of(n);
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* counter = reinterpret_cast<unsigned int*>(status + tiles);
  auto* slot = reinterpret_cast<uint8_t*>(status + tiles + 1);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sz_class_scratch_bytes(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = ((reinterpret_cast<uintptr_t>(key0_s) | reinterpret_cast<uintptr_t>(key1_s) |
                     reinterpret_cast<uintptr_t>(packed_s) | reinterpret_cast<uintptr_t>(pos_s)) &
                    15) == 0;
  const auto* k0 = static_cast<const long long*>(key0_s);
  const auto* k1 = static_cast<const long long*>(key1_s);
  const auto* packed = static_cast<const int32_t*>(packed_s);
  const auto* pos = static_cast<const int32_t*>(pos_s);
  auto* jn = static_cast<uint8_t*>(junction);
  auto* fs = static_cast<int32_t*>(first);
  const auto grid = static_cast<unsigned>(tiles);
  if (k1 != nullptr) {
    launch<2>(k0, k1, packed, pos, n, jn, fs, status, slot, counter, vec, grid, s);
  } else {
    launch<1>(k0, k1, packed, pos, n, jn, fs, status, slot, counter, vec, grid, s);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  class_fixup_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), kThreads, 0, s>>>(
      status, slot, tiles, jn);
  return static_cast<int>(cudaGetLastError());
}
