// K1 front_half: the per-position front half of junction enumeration, for
// Hopper (sm_90a).
//
// Replaces sibeliaz_tpu/graph/pallas_kernels.py::canon_packed (the Pallas
// kernel) together with the XLA program it fuses,
// sibeliaz_tpu/graph/construct.py::_prepare_packed with unpack_codes_device,
// _windowed_all and _doubling_codes (one limb, k <= 31) or _doubling_codes2
// (two limbs, 32 <= k <= 61; see the end of this note).
//
// For every position p of the separator-joined genome it emits
//   key[p]    = min(fwd, rc) of the k-window at p, or 2^62 where the window
//               is not all ACGT or runs past the end (sorts after every code,
//               since 4^31 - 1 < 2^62);
//   packed[p] = bits 0-4 right-extension presence (bit 4 = none),
//               bits 5-9 left-extension presence, bit 10 run boundary,
//               bit 11 forward orientation is canonical.
// Windows past the end read the sequence cyclically, as the rolls of the XLA
// form do, so bit 11 of an invalid window is the same in both.
//
// What bounds it: device memory. The function needs 12.375 B per position,
// each byte once: 0.25 B of 2-bit codes and 0.125 B of validity map in, an
// int64 key and an int32 word out; about 30 32-bit operations per position
// at any k are far below the card's rate for those bytes. So the design
// keeps every per-position step independent of k and few:
//   1. A block owns a tile of kTile positions. It stages the tile's codes and
//      validity bits, with a halo of kHalo positions on each side, into shared
//      memory as words of 32 positions: one 8-byte load of codes and one
//      4-byte load of validity map per word, each input byte read once per
//      block. Code bits under positions that are not definite are zeroed
//      there (a hand-made codes2 may carry any bits under an N), and a third
//      word per 32 positions says which windows are all definite (an AND of
//      the validity bits over k, by doubling: log2 k steps a word).
//   2. A window is bits [2p, 2p + 2k) of that stream, the first base lowest:
//      one funnel shift over two 64-bit words. rc is its complement; fwd is
//      its bit-pair reversal (__brevll, then a swap inside each pair) shifted
//      down to 2k bits. Each lane takes two neighbouring positions a step;
//      the second window is the first moved on by one base (a shift and an
//      OR each). The validity of the windows at p - 1, p and p + 1 is one
//      funnel shift of the staged window bits; the extension codes at p - 1
//      and p + k are read on their own.
//   3. A warp owns 32 x kPositions consecutive positions: keys go out as
//      16-byte stores, lane by lane; the packed words go through a per-warp
//      buffer in shared memory and out as 16-byte stores, lane by lane; both
//      with the streaming hint (the outputs are not read again here).
//   4. Tiles whose halo and windows lie inside [0, n) skip every edge test.
//      The first tile and the tiles at the end stage position by position,
//      reading cyclically (warp ballots assemble the words), and the last
//      stores with bounds checks. No load reads past ceil(n/4) bytes of
//      codes2 or ceil(n/8) of nmask.
//   5. Inputs whose pointers are off 8- (codes2) or 4-byte (nmask) alignment
//      (views at a storage offset) take an instance with byte loads.
// Two limbs (32 <= k <= 61), as construct._doubling_codes2 and the wide
// branch of _prepare_packed: the key is (hi, lo) in base 2^62, compared
// lexicographically, lo the last 31 bases and hi the first k - 31. One more
// funnel shift at bit 2p + 62 gives the high limb of rc, one more at the
// window's 31st-last base the low limb of fwd; the slide carries a pair
// across the limbs; the halo is 64 positions, and window validity ANDs a
// run of 32 with a run of k - 32 that starts 32 positions on. An invalid
// window's key is (2^62, 0). The instance writes 20 B a position (two int64
// limbs and the word), so the bound grows to 20.375 B a position; it takes
// 62 registers, at least 4 blocks an SM.
// Measured choices (chip_smoke.py --k1-time): 8 positions a thread against
// 2, 4 and 16; each of the slide, the edge-free interior tiles, the staged
// window bits and the streaming stores paid; at least 6 blocks an SM (40
// registers) beat the compiler's 54 and a forced 32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPositions = 8;                  // positions per thread
constexpr int kTile = kThreads * kPositions;   // positions per block
constexpr int kNoExt = 4;
constexpr long long kInvalidCanon = 1LL << 62;
constexpr u64 kLimbMask = (1ull << 62) - 1;      // a limb: 31 bases
constexpr u64 kLowBits = 0x5555555555555555ull;  // the low bit of every pair

// The tile of an instance of LIMBS limbs: kHalo staged positions on each
// side (>= the largest k + 1), in words of 32 positions.
template <int LIMBS>
struct Shape {
  static constexpr int kMaxK = LIMBS == 1 ? 31 : 61;
  static constexpr int kHalo = 32 * LIMBS;
  static constexpr int kSpan = kTile + 2 * kHalo;
  static constexpr int kWords = kSpan / 32;
};

// The staged tile: word j holds positions b0 - kHalo + 32 j .. + 31.
template <int LIMBS>
struct Staged {
  u64 code[Shape<LIMBS>::kWords];      // 2-bit codes, 0 where not definite
  uint32_t def[Shape<LIMBS>::kWords];  // definite
  uint32_t win[Shape<LIMBS>::kWords];  // the k-window starting there is all definite
};

// bit i of x to bit 2i
__device__ __forceinline__ u64 spread(uint32_t x) {
  u64 v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  return (v | (v << 1)) & kLowBits;
}

// Bit i: bits i .. i + k - 1 of x all set, for i < 32 (k <= 32).
__device__ __forceinline__ uint32_t runs_of(u64 x, int k) {
  u64 res = ~0ull, cur = x;
  int sh = 0;
  for (int b = 0; (1 << b) <= k; ++b) {
    if ((k >> b) & 1) {
      res &= cur >> sh;
      sh += 1 << b;
    }
    cur &= cur >> (1 << b);
  }
  return static_cast<uint32_t>(res);
}

// The 64 bits of the staged stream from bit `off` on (a funnel shift).
__device__ __forceinline__ u64 bits_at(const u64* words, int off) {
  const int i = off >> 6, s = off & 63;
  return (words[i] >> s) | ((words[i + 1] << 1) << (63 - s));
}

// The 2-bit pairs of x in reverse order: pair i to pair 31 - i.
__device__ __forceinline__ u64 pair_reverse(u64 x) {
  const u64 r = __brevll(x);
  return ((r >> 1) & kLowBits) | ((r & kLowBits) << 1);
}

template <int LIMBS>
__device__ __forceinline__ int code_at(const Staged<LIMBS>& t, int q) {
  return static_cast<int>(t.code[q >> 5] >> (2 * (q & 31))) & 3;
}

template <bool VEC>
__device__ __forceinline__ u64 load_u64(const uint8_t* p, long long word) {
  if (VEC) return __ldg(reinterpret_cast<const u64*>(p) + word);
  u64 v = 0;
  for (int b = 0; b < 8; ++b) v |= static_cast<u64>(__ldg(p + 8 * word + b)) << (8 * b);
  return v;
}

template <bool VEC>
__device__ __forceinline__ uint32_t load_u32(const uint8_t* p, long long word) {
  if (VEC) return __ldg(reinterpret_cast<const uint32_t*>(p) + word);
  uint32_t v = 0;
  for (int b = 0; b < 4; ++b) v |= static_cast<uint32_t>(__ldg(p + 4 * word + b)) << (8 * b);
  return v;
}

// A window's forward and reverse-complement codes as (hi, lo) limbs; with
// one limb, hi is 0 and lo the whole code.
struct Win {
  u64 fh, fl, rh, rl;
};

// The window codes of the staged position sp.
template <int LIMBS>
__device__ __forceinline__ Win window(const Staged<LIMBS>& t, int sp, int k) {
  Win w;
  if constexpr (LIMBS == 1) {
    const u64 m2k = (1ull << (2 * k)) - 1;
    const u64 bits = bits_at(t.code, 2 * sp) & m2k;  // sum of c_i 4^i
    w.fh = w.rh = 0;
    w.rl = ~bits & m2k;
    w.fl = pair_reverse(bits) >> (64 - 2 * k);
  } else {
    const int h = k - 31;  // bases in the high limb
    const u64 first = bits_at(t.code, 2 * sp);  // bases 0 .. 31 of the window
    w.rl = ~first & kLimbMask;                                         // bases 0 .. 30
    w.rh = ~bits_at(t.code, 2 * sp + 62) & ((1ull << (2 * h)) - 1);    // bases 31 .. k-1
    w.fh = pair_reverse(first) >> (64 - 2 * h);                        // bases 0 .. h-1
    w.fl = pair_reverse(bits_at(t.code, 2 * (sp + h))) >> 2;           // bases h .. k-1
  }
  return w;
}

// The window one base on, c the code of the base that enters.
template <int LIMBS>
__device__ __forceinline__ void slide(Win& w, u64 c, int k) {
  if constexpr (LIMBS == 1) {
    w.fl = ((w.fl << 2) | c) & ((1ull << (2 * k)) - 1);
    w.rl = (w.rl >> 2) | ((3 - c) << (2 * k - 2));
  } else {
    const int h = k - 31;
    w.fh = ((w.fh << 2) | (w.fl >> 60)) & ((1ull << (2 * h)) - 1);
    w.fl = ((w.fl << 2) | c) & kLimbMask;
    w.rl = (w.rl >> 2) | ((w.rh & 3) << 60);
    w.rh = (w.rh >> 2) | ((3 - c) << (2 * h - 2));
  }
}

// key[0] the high limb (the only one at LIMBS 1), key[1] the low limb.
template <int LIMBS>
struct Out {
  long long key[LIMBS];
  int32_t word;
};

// The keys and packed word of position p at staged position sp, given its
// window's codes. EDGE false: p - 1, the windows at p - 1 .. p + 1 and the
// position after each lie inside [0, n).
template <int LIMBS, bool EDGE>
__device__ __forceinline__ Out<LIMBS> finish(const Staged<LIMBS>& t, int sp, long long p,
                                             long long n, int k, const Win& w) {
  const int sq = sp - 1;
  const uint32_t w3 = __funnelshift_r(t.win[sq >> 5], t.win[(sq >> 5) + 1], sq & 31);
  const bool valid = (w3 & 2) && (!EDGE || p + k <= n);
  const bool prev_valid = (w3 & 1) && (!EDGE || (p >= 1 && p - 1 + k <= n));
  const bool next_valid = (w3 & 4) && (!EDGE || p + 1 + k <= n);
  const bool boundary = valid && !(prev_valid && next_valid);

  const bool positive = LIMBS == 1 ? w.fl < w.rl : (w.fh < w.rh || (w.fh == w.rh && w.fl < w.rl));
  const int sk = sp + k;
  const bool nxt_ok = ((t.def[sk >> 5] >> (sk & 31)) & 1) && (!EDGE || p + k < n);
  const bool prv_ok = ((t.def[sq >> 5] >> (sq & 31)) & 1) && (!EDGE || p >= 1);
  const int nxt = code_at(t, sk), prv = code_at(t, sq);
  const int right = positive ? (nxt_ok ? nxt : kNoExt) : (prv_ok ? 3 - prv : kNoExt);
  const int left = positive ? (prv_ok ? prv : kNoExt) : (nxt_ok ? 3 - nxt : kNoExt);
  Out<LIMBS> o;
  o.word = (1 << right) | (1 << (left + 5)) | (int(boundary) << 10) | (int(positive) << 11);
  if constexpr (LIMBS == 1) {
    o.key[0] = valid ? static_cast<long long>(positive ? w.fl : w.rl) : kInvalidCanon;
  } else {
    o.key[0] = valid ? static_cast<long long>(positive ? w.fh : w.rh) : kInvalidCanon;
    o.key[1] = valid ? static_cast<long long>(positive ? w.fl : w.rl) : 0;
  }
  return o;
}

// A warp's 32 x kPositions positions from tile-local position `region` on,
// of a tile that lies inside [0, n): two neighbouring positions a lane a
// step, keys stored from registers, packed words through the warp's buffer.
template <int LIMBS, bool EDGE>
__device__ __forceinline__ void warp_out(const Staged<LIMBS>& t, long long b0, int region,
                                         int lane, long long n, int k,
                                         long long* __restrict__ key0,
                                         long long* __restrict__ key1,
                                         int32_t* __restrict__ packed, int2* wbuf) {
  for (int s = 0; s < kPositions / 2; ++s) {
    const int lp = region + 2 * (s * 32 + lane);  // tile-local
    const int sp = Shape<LIMBS>::kHalo + lp;      // staged
    Win w = window(t, sp, k);
    const Out<LIMBS> a = finish<LIMBS, EDGE>(t, sp, b0 + lp, n, k, w);
    slide<LIMBS>(w, code_at(t, sp + k), k);  // the next window: one base on
    const Out<LIMBS> b = finish<LIMBS, EDGE>(t, sp + 1, b0 + lp + 1, n, k, w);
    __stcs(reinterpret_cast<longlong2*>(key0 + b0 + lp), make_longlong2(a.key[0], b.key[0]));
    if constexpr (LIMBS == 2) {
      __stcs(reinterpret_cast<longlong2*>(key1 + b0 + lp), make_longlong2(a.key[1], b.key[1]));
    }
    wbuf[s * 32 + lane] = make_int2(a.word, b.word);
  }
  __syncwarp();
  const int4* w4 = reinterpret_cast<const int4*>(wbuf);
  int4* out = reinterpret_cast<int4*>(packed + b0 + region);
  for (int c = lane; c < 8 * kPositions; c += 32) __stcs(out + c, w4[c]);
}

// key1 is null at LIMBS 1.
template <int LIMBS, bool VEC>
__global__ void __launch_bounds__(kThreads, LIMBS == 1 ? 6 : 4)
front_half_kernel(const uint8_t* __restrict__ codes2, const uint8_t* __restrict__ nmask,
                  long long n, int k, long long* __restrict__ key0,
                  long long* __restrict__ key1, int32_t* __restrict__ packed) {
  using S = Shape<LIMBS>;
  __shared__ Staged<LIMBS> t;
  __shared__ __align__(16) int2 wbuf[kWarps][16 * kPositions];  // two words a lane a step

  const long long b0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long base = b0 - S::kHalo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool interior = base >= 0 && b0 + kTile + S::kHalo <= n;
  if (interior) {
    if (tid < S::kWords) {
      const long long w = base / 32 + tid;
      const uint32_t d = load_u32<VEC>(nmask, w);
      t.code[tid] = load_u64<VEC>(codes2, w) & (spread(d) * 3);
      t.def[tid] = d;
    }
  } else {
    // whole warps: kSpan is a multiple of 32
    for (int j = tid; j < S::kSpan; j += kThreads) {
      long long q = (base + j) % n;
      if (q < 0) q += n;
      const int d = (nmask[q >> 3] >> (q & 7)) & 1;
      const int c = d ? (codes2[q >> 2] >> ((q & 3) * 2)) & 3 : 0;
      const uint32_t bd = __ballot_sync(~0u, d);
      const uint32_t lo = __ballot_sync(~0u, c & 1);
      const uint32_t hi = __ballot_sync(~0u, c >> 1);
      if (lane == 0) {
        t.code[j >> 5] = spread(lo) | (spread(hi) << 1);
        t.def[j >> 5] = bd;
      }
    }
  }
  __syncthreads();
  // the last words' windows run past the span; only the first of the words
  // after the tile is read, and it ends inside the span
  if (tid < S::kWords) {
    const u64 next = tid + 1 < S::kWords ? t.def[tid + 1] : 0;
    if constexpr (LIMBS == 1) {
      t.win[tid] = runs_of(t.def[tid] | (next << 32), k);
    } else {
      const u64 next2 = tid + 2 < S::kWords ? t.def[tid + 2] : 0;
      t.win[tid] = runs_of(t.def[tid] | (next << 32), 32) & runs_of(next | (next2 << 32), k - 32);
    }
  }
  __syncthreads();

  const int region = warp * 32 * kPositions;  // tile-local first position of this warp
  if (b0 + kTile <= n) {
    if (interior) {
      warp_out<LIMBS, false>(t, b0, region, lane, n, k, key0, key1, packed, wbuf[warp]);
    } else {
      warp_out<LIMBS, true>(t, b0, region, lane, n, k, key0, key1, packed, wbuf[warp]);
    }
    return;
  }
  for (int i = 0; i < kPositions; ++i) {
    const int lp = region + 32 * i + lane;
    const long long p = b0 + lp;
    if (p >= n) break;
    const Out<LIMBS> o =
        finish<LIMBS, true>(t, S::kHalo + lp, p, n, k, window(t, S::kHalo + lp, k));
    key0[p] = o.key[0];
    if constexpr (LIMBS == 2) key1[p] = o.key[1];
    packed[p] = o.word;
  }
}

template <int LIMBS>
void launch(const uint8_t* c, const uint8_t* m, long long n, int k, long long* key0,
            long long* key1, int32_t* pk, bool vec, cudaStream_t s) {
  const auto grid = static_cast<unsigned>((n + kTile - 1) / kTile);
  if (vec) {
    front_half_kernel<LIMBS, true><<<grid, kThreads, 0, s>>>(c, m, n, k, key0, key1, pk);
  } else {
    front_half_kernel<LIMBS, false><<<grid, kThreads, 0, s>>>(c, m, n, k, key0, key1, pk);
  }
}

}  // namespace

// Positions per tile: the card's tests lay their N runs out by it.
extern "C" int sz_front_half_tile_positions() { return kTile; }

// codes2: ceil(n/4) bytes of 2-bit codes, four per byte, low bits first;
// nmask: ceil(n/8) bytes of definiteness, eight per byte, low bit first (any
// alignment); key0 (and key1): n int64 and packed: n int32, all 16-byte
// aligned. 1 <= k <= 61: k <= 31 writes one key limb into key0 (key1 null),
// 32 <= k <= 61 the high limb into key0 and the low into key1 (k = 62 would
// let the high limb reach 2^62, the invalid key). Returns cudaGetLastError().
extern "C" int sz_front_half(const void* codes2, const void* nmask, long long n, int k,
                             void* key0, void* key1, void* packed, void* stream) {
  if (n <= 0) return 0;
  const bool wide = k > Shape<1>::kMaxK;
  if (k < 1 || k > Shape<2>::kMaxK || wide != (key1 != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes2);
  const auto* m = static_cast<const uint8_t*>(nmask);
  auto* k0 = static_cast<long long*>(key0);
  auto* k1 = static_cast<long long*>(key1);
  auto* pk = static_cast<int32_t*>(packed);
  const bool vec = ((reinterpret_cast<uintptr_t>(codes2) & 7) |
                    (reinterpret_cast<uintptr_t>(nmask) & 3)) == 0;
  if (wide) {
    launch<2>(c, m, n, k, k0, k1, pk, vec, s);
  } else {
    launch<1>(c, m, n, k, k0, nullptr, pk, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
