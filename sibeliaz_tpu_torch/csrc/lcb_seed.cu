// K8 lcb_seed: the fused LCB engine's seeding of one lane set, K7
// lcb_step's whole starting carry in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package seeds a lane set with an XLA
// program (sibeliaz_tpu/lcb/resident.py::_seed_lanes_device_impl, then
// batched_push_device.seed_state's copies and fused.py::_init_carry).  Its
// plain version is lcb/step.py's lcb_seed_plain, the same composition in
// torch ops (about 170 of them, three blocking copies and a read of the
// card a lane set, which K8 replaces by one copy and one launch).
//
// Per lane (a block each; lanes never read each other), from its signed
// origin vertex id vid (0: an inert lane) and its out-char ch:
//   * the origin's occurrence window, its first IC occurrences (occ_off of
//     |vid| and |vid| + 1), each occurrence's chromosome c and index i, its
//     strand s (+1 where the junction stored at (c, i) is vid itself), the
//     strand-aware used-slot filter (+ reads its own slot, - the slot before
//     it; index 0 on the minus strand is never used) and the annotation-char
//     filter (occ_ch on +, occ_revch on -, equal to ch);
//   * the survivors left-compacted in occurrence order (a block-wide prefix
//     sum of the keep flags, which is the order of the plain version's sort:
//     its keys are unique);
//   * the live, rewind and result slabs each the seeded lane: chr, s, fi =
//     bi = cmp = i and insert_seq = the column on the n live columns, -1, 0,
//     0 and 0 past them; fdist, bdist, ffin, bfin 0, good_seq -1; n and
//     next_insert n, next_good, the flanks and overflow 0; the path row vid
//     then BIG (an inert lane: BIG throughout), pdist 0, pn 1 (0), rv = lv =
//     vid (0);
//   * best score 0, no snapshot, and the protocol registers of
//     step.init_carry: stage 0, positive false, prev_len 0, score 0,
//     retier, hostfb, in_walk false, wc = wi = 0, ws 1, wt BIG, wlast
//     false, active = lane < nb and count <= IC;
//   * the seed-overflow flag count > IC, where count is the origin's whole
//     occurrence count (a wider slab or the host oracle re-runs the lane).
// The arithmetic is torch's: indices clipped to [0, length - 1], int64
// sums that wrap.
//
// What bounds it: bytes.  A launch writes three copies of every lane's
// slab (11 instance rows of IC columns, nine int64 and two bool, and two
// int64 path rows of PC), 41.7 MB at L 256, IC 512, PC 1024 (12.5 us at
// 3.35 TB/s), 5.3 MB at IC 64, PC 128; it reads two table words a lane and
// ~34 bytes an occurrence in its window.  The design: one block of 256
// threads a lane; the compaction is warp ballots and one barrier a tile of
// 256 columns, into the block's shared memory (17 bytes a column); then
// every row of the three slabs is written once, each value computed once
// and stored to the three slabs, 16 bytes a store where the row starts on
// 16 bytes (the engine's allocation lays every row so), neighbouring
// threads on neighbouring addresses.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneFields = 22;  // LANE_FIELDS
constexpr int kRegisters = 13;   // fused.CARRY_REGISTERS
// the outputs, in the order of the C interface: the state's 68 leaves
// (_state_leaves: ln, rw, sn, best_score, has_snap), the 13 registers, the
// seed-overflow row
constexpr int kBest = 3 * kLaneFields;
constexpr int kHasSnap = kBest + 1;
constexpr int kReg0 = kHasSnap + 1;
constexpr int kSeedOvf = kReg0 + kRegisters;
constexpr int kOutputs = kSeedOvf + 1;
constexpr i64 kBig = 1LL << 60;
constexpr int kMaxSmem = 232448;  // the most a block may opt in to
constexpr int kDefaultSmem = 49152;

// LANE_FIELDS, in order
enum Field {
  F_CHR, F_S, F_FI, F_BI, F_FDIST, F_BDIST, F_CMP, F_FFIN, F_BFIN, F_GOOD, F_INS,
  F_N, F_NEXT_GOOD, F_NEXT_INS, F_RF, F_LF, F_OVF, F_PVID, F_PDIST, F_PN, F_RV, F_LV
};
// fused.CARRY_REGISTERS, in order
enum Register {
  R_STAGE, R_POSITIVE, R_PREV_LEN, R_SCORE, R_ACTIVE, R_RETIER, R_HOSTFB, R_IN_WALK, R_WC,
  R_WI, R_WS, R_WT, R_WLAST
};

struct Outputs {
  void* p[kOutputs];
};

struct Tables {
  const i64* occ_off;
  const i64* occ_chr;
  const i64* occ_idx;
  const uint8_t* occ_ch;
  const uint8_t* occ_revch;
  const i64* chr_off;
  const i64* jid;
  const uint8_t* used;
  i64 n_occ_off, n_occ, n_chr_off, n_j, n_used;
};

__device__ __forceinline__ i64 clip(i64 x, i64 hi) {
  hi = hi > 0 ? hi : 0;
  return x < 0 ? 0 : (x > hi ? hi : x);
}
__device__ __forceinline__ i64 wadd(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) + static_cast<u64>(b));
}
__device__ __forceinline__ i64 wsub(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) - static_cast<u64>(b));
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

// Row `lane` (of `width` int64 columns) of lane field f in the three
// slabs, column j set to value(j) in each.
template <class F>
__device__ __forceinline__ void fill_i64(const Outputs& out, int f, i64 lane, int width,
                                         F value) {
  i64* d0 = static_cast<i64*>(out.p[f]) + lane * width;
  i64* d1 = static_cast<i64*>(out.p[kLaneFields + f]) + lane * width;
  i64* d2 = static_cast<i64*>(out.p[2 * kLaneFields + f]) + lane * width;
  if ((width & 1) == 0 && aligned16(d0, d1, d2)) {
    for (int j = threadIdx.x; j < width / 2; j += kThreads) {
      const longlong2 v = make_longlong2(value(2 * j), value(2 * j + 1));
      reinterpret_cast<longlong2*>(d0)[j] = v;
      reinterpret_cast<longlong2*>(d1)[j] = v;
      reinterpret_cast<longlong2*>(d2)[j] = v;
    }
  } else {
    for (int j = threadIdx.x; j < width; j += kThreads) {
      const i64 v = value(j);
      d0[j] = v;
      d1[j] = v;
      d2[j] = v;
    }
  }
}

// Row `lane` (of `width` bytes) of bool lane field f in the three slabs,
// cleared.
__device__ __forceinline__ void clear_bytes(const Outputs& out, int f, i64 lane, int width) {
  uint8_t* d0 = static_cast<uint8_t*>(out.p[f]) + lane * width;
  uint8_t* d1 = static_cast<uint8_t*>(out.p[kLaneFields + f]) + lane * width;
  uint8_t* d2 = static_cast<uint8_t*>(out.p[2 * kLaneFields + f]) + lane * width;
  if ((width & 15) == 0 && aligned16(d0, d1, d2)) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int j = threadIdx.x; j < width / 16; j += kThreads) {
      reinterpret_cast<uint4*>(d0)[j] = zero;
      reinterpret_cast<uint4*>(d1)[j] = zero;
      reinterpret_cast<uint4*>(d2)[j] = zero;
    }
  } else {
    for (int j = threadIdx.x; j < width; j += kThreads) {
      d0[j] = 0;
      d1[j] = 0;
      d2[j] = 0;
    }
  }
}

__device__ __forceinline__ void put_i64(const Outputs& out, int q, i64 lane, i64 v) {
  static_cast<i64*>(out.p[q])[lane] = v;
}
__device__ __forceinline__ void put_bool(const Outputs& out, int q, i64 lane, bool v) {
  static_cast<uint8_t*>(out.p[q])[lane] = v ? 1 : 0;
}

// The dynamic shared bytes a block takes at slab width IC (the compacted
// chromosomes and indices, int64, and strands, a byte each), -1 where the
// block cannot have them.
long long seed_smem(int IC) {
  const long long bytes = 17LL * IC;
  return IC >= 1 && bytes <= kMaxSmem ? bytes : -1;
}

__global__ void __launch_bounds__(kThreads)
    lcb_seed_kernel(const i64* __restrict__ args, i64 nb, i64 L, int IC, int PC, Tables tb,
                    Outputs out) {
  extern __shared__ __align__(16) unsigned char smem[];
  i64* s_chr = reinterpret_cast<i64*>(smem);
  i64* s_idx = s_chr + IC;
  signed char* s_str = reinterpret_cast<signed char*>(s_idx + IC);
  __shared__ int warp_kept[kWarps];

  const i64 lane = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const i64 vid = __ldg(args + lane);
  const i64 ch = __ldg(args + L + lane);
  const i64 v = vid < 0 ? wsub(0, vid) : vid;
  const i64 lo = __ldg(tb.occ_off + clip(v, tb.n_occ_off - 2));
  const i64 count = wsub(__ldg(tb.occ_off + clip(wadd(v, 1), tb.n_occ_off - 1)), lo);

  // the survivors of the window, compacted into shared memory, a tile of
  // kThreads columns a round (the bound is the block's, so every thread
  // meets every ballot and barrier)
  const i64 span = vid != 0 ? (count < IC ? count : IC) : 0;
  int n = 0;
  for (int c0 = 0; c0 < span; c0 += kThreads) {
    const int col = c0 + tid;
    bool keep = false;
    i64 c = 0, i = 0;
    int s = 0;
    if (col < span) {
      const i64 row = clip(wadd(lo, col), tb.n_occ - 1);
      c = __ldg(tb.occ_chr + row);
      i = __ldg(tb.occ_idx + row);
      const i64 flat = clip(wadd(__ldg(tb.chr_off + clip(c, tb.n_chr_off - 2)), i), tb.n_j - 1);
      s = __ldg(tb.jid + flat) == vid ? 1 : -1;
      const i64 slot = s > 0 ? flat : flat - 1;
      const bool usable = !(s > 0 || i > 0) || __ldg(tb.used + clip(slot, tb.n_used - 1)) == 0;
      const i64 charv = s > 0 ? __ldg(tb.occ_ch + row) : __ldg(tb.occ_revch + row);
      keep = usable && charv == ch;
    }
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (lid == 0) warp_kept[warp] = __popc(kept);
    __syncthreads();
    int pos = n + __popc(kept & ((1u << lid) - 1u)), total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int k = warp_kept[w];
      pos += w < warp ? k : 0;
      total += k;
    }
    if (keep) {
      s_chr[pos] = c;
      s_idx[pos] = i;
      s_str[pos] = static_cast<signed char>(s);
    }
    n += total;
    __syncthreads();
  }

  // the three slabs
  fill_i64(out, F_CHR, lane, IC, [&](int j) -> i64 { return j < n ? s_chr[j] : -1; });
  fill_i64(out, F_S, lane, IC, [&](int j) -> i64 { return j < n ? s_str[j] : 0; });
  const auto idx = [&](int j) -> i64 { return j < n ? s_idx[j] : 0; };
  const auto zero = [](int) -> i64 { return 0; };
  fill_i64(out, F_FI, lane, IC, idx);
  fill_i64(out, F_BI, lane, IC, idx);
  fill_i64(out, F_FDIST, lane, IC, zero);
  fill_i64(out, F_BDIST, lane, IC, zero);
  fill_i64(out, F_CMP, lane, IC, idx);
  clear_bytes(out, F_FFIN, lane, IC);
  clear_bytes(out, F_BFIN, lane, IC);
  fill_i64(out, F_GOOD, lane, IC, [](int) -> i64 { return -1; });
  fill_i64(out, F_INS, lane, IC, [&](int j) -> i64 { return j < n ? j : 0; });
  const bool has = vid != 0;
  const i64 head = has ? vid : kBig;
  fill_i64(out, F_PVID, lane, PC, [&](int j) -> i64 { return j == 0 ? head : kBig; });
  fill_i64(out, F_PDIST, lane, PC, zero);

  // the registers, a thread a slab and one for the rest
  if (tid < 3) {
    const int q = tid * kLaneFields;
    put_i64(out, q + F_N, lane, n);
    put_i64(out, q + F_NEXT_GOOD, lane, 0);
    put_i64(out, q + F_NEXT_INS, lane, n);
    put_i64(out, q + F_RF, lane, 0);
    put_i64(out, q + F_LF, lane, 0);
    put_bool(out, q + F_OVF, lane, false);
    put_i64(out, q + F_PN, lane, has ? 1 : 0);
    put_i64(out, q + F_RV, lane, has ? vid : 0);
    put_i64(out, q + F_LV, lane, has ? vid : 0);
  } else if (tid == 3) {
    const bool ovf = count > IC;
    put_i64(out, kBest, lane, 0);
    put_bool(out, kHasSnap, lane, false);
    put_i64(out, kReg0 + R_STAGE, lane, 0);
    put_bool(out, kReg0 + R_POSITIVE, lane, false);
    put_i64(out, kReg0 + R_PREV_LEN, lane, 0);
    put_i64(out, kReg0 + R_SCORE, lane, 0);
    put_bool(out, kReg0 + R_ACTIVE, lane, lane < nb && !ovf);
    put_bool(out, kReg0 + R_RETIER, lane, false);
    put_bool(out, kReg0 + R_HOSTFB, lane, false);
    put_bool(out, kReg0 + R_IN_WALK, lane, false);
    put_i64(out, kReg0 + R_WC, lane, 0);
    put_i64(out, kReg0 + R_WI, lane, 0);
    put_i64(out, kReg0 + R_WS, lane, 1);
    put_i64(out, kReg0 + R_WT, lane, kBig);
    put_bool(out, kReg0 + R_WLAST, lane, false);
    put_bool(out, kSeedOvf, lane, ovf);
  }
}

}  // namespace

// buf: the launch's one device allocation: the lanes' arguments at its
// start ([2, L] int64: the signed origin vids, 0 for an inert lane, then
// the out-chars), and the outputs at `offsets` (a host array of 82 byte
// offsets into buf: the state's 68 leaves in _state_leaves' order, the 13
// registers of fused.CARRY_REGISTERS, the seed-overflow row; [L, IC] and
// [L, PC] rows and [L] rows, int64 or bool as kernels._step_specs has
// them, none overlapping; a row on 16 bytes is written 16 bytes a store).
// nb: the lanes that hold a bundle (active unless they overflow).
// tables, table_lens: host arrays of the 8 device pointers and lengths of
// occ_off, occ_chr, occ_idx, occ_ch, occ_revch, chr_off, jid, used (int64,
// but occ_ch, occ_revch and used, uint8; occ_idx, occ_ch and occ_revch of
// occ_chr's length).  Returns a CUDA error code (0: launched).
extern "C" int sz_lcb_seed(void* buf, const long long* offsets, long long nb, long long L,
                           int IC, int PC, const long long* tables,
                           const long long* table_lens, void* stream) {
  const long long smem = seed_smem(IC);
  if (L < 1 || L > 0x7fffffffLL || nb < 0 || nb > L || PC < 1 || smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Outputs out{};
  char* base = static_cast<char*>(buf);
  for (int q = 0; q < kOutputs; ++q) out.p[q] = base + offsets[q];
  Tables tb{};
  tb.occ_off = reinterpret_cast<const i64*>(tables[0]);
  tb.occ_chr = reinterpret_cast<const i64*>(tables[1]);
  tb.occ_idx = reinterpret_cast<const i64*>(tables[2]);
  tb.occ_ch = reinterpret_cast<const uint8_t*>(tables[3]);
  tb.occ_revch = reinterpret_cast<const uint8_t*>(tables[4]);
  tb.chr_off = reinterpret_cast<const i64*>(tables[5]);
  tb.jid = reinterpret_cast<const i64*>(tables[6]);
  tb.used = reinterpret_cast<const uint8_t*>(tables[7]);
  tb.n_occ_off = table_lens[0];
  tb.n_occ = table_lens[1];
  tb.n_chr_off = table_lens[5];
  tb.n_j = table_lens[6];
  tb.n_used = table_lens[7];
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        lcb_seed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lcb_seed_kernel<<<static_cast<unsigned>(L), kThreads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(static_cast<const i64*>(buf), nb, L,
                                                         IC, PC, tb, out);
  return static_cast<int>(cudaGetLastError());
}

// The outputs of a launch (the C interface's offsets).
extern "C" int sz_lcb_seed_outputs() { return kOutputs; }

// The dynamic shared bytes a block takes at slab width IC, -1 for a width
// the kernel does not take.
extern "C" long long sz_lcb_seed_smem(int IC) { return seed_smem(IC); }
