// The LCB walk's device code: K5 lcb_walk's algorithm (csrc/lcb_walk.cu,
// whose head says what it computes and how), one row a call of walk_row.
// K5 runs it once a block; K7 lcb_step (csrc/lcb_step.cu) runs it on its
// walking warps once an outer step of its lane, so both kernels walk by
// this one source.
//
// walk_row needs only warps 0 and 1 of its block: warp 0 walks, warp 1
// finds the uniform tails and joins for long shifts, scores and stores.
// Its barriers are named barriers 1-3 over those 64 threads, so a block
// may hold more warps as long as they stay out of it and off those
// barriers.  The slab's mbarrier (Shared::bar) is the caller's to set up
// once; walk_row waits on its phase Shared::parity and flips it after each
// load, so one barrier serves any number of walks of a block.
//
// walk_row<true> is K7's: the lane's live slab stays in the caller's
// shared memory for the whole launch, and its registers, best score,
// snapshot flag and uniform tails in a Resident beside it.  Such a walk
// loads nothing and finds no tails (the caller found them when it loaded
// the slab; the walk keeps them up to date), stores no live slab (the
// caller stores it once, at the launch's end), and writes the registers
// back to the Resident; its rewind and result snapshots go out by bulk
// stores as K5's do, which the caller waits for before it loads a slab.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "step_stamps.cuh"

namespace {
namespace walk {

typedef long long i64;
typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kInst = 11;        // instance fields of a lane (LANE_FIELDS[:11])
constexpr int kWide = 9;         // of them int64 (all but ffin and bfin)
constexpr int kLaneRows = kInst + 2;  // and pvid, pdist
constexpr int kLaneFields = 22;  // LANE_FIELDS
constexpr int kLeaves = 3 * kLaneFields + 2;  // ln, rw, sn, best_score, has_snap
constexpr int kRegs = 9;
constexpr int kWarpCols = 64;  // a shift or score of at most this many columns stays in warp 0
constexpr i64 kBig = 1LL << 60;
constexpr i64 kNegInf = -2147483647LL;  // oracle.NEG_INF_SCORE
constexpr int kMaxSmem = 232448;        // the most a block may opt in to

// LANE_FIELDS, in order
enum Field {
  F_CHR, F_S, F_FI, F_BI, F_FDIST, F_BDIST, F_CMP, F_FFIN, F_BFIN, F_GOOD, F_INS,
  F_N, F_NEXT_GOOD, F_NEXT_INS, F_RF, F_LF, F_OVF, F_PVID, F_PDIST, F_PN, F_RV, F_LV
};
// the lane's scalar registers, in the order warp 0 keeps them
__constant__ int kRegField[kRegs] = {F_N, F_NEXT_GOOD, F_NEXT_INS, F_RF, F_LF,
                                     F_OVF, F_PN, F_RV, F_LV};
// what warp 0 asks of the whole block
enum Job { J_SHIFT_INST, J_SHIFT_PATH, J_SCORE, J_STORE, J_DONE };

__host__ __device__ constexpr bool is_bool(int f) {
  return f == F_FFIN || f == F_BFIN || f == F_OVF;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Leaves {
  void* p[kLeaves];  // _state_leaves order
};

struct Tables {
  const i64* chr_off;
  const i64* chr_len;
  const i64* jpos;
  const i64* jid;
  const i64* used_pfx;
  const uint8_t* used;
  const i64* seq_off;
  const uint8_t* seq;
  const i64* occ_off;
  const i64* occ_chr;
  const i64* occ_idx;
  // lengths: chr_off, chr_len, jpos (= jid), used_pfx, used, seq_off, seq,
  // occ_off, occ_chr (= occ_idx)
  i64 n_chr_off, n_chr_len, n_j, n_pfx, n_used, n_seq_off, n_seq, n_occ_off, n_occ;
  i64 k;
};

struct Params {
  i64 L, A, m, b, flank;
  int IC, PC, limit;
  u64 bulk;  // bit q * kLaneRows + k: row k of slab q goes by bulk copies
};

// The lane's slab in dynamic shared memory: nine int64 instance rows of ICw
// words, ffin and bfin of ICb bytes, pvid and pdist of PCw words; every row
// starts on 16 bytes.
struct Slab {
  i64* wide;
  uint8_t* fin;
  i64* pvid;
  i64* pdist;
  int IC, ICw, ICb, PC, PCw;

  __device__ i64* w(int f) const { return wide + (f < F_FFIN ? f : f - 2) * ICw; }
  __device__ uint8_t* b(int f) const { return fin + (f - F_FFIN) * ICb; }
};

__host__ __device__ inline long long slab_bytes(int IC, int PC) {
  return 8LL * kWide * round_up(IC, 2) + 2LL * round_up(IC, 16) + 16LL * round_up(PC, 2);
}

// The slab laid out from `smem` (16-byte aligned) at widths IC and PC.
__device__ __forceinline__ Slab slab_of(uint8_t* smem, int IC, int PC) {
  Slab S;
  S.IC = IC;
  S.ICw = round_up(IC, 2);
  S.ICb = round_up(IC, 16);
  S.PC = PC;
  S.PCw = round_up(PC, 2);
  S.wide = reinterpret_cast<i64*>(smem);
  S.fin = smem + 8 * kWide * S.ICw;
  S.pvid = reinterpret_cast<i64*>(S.fin + 2 * S.ICb);
  S.pdist = S.pvid + S.PCw;
  return S;
}

// The six instance rows a score reads: the slab's in shared memory, or a
// lane's in device memory (a row that does not walk scores from there).
struct Cols {
  const i64 *chr, *fi, *bi, *fdist, *bdist, *good;
};

// A lane kept in shared memory for a whole K7 launch, beside its slab:
// what K5 reads from and writes to the lane's device memory at each walk.
struct Resident {
  i64 reg[kRegs];    // the lane's registers, in kRegField's order
  i64 best;          // its best score
  int has_snap;      // its snapshot flag
  int t_inst, t_path;  // the slab's uniform tails' first columns
  int stored;        // slabs (bit q: slab q) whose bulk stores may be in flight
  int alias;         // the result slab is due a copy of the rewind slab (see walk_row)
};

// What warp 0 hands the block, and what it keeps beside the slab.
struct Shared {
  int job, p, top, mask;  // a job, a shift's column and highest column, a store's slabs
  int t_inst, t_path;     // the uniform tails' first columns, after the load
  i64 vals[kInst];        // the values a shift inserts at column p
  i64 n, rf, lf;          // a score's registers
  Cols cols;              // and its rows
  i64 red[2 * kWarps];
  // the occurrence-only words of 32 occurrence steps, one a lane of warp 0
  i64 pf_cj[32], pf_ij[32], pf_base[32], pf_jp[32], pf_pfx[32];
  int pf_flags[32];       // 1: strand +, 2: used, 4: the backward escape's start side holds
  u64 bar;     // the slab's mbarrier, set up once by the kernel
  u32 parity;  // its phase for the next load
};

// The C interface's tables as Tables: 11 device pointers (chr_off, chr_len,
// jpos, jid, used_pfx, used, seq_off, seq, occ_off, occ_chr, occ_idx) and
// 9 lengths (chr_off, chr_len, jpos = jid, used_pfx, used, seq_off, seq,
// occ_off, occ_chr = occ_idx).
inline Tables tables_of(const long long* tables, const long long* lens, long long k) {
  Tables tb{};
  tb.chr_off = reinterpret_cast<const i64*>(tables[0]);
  tb.chr_len = reinterpret_cast<const i64*>(tables[1]);
  tb.jpos = reinterpret_cast<const i64*>(tables[2]);
  tb.jid = reinterpret_cast<const i64*>(tables[3]);
  tb.used_pfx = reinterpret_cast<const i64*>(tables[4]);
  tb.used = reinterpret_cast<const uint8_t*>(tables[5]);
  tb.seq_off = reinterpret_cast<const i64*>(tables[6]);
  tb.seq = reinterpret_cast<const uint8_t*>(tables[7]);
  tb.occ_off = reinterpret_cast<const i64*>(tables[8]);
  tb.occ_chr = reinterpret_cast<const i64*>(tables[9]);
  tb.occ_idx = reinterpret_cast<const i64*>(tables[10]);
  tb.n_chr_off = lens[0];
  tb.n_chr_len = lens[1];
  tb.n_j = lens[2];
  tb.n_pfx = lens[3];
  tb.n_used = lens[4];
  tb.n_seq_off = lens[5];
  tb.n_seq = lens[6];
  tb.n_occ_off = lens[7];
  tb.n_occ = lens[8];
  tb.k = k;
  return tb;
}

// Params::bulk for the state's 68 leaves (host pointers to device memory):
// the rows of a slab whose every lane's row starts on 16 bytes.
inline u64 bulk_rows(const long long* leaves, int IC, int PC) {
  u64 bulk = 0;
  for (int q = 0; q < 3; ++q) {
    for (int k = 0; k < kLaneRows; ++k) {
      const int field = k < kInst ? k : (k == kInst ? F_PVID : F_PDIST);
      const long long bytes = is_bool(field) ? IC : 8LL * (k < kInst ? IC : PC);
      if (((leaves[q * kLaneFields + field] | bytes) & 15) == 0) {
        bulk |= 1ULL << (q * kLaneRows + k);
      }
    }
  }
  return bulk;
}

// ---- arithmetic as torch's ----

__device__ __forceinline__ i64 clip(i64 x, i64 hi) {
  hi = hi > 0 ? hi : 0;
  return x < 0 ? 0 : (x > hi ? hi : x);
}
__device__ __forceinline__ int clipi(i64 x, int hi) { return static_cast<int>(clip(x, hi)); }

__device__ __forceinline__ i64 wadd(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) + static_cast<u64>(b));
}
__device__ __forceinline__ i64 wsub(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) - static_cast<u64>(b));
}
__device__ __forceinline__ i64 wmul(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) * static_cast<u64>(b));
}
__device__ __forceinline__ i64 iabs(i64 a) { return a < 0 ? wsub(0, a) : a; }

// batched_push_device._COMP_TBL: the complement of an upper-case base, 0
// for any other byte
__device__ __forceinline__ i64 comp(i64 ch) {
  return ch == 'A' ? 'T' : ch == 'C' ? 'G' : ch == 'G' ? 'C' : ch == 'T' ? 'A' : 0;
}

// ---- Hopper's bulk copies, mbarrier and barriers ----

__device__ __forceinline__ u32 smem_addr(const void* p) {
  return static_cast<u32>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(u64* bar, u32 count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(u64* bar, u32 bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(u64* bar, u32 parity) {
  u32 done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* sm, const void* g, u32 bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(sm)), "l"(g), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* g, const void* sm, u32 bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(g),
               "r"(smem_addr(sm)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the bulk stores in flight have read shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// the bulk stores in flight are done (two in flight to one row would land in
// no set order: a slab stored again waits for the last store to it)
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// this thread's writes to shared memory, made visible to the bulk copies
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the whole block (barrier 1; warp 0 reaches it from its own code path)
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// the helper warps hand warp 0 a result: they arrive at barrier `id`, warp
// 0 waits there for them
constexpr int kPathTail = 2, kInstTail = 3;
__device__ __forceinline__ void helpers_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void warp0_wait(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ bool bulk_row(const Params& pr, int q, int k) {
  return (pr.bulk >> (q * kLaneRows + k)) & 1;
}

// dst[0, n) = src[0, n) by `size` threads (rank of them), in the widest
// word both addresses allow
template <typename W>
__device__ void copy_words(uint8_t* dst, const uint8_t* src, i64 n, int rank, int size) {
  constexpr i64 kw = sizeof(W);
  i64 head = (kw - static_cast<i64>(reinterpret_cast<uintptr_t>(dst) & (kw - 1))) & (kw - 1);
  head = head < n ? head : n;
  for (i64 q = rank; q < head; q += size) dst[q] = src[q];
  const i64 words = (n - head) / kw;
  W* dw = reinterpret_cast<W*>(dst + head);
  const W* sw = reinterpret_cast<const W*>(src + head);
  for (i64 q = rank; q < words; q += size) dw[q] = sw[q];
  for (i64 q = head + words * kw + rank; q < n; q += size) dst[q] = src[q];
}

__device__ void copy_bytes(void* dst, const void* src, i64 n, int rank, int size) {
  uint8_t* d = static_cast<uint8_t*>(dst);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const uintptr_t x = reinterpret_cast<uintptr_t>(d) ^ reinterpret_cast<uintptr_t>(s);
  if ((x & 15) == 0) {
    copy_words<int4>(d, s, n, rank, size);
  } else if ((x & 7) == 0) {
    copy_words<u64>(d, s, n, rank, size);
  } else if ((x & 3) == 0) {
    copy_words<u32>(d, s, n, rank, size);
  } else {
    copy_words<uint8_t>(d, s, n, rank, size);
  }
}

// Row k of a lane (the eleven instance fields, pvid, pdist): its place in
// shared memory, its bytes and its field.
__device__ __forceinline__ uint8_t* lane_row(const Slab& S, int k, int& bytes, int& field) {
  if (k < kInst) {
    field = k;
    if (is_bool(k)) {
      bytes = S.IC;
      return S.b(k);
    }
    bytes = 8 * S.IC;
    return reinterpret_cast<uint8_t*>(S.w(k));
  }
  field = k == kInst ? F_PVID : F_PDIST;
  bytes = 8 * S.PC;
  return reinterpret_cast<uint8_t*>(k == kInst ? S.pvid : S.pdist);
}

__device__ __forceinline__ uint8_t* global_row(const Leaves& st, int q, int field, i64 lane,
                                               int bytes) {
  return static_cast<uint8_t*>(st.p[q * kLaneFields + field]) + lane * bytes;
}

// ---- the searches ----

// torch.searchsorted over [0, W): the first index whose probe goes left
// (row[mid] >= val for the lower bound, row[mid] > val for the upper), W
// where none does. The rows searched are sorted (the live instance keys,
// then kBig past n; the path's vids, then kBig: every insertion lands at
// its own search's answer), as torch.searchsorted requires, so the
// predicate is monotone and any search that finds its first true index
// gives torch's answer. A round probes 32 pivots, one a lane, and keeps
// the span between the last false and the first true pivot: two rounds up
// to W = 1024. Warp 0, all lanes, W the same in each.
template <class Left>
__device__ int warp_search(int W, int lane, Left left) {
  int lo = 0, hi = W;  // the answer lies in [lo, hi]; hi's probe, where hi < W, goes left
  while (lo < hi) {
    const int len = hi - lo;
    const int chunk = (len + 31) >> 5;
    const int q = lo + (lane + 1) * chunk - 1;  // the pivots below hi
    const unsigned m = __ballot_sync(0xffffffffu, q < hi && left(q));
    if (chunk == 1) return m ? lo + __ffs(m) - 1 : hi;
    if (m == 0) {
      lo += len / chunk * chunk;  // past the last pivot
    } else {
      lo += (__ffs(m) - 1) * chunk;  // past the last pivot that does not go left
      hi = lo + chunk - 1;           // the first that does
    }
  }
  return lo;
}

// ---- the uniform tails ----

// This thread's part (columns 2h, 2h+1 for h = rank, rank + size, ...) of
// the path table's uniform tail: the first column from which pvid and
// pdist equal the last column's (pairs of int64 columns a 16-byte load:
// every row starts on 16 bytes); the caller takes the maximum.
__device__ int path_tail_part(const Slab& S, int rank, int size) {
  const int PC = S.PC;
  int tp = 0;
  const longlong2* pv2 = reinterpret_cast<const longlong2*>(S.pvid);
  const longlong2* pd2 = reinterpret_cast<const longlong2*>(S.pdist);
  const i64 pv_last = S.pvid[PC - 1], pd_last = S.pdist[PC - 1];
  for (int h = rank; 2 * h < PC - 1; h += size) {
    const longlong2 v = pv2[h], w = pd2[h];
    if (v.x != pv_last || w.x != pd_last) tp = 2 * h + 1;
    if (2 * h + 1 < PC - 1 && (v.y != pv_last || w.y != pd_last)) tp = 2 * h + 2;
  }
  return tp;
}

// The same for the instance rows (every instance field).
__device__ int inst_tail_part(const Slab& S, int rank, int size) {
  const int IC = S.IC;
  int ti = 0;
  i64 last[kWide];
#pragma unroll
  for (int w = 0; w < kWide; ++w) last[w] = S.wide[w * S.ICw + IC - 1];
  const uint8_t f0 = S.fin[IC - 1], f1 = S.fin[S.ICb + IC - 1];
  for (int h = rank; 2 * h < IC - 1; h += size) {
    bool d0 = S.fin[2 * h] != f0 || S.fin[S.ICb + 2 * h] != f1;
    bool d1 = S.fin[2 * h + 1] != f0 || S.fin[S.ICb + 2 * h + 1] != f1;
#pragma unroll
    for (int w = 0; w < kWide; ++w) {
      const longlong2 v = reinterpret_cast<const longlong2*>(S.wide + w * S.ICw)[h];
      d0 |= v.x != last[w];
      d1 |= v.y != last[w];
    }
    if (d0) ti = 2 * h + 1;
    if (2 * h + 1 < IC - 1 && d1) ti = 2 * h + 2;
  }
  return ti;
}

// ---- shifts, score ----

__device__ __forceinline__ void group_sync(bool block) {
  if (block) {
    block_sync();
  } else {
    __syncwarp();
  }
}

// new[col] = old[col - 1] for p < col <= top, then column p = vals (if p <
// IC), in the eleven instance rows (batched_push_device._row_insert, the
// columns past `top` being uniform); `size` threads, rank of them, each
// round's reads before a sync and its writes after it (a round writes only
// columns above those the next one reads).
__device__ void shift_inst(const Slab& S, int top, int p, const i64* vals, int rank, int size,
                           bool block) {
  for (int hi = top; hi > p; hi -= size) {
    const int col = hi - rank;
    const bool mine = col > p;
    i64 v[kWide];
    uint8_t f0 = 0, f1 = 0;
    if (mine) {
#pragma unroll
      for (int w = 0; w < kWide; ++w) v[w] = S.wide[w * S.ICw + col - 1];
      f0 = S.fin[col - 1];
      f1 = S.fin[S.ICb + col - 1];
    }
    group_sync(block);
    if (mine) {
#pragma unroll
      for (int w = 0; w < kWide; ++w) S.wide[w * S.ICw + col] = v[w];
      S.fin[col] = f0;
      S.fin[S.ICb + col] = f1;
    }
  }
  if (rank == 0 && p < S.IC) {
    for (int f = 0; f < kInst; ++f) {
      if (is_bool(f)) {
        S.b(f)[p] = vals[f] != 0;
      } else {
        S.w(f)[p] = vals[f];
      }
    }
  }
}

// the same in the path table (pvid, pdist)
__device__ void shift_path(const Slab& S, int top, int p, const i64* vals, int rank, int size,
                           bool block) {
  for (int hi = top; hi > p; hi -= size) {
    const int col = hi - rank;
    const bool mine = col > p;
    i64 v0 = 0, v1 = 0;
    if (mine) {
      v0 = S.pvid[col - 1];
      v1 = S.pdist[col - 1];
    }
    group_sync(block);
    if (mine) {
      S.pvid[col] = v0;
      S.pdist[col] = v1;
    }
  }
  if (rank == 0 && p < S.PC) {
    S.pvid[p] = vals[0];
    S.pdist[p] = vals[1];
  }
}

__device__ Cols slab_cols(const Slab& S) {
  return Cols{S.w(F_CHR), S.w(F_FI), S.w(F_BI), S.w(F_FDIST), S.w(F_BDIST), S.w(F_GOOD)};
}

__device__ Cols lane_cols(const Leaves& st, i64 lane, int IC) {
  auto row = [&](int f) { return static_cast<const i64*>(st.p[f]) + lane * IC; };
  return Cols{row(F_CHR), row(F_FI), row(F_BI), row(F_FDIST), row(F_BDIST), row(F_GOOD)};
}

// this thread's part of resident._score_of over the columns rank, rank +
// size, ... below n: the wrapped sum and whether a flank is exceeded
__device__ void score_part(const Tables& tb, const Cols& cl, int IC, i64 n, i64 rf, i64 lf,
                           i64 flank, int rank, int size, i64& sum, int& bad) {
  const i64 nj = tb.n_j - 1;
  const int hi = n < IC ? (n > 0 ? static_cast<int>(n) : 0) : IC;
  const i64 *chr = cl.chr, *fi = cl.fi, *bi = cl.bi, *fdist = cl.fdist, *bdist = cl.bdist;
  const i64* good = cl.good;
  for (int col = rank; col < hi; col += size) {
    if (good[col] >= 0) {
      const i64 base = tb.chr_off[clip(chr[col], tb.n_chr_off - 2)];
      const i64 jf = tb.jpos[clip(wadd(base, fi[col]), nj)];
      const i64 jb = tb.jpos[clip(wadd(base, bi[col]), nj)];
      const i64 right_pen = wsub(rf, bdist[col]);
      const i64 left_pen = wadd(wsub(0, lf), fdist[col]);
      bad |= (left_pen >= flank) | (right_pen >= flank);
      const i64 pen = wadd(right_pen, left_pen);
      sum = wadd(sum, wsub(iabs(wsub(jf, jb)), wmul(pen, pen)));
    }
  }
}

__device__ __forceinline__ i64 warp_sum(i64 x) {
  for (int off = 16; off > 0; off >>= 1) x = wadd(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// the score over the whole block; every thread gets it
__device__ i64 block_score(const Tables& tb, const Slab& S, Shared& sh, i64 flank) {
  i64 sum = 0;
  int bad = 0;
  score_part(tb, sh.cols, S.IC, sh.n, sh.rf, sh.lf, flank, threadIdx.x, kThreads, sum, bad);
  sum = warp_sum(sum);
  bad = __any_sync(0xffffffffu, bad);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh.red[warp] = sum;
    sh.red[kWarps + warp] = bad;
  }
  block_sync();
  i64 total = 0;
  int any_bad = 0;
  for (int w = 0; w < kWarps; ++w) {
    total = wadd(total, sh.red[w]);
    any_bad |= static_cast<int>(sh.red[kWarps + w]);
  }
  return any_bad ? kNegInf : total;
}

// the rows of slab q (0 live, 1 rewind, 2 result) at `lane` that take the
// vectorised loop, from shared memory; `size` threads
__device__ void store_rows_by_loop(const Leaves& st, const Params& pr, const Slab& S, int q,
                                   i64 lane, int rank, int size) {
  for (int k = 0; k < kLaneRows; ++k) {
    int bytes, field;
    uint8_t* sm = lane_row(S, k, bytes, field);
    if (!bulk_row(pr, q, k)) copy_bytes(global_row(st, q, field, lane, bytes), sm, bytes, rank,
                                        size);
  }
}

// a job of the whole block, every thread in it; score: the job's result
__device__ i64 run_job(const Tables& tb, const Params& pr, const Slab& S, Shared& sh,
                       const Leaves& st, i64 row_lane) {
  const i64 flank = pr.flank;
  const int tid = threadIdx.x;
  i64 score = 0;
  switch (sh.job) {
    case J_SHIFT_INST:
      shift_inst(S, sh.top, sh.p, sh.vals, tid, kThreads, true);
      break;
    case J_SHIFT_PATH:
      shift_path(S, sh.top, sh.p, sh.vals, tid, kThreads, true);
      break;
    case J_SCORE:
      score = block_score(tb, S, sh, flank);
      break;
    case J_STORE:
      for (int q = 0; q < 3; ++q) {
        if (sh.mask & (1 << q)) store_rows_by_loop(st, pr, S, q, row_lane, tid, kThreads);
      }
      break;
    default:
      break;
  }
  fence_async_smem();  // this thread's writes, before a bulk store reads them
  return score;
}

// warp 0: hand the block the job laid out in sh (lane 0 wrote it), run it
// with the block, and return once the block is done
__device__ i64 call_block(const Tables& tb, const Params& pr, const Slab& S, Shared& sh,
                          const Leaves& st, i64 row_lane) {
  __syncwarp();
  block_sync();
  const i64 score = run_job(tb, pr, S, sh, st, row_lane);
  block_sync();
  return score;
}

// An edge of the walk, one lane's: the push at iterator `it` (edge_of), its
// vertex's occurrence range, and whether the iterator one junction on
// stands on the target.
struct Edge {
  i64 eu, ev, elen, lo, cnt, ech;
  bool after;
};

__device__ Edge edge_at(const Tables& tb, i64 c, i64 cbase0, i64 it, i64 s, bool fwd, i64 tvid) {
  const i64 nj = tb.n_j - 1;
  Edge e;
  const i64 nbr = fwd ? wadd(it, s) : wsub(it, s);
  const i64 idx_self = clip(wadd(cbase0, it), nj), idx_nbr = clip(wadd(cbase0, nbr), nj);
  const i64 id_self = tb.jid[idx_self], id_nbr = tb.jid[idx_nbr];
  e.eu = wmul(s, fwd ? id_self : id_nbr);
  e.ev = wmul(s, fwd ? id_nbr : id_self);
  const i64 p_self = tb.jpos[idx_self], p_nbr = tb.jpos[idx_nbr];
  e.elen = iabs(wsub(p_nbr, p_self));
  const i64 p_start = fwd ? p_self : p_nbr;
  const i64 sq_off = tb.seq_off[clip(c, tb.n_seq_off - 2)];
  const i64 sq_len = wsub(tb.seq_off[clip(wadd(c, 1), tb.n_seq_off - 1)], sq_off);
  if (s > 0) {
    e.ech = wadd(p_start, tb.k) < sq_len
                ? tb.seq[clip(wadd(wadd(sq_off, p_start), tb.k), tb.n_seq - 1)]
                : 0;
  } else {
    const i64 cb = comp(tb.seq[clip(wsub(wadd(sq_off, p_start), 1), tb.n_seq - 1)]);
    e.ech = p_start > 0 && cb > 0 ? cb : 'N';
  }
  const i64 av = iabs(fwd ? e.ev : e.eu);
  e.lo = tb.occ_off[clip(av, tb.n_occ_off - 2)];
  e.cnt = wsub(tb.occ_off[clip(wadd(av, 1), tb.n_occ_off - 1)], e.lo);
  // the iterator one junction on is the edge's other junction
  e.after = wmul(s, id_nbr) == tvid;
  return e;
}

__device__ __forceinline__ i64 shfl64(i64 v, int src) {
  return static_cast<i64>(__shfl_sync(0xffffffffu, static_cast<long long>(v), src));
}

// warp 0: the occurrence-only words of occurrences j0 .. j0+31 of the push
// of vertex vtx (occurrence range lo, cnt), one a lane, into sh.pf_*
__device__ void prefetch_occ(const Tables& tb, Shared& sh, int lane, i64 j0, i64 lo, i64 cnt,
                             i64 vtx, bool fwd, i64 ech, i64 ev) {
  __syncwarp();  // every lane has read the last group
  const i64 j = j0 + lane;
  if (j < cnt) {
    const i64 nj = tb.n_j - 1;
    const i64 oi = clip(wadd(lo, j), tb.n_occ - 1);
    const i64 cj = tb.occ_chr[oi], ij = tb.occ_idx[oi];
    const i64 base = tb.chr_off[clip(cj, tb.n_chr_off - 2)];
    const i64 at = clip(wadd(base, ij), nj);
    const i64 sj = tb.jid[at] == vtx ? 1 : -1;
    const i64 jp = tb.jpos[at];
    const i64 uslot = sj > 0 ? wadd(base, ij) : wsub(wadd(base, ij), 1);
    const bool u = (sj > 0 || ij > 0) && tb.used[clip(uslot, tb.n_used - 1)] > 0;
    int flags = (sj > 0 ? 1 : 0) | (u ? 2 : 0);
    if (!fwd) {  // start_i = ij: the escape's start-side terms
      const i64 nxt = wadd(ij, sj);
      const bool nxt_valid = nxt >= 0 && nxt < tb.chr_len[clip(cj, tb.n_chr_len - 1)];
      const i64 sq_off = tb.seq_off[clip(cj, tb.n_seq_off - 2)];
      const i64 sq_len = wsub(tb.seq_off[clip(wadd(cj, 1), tb.n_seq_off - 1)], sq_off);
      const i64 nseq = tb.n_seq - 1;
      i64 start_char;
      if (sj > 0) {
        start_char = wadd(jp, tb.k) < sq_len ? tb.seq[clip(wadd(wadd(sq_off, jp), tb.k), nseq)]
                                             : 0;
      } else {
        const i64 prev = comp(tb.seq[clip(wsub(wadd(sq_off, jp), 1), nseq)]);
        start_char = jp > 0 && prev > 0 ? prev : 'N';
      }
      const i64 nvid = wmul(sj, tb.jid[clip(wadd(base, nxt > 0 ? nxt : 0), nj)]);
      if (nxt_valid && start_char == ech && nvid == ev) flags |= 4;
    }
    sh.pf_cj[lane] = cj;
    sh.pf_ij[lane] = ij;
    sh.pf_base[lane] = base;
    sh.pf_jp[lane] = jp;
    sh.pf_pfx[lane] = tb.used_pfx[clip(wadd(base, ij), tb.n_pfx - 1)];
    sh.pf_flags[lane] = flags;
  }
  __syncwarp();
}

// One row of a walk: the lane it names (at or past L a sentinel, which reads
// lane L-1, never walks and writes no state) and its arguments.
struct Row {
  i64 lane;
  i64 c, i, s, tvid;
  bool fwd, active, last;
  bool serve;  // the row walks lane L-1 for sentinels: init holds lane L-1 as it was
};

// What a row's walk leaves in warp 0: the iterator's index, the last push's
// success, whether the iterator stands on the target, the final lane's
// score, count, flanks and overflow flag, the pushes and occurrence steps,
// and (where the row serves sentinels) the lane as it was: score, n, rf,
// lf, overflow.
struct RowOut {
  i64 it, score, n, rf, lf, pushes, occ_steps;
  bool last, after, ovf;
  i64 init[5];
};

// One row's walk, by threads 0-63 of the block (see the head of this file);
// its results in warp 0, every lane (warp 1 returns nothing).  smem: the
// block's dynamic shared memory, at least slab_bytes(IC, PC), 16-byte
// aligned.  On return lane 0 of warp 0 may still have bulk stores in flight:
// the caller waits for them (bulk_wait_read before shared memory is reused,
// bulk_wait_all before the state is read again).  kResident (K7): smem
// holds the lane's live slab and `keep` the rest of it (Resident); the walk
// reads and writes them there, and its bulk stores in flight are noted in
// keep->stored (the caller clears it once it has waited for them all).
// Its mask can hold two slabs at most (the rewind's and the result's): a
// lane of warp 0 issues each row's store, so every lane of warp 0 waits
// for its own.  A forward improvement above 0 (the rewind and the result
// slab at once) stores the rewind slab alone and sets keep->alias: the
// result slab is then due a copy of it, which the caller makes where the
// rewind slab is about to change, at the rewind or the launch's end (once
// a forward snapshot is above 0 the best score is, so every later forward
// improvement is such a pair and the copy stays due).
template <bool kResident>
__device__ RowOut walk_row(const Leaves& st, const Tables& tb, const Params& pr, const Row& a,
                           uint8_t* smem, Shared& sh, Resident* keep) {
  const int IC = pr.IC, PC = pr.PC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t_load = stamps::now();
  const i64 L = pr.L;
  const i64 lane_in = a.lane;
  const bool valid = lane_in >= 0 && lane_in < L;
  const i64 src = clip(lane_in, L - 1);

  const Slab S = slab_of(smem, IC, PC);

  if (!kResident && tid == 0) {
    sh.t_inst = 0;
    sh.t_path = 0;
  }

  // the row's walk (every thread: it decides who takes part in what)
  const i64 nj = tb.n_j - 1;
  const i64 c = a.c, s = a.s, tvid = a.tvid;
  const bool fwd = a.fwd;
  const i64 cbase0 = tb.chr_off[clip(c, tb.n_chr_off - 2)];
  const i64 it0 = a.i;
  const bool at0 = wmul(s, tb.jid[clip(wadd(cbase0, it0), nj)]) == tvid;
  const bool walking = valid && a.active && !at0 && pr.limit > 0;
  const i64 d = fwd ? s : wsub(0, s);
  block_sync();  // the tails are zero, the caller's mbarrier and its phase set
  const u32 parity = sh.parity;  // the mbarrier's phase for this walk's load

  // ---- a walking row's slab in: bulk copies where they may (thread 0
  // issues them once it has the first edges, so that its first loads do not
  // queue behind them), else the loop (the helpers); a row that does not walk
  // reads only its score's columns, in place ----
  auto load_slab = [&]() {
    u32 tx = 0;
    for (int k = 0; k < kLaneRows; ++k) {
      int bytes, field;
      lane_row(S, k, bytes, field);
      if (bulk_row(pr, 0, k)) tx += bytes;
    }
    mbar_expect_tx(&sh.bar, tx);
    for (int k = 0; k < kLaneRows; ++k) {
      int bytes, field;
      uint8_t* sm = lane_row(S, k, bytes, field);
      if (bulk_row(pr, 0, k)) bulk_load(sm, global_row(st, 0, field, src, bytes), bytes, &sh.bar);
    }
  };
  if (!kResident && walking && warp != 0) {
    for (int k = 0; k < kLaneRows; ++k) {
      int bytes, field;
      uint8_t* sm = lane_row(S, k, bytes, field);
      if (!bulk_row(pr, 0, k)) copy_bytes(sm, global_row(st, 0, field, src, bytes), bytes,
                                          tid - 32, kThreads - 32);
    }
    fence_async_smem();  // those rows may go out by bulk stores to another slab
  }

  // warp 0, while the slab is in flight: the lane's registers, the edges of
  // the first 32 pushes and the first occurrences of the first push
  i64 reg[kRegs];
  i64 best = 0;
  bool has_snap = false;
  Edge e{};
  if (warp == 0) {
    if constexpr (kResident) {
#pragma unroll
      for (int q = 0; q < kRegs; ++q) reg[q] = keep->reg[q];
      best = keep->best;
      has_snap = keep->has_snap != 0;
    } else {
#pragma unroll
      for (int q = 0; q < kRegs; ++q) {
        const int f = kRegField[q];
        reg[q] = is_bool(f) ? static_cast<const uint8_t*>(st.p[f])[src]
                            : static_cast<const i64*>(st.p[f])[src];
      }
      best = static_cast<const i64*>(st.p[3 * kLaneFields])[src];
      has_snap = static_cast<const uint8_t*>(st.p[3 * kLaneFields + 1])[src] != 0;
    }
    if (walking) {
      e = edge_at(tb, c, cbase0, wadd(it0, wmul(lane, d)), s, fwd, tvid);
      const i64 ev0 = shfl64(e.ev, 0), eu0 = shfl64(e.eu, 0);
      if (!kResident && lane == 0) load_slab();
      prefetch_occ(tb, sh, lane, 0, shfl64(e.lo, 0), shfl64(e.cnt, 0), fwd ? ev0 : eu0, fwd,
                   shfl64(e.ech, 0), ev0);
    }
  }
  if (!kResident && walking) mbar_wait(&sh.bar, parity);
  block_sync();
  if (!kResident && walking && tid == 0) sh.parity = parity ^ 1;  // every thread is past its wait
  stamps::add(stamps::W_LOAD, t_load);
  stamps::count(stamps::C_WALKS, 1);

  if (warp != 0) {  // the block's other warps
    if (!kResident && walking) {
      // the uniform tails, while warp 0 walks: the first column from which
      // every path field (instance field) equals the last column's, handed
      // over at a barrier each (warp 0 shifts nothing before it has them)
      // (pairs of int64 columns a 16-byte load: every row starts on 16 bytes)
      const int rank = tid - 32, size = kThreads - 32;
      const int tp = __reduce_max_sync(0xffffffffu, path_tail_part(S, rank, size));
      if (lane == 0) atomicMax(&sh.t_path, tp);
      helpers_arrive(kPathTail);
      const int ti = __reduce_max_sync(0xffffffffu, inst_tail_part(S, rank, size));
      if (lane == 0) atomicMax(&sh.t_inst, ti);
      helpers_arrive(kInstTail);
    }
    for (;;) {  // then wait for jobs
      block_sync();
      if (sh.job == J_DONE) break;
      run_job(tb, pr, S, sh, st, lane_in);
      block_sync();
    }
    return RowOut{};
  }

  // ---- warp 0 walks ----
  i64& n = reg[0];
  i64& next_good = reg[1];
  i64& next_ins = reg[2];
  i64& rf = reg[3];
  i64& lf = reg[4];
  i64& ovf = reg[5];
  i64& pn = reg[6];
  i64& rv = reg[7];
  i64& lv = reg[8];
  ovf = ovf != 0;
  // the tails, once the helpers hand them over; ChangeBacks before that
  // raise t_inst's floor (a column they write is no longer uniform)
  int t_inst = kResident ? keep->t_inst : 0, t_path = kResident ? keep->t_path : 0;
  bool have_path_tail = kResident, have_inst_tail = kResident;
  // slabs whose rows do not all take bulk stores (bit q: slab q)
  int by_loop = 0;
  for (int q = 0; q < 3; ++q) {
    if (((pr.bulk >> (q * kLaneRows)) & ((1u << kLaneRows) - 1)) != (1u << kLaneRows) - 1) {
      by_loop |= 1 << q;
    }
  }
  const Cols cols = kResident || walking ? slab_cols(S) : lane_cols(st, src, IC);

  int stored = kResident ? keep->stored : 0;  // slabs (bit q: slab q) that bulk stores went to
  bool alias = kResident && keep->alias != 0;
  auto score_now = [&]() -> i64 {
    const long long t_score = stamps::now();
    i64 got;
    if (n <= kWarpCols) {
      i64 sum = 0;
      int bad = 0;
      score_part(tb, cols, IC, n, rf, lf, pr.flank, lane, 32, sum, bad);
      sum = warp_sum(sum);
      got = __any_sync(0xffffffffu, bad) ? kNegInf : sum;
    } else {
      if (lane == 0) {
        sh.job = J_SCORE;
        sh.n = n;
        sh.rf = rf;
        sh.lf = lf;
        sh.cols = cols;
      }
      got = call_block(tb, pr, S, sh, st, lane_in);
      stamps::count(stamps::C_BLOCK_SCORES, 1);
    }
    stamps::add(stamps::W_SCORES, t_score);
    return got;
  };
  // the lane's registers and slab rows out to the slabs in `mask`
  auto store_lane = [&](int mask) {
    const long long t_store = stamps::now();
    if (kResident && (mask & 6) == 6) {  // the pair: the rewind slab now, the result's later
      mask = 2;
      alias = true;
    }
    for (int q = 0; q < 3; ++q) {
      if ((mask & (1 << q)) && lane < kRegs) {
        const int f = kRegField[lane];
        i64 v = reg[0];
#pragma unroll
        for (int x = 1; x < kRegs; ++x) v = lane == x ? reg[x] : v;
        void* p = st.p[q * kLaneFields + f];
        if (is_bool(f)) {
          static_cast<uint8_t*>(p)[lane_in] = v != 0;
        } else {
          static_cast<i64*>(p)[lane_in] = v;
        }
      }
    }
    fence_async_smem();
    __syncwarp();
    const long long t_issue = stamps::now();
    if (kResident) {
      // the rows a lane each (slab after slab of the mask), so that their
      // bulk copies issue side by side; every lane waits for its own
      if (mask & stored) {
        const long long t_wait = stamps::now();
        bulk_wait_all();
        stamps::add(stamps::W_WAITS, t_wait);
      }
      int r = 0;
      for (int q = 0; q < 3; ++q) {
        if (!(mask & (1 << q))) continue;
        const int k = lane - r;
        if (k >= 0 && k < kLaneRows && bulk_row(pr, q, k)) {
          int bytes, field;
          uint8_t* sm = lane_row(S, k, bytes, field);
          bulk_store(global_row(st, q, field, lane_in, bytes), sm, bytes);
        }
        r += kLaneRows;
      }
      bulk_commit();
    } else if (lane == 0) {
      if (mask & stored) bulk_wait_all();
      for (int q = 0; q < 3; ++q) {
        if (!(mask & (1 << q))) continue;
        for (int k = 0; k < kLaneRows; ++k) {
          int bytes, field;
          uint8_t* sm = lane_row(S, k, bytes, field);
          if (bulk_row(pr, q, k)) bulk_store(global_row(st, q, field, lane_in, bytes), sm, bytes);
        }
      }
      bulk_commit();
    }
    stamps::add(stamps::W_ISSUE, t_issue);
    stored |= mask;
    if (mask & by_loop) {
      if (lane == 0) {
        sh.job = J_STORE;
        sh.mask = mask & by_loop;
      }
      call_block(tb, pr, S, sh, st, lane_in);
    }
    stamps::add(stamps::W_STORES, t_store);
  };

  i64 it = it0;
  // (a resident lane's earlier walks may have stores reading the slab)
  bool last = a.last, after = at0, pending = kResident && stored != 0, have_score = false;
  bool live_stored = false;
  i64 pushes = 0, occ_steps = 0, score = 0;
  // a row walking lane L-1 reports the sentinels' state results: lane L-1 as it was
  const bool serve = !kResident && a.serve && valid;
  i64 init[5] = {0, n, rf, lf, ovf};
  if (serve) init[0] = score_now();
  const i64* pvid = S.pvid;
  const i64* chr = S.w(F_CHR);
  const i64* cmp = S.w(F_CMP);
  const i64* fi = S.w(F_FI);
  const i64* bi = S.w(F_BI);
  const i64* sgn = S.w(F_S);

  bool active = walking;
  const long long t_loop = stamps::now();
  const long long inner0 =
      stamps::sum(stamps::W_TAILS) + stamps::sum(stamps::W_SCORES) + stamps::sum(stamps::W_STORES);
  for (int t = 0; active && t < pr.limit; ++t) {
    const int el = t & 31;
    if (el == 0 && t > 0) {
      e = edge_at(tb, c, cbase0, wadd(it, wmul(lane, d)), s, fwd, tvid);
    }
    const i64 eu = shfl64(e.eu, el), ev = shfl64(e.ev, el), elen = shfl64(e.elen, el);
    const i64 occ_lo = shfl64(e.lo, el), occ_cnt = shfl64(e.cnt, el), ech = shfl64(e.ech, el);
    after = __shfl_sync(0xffffffffu, static_cast<int>(e.after), el) != 0;
    const i64 vtx = fwd ? ev : eu;
    const i64 dval = fwd ? wadd(rf, elen) : wsub(lf, elen);
    pushes += 1;
    occ_steps = wadd(occ_steps, occ_cnt);

    // ---- membership + path-table insert ----
    const int pp = warp_search(PC, lane, [&](int mid) { return pvid[mid] >= vtx; });
    const bool member = pvid[clipi(pp, PC - 1)] == vtx && pp < pn;
    const bool success = !member && !ovf;
    if (success) {
      if (pending) {  // the last improvement's stores have read the slab
        const long long t_wait = stamps::now();
        if (kResident || lane == 0) bulk_wait_read();
        stamps::add(stamps::W_WAITS, t_wait);
        __syncwarp();
        pending = false;
      }
      ovf = ovf || pn >= PC - 1;
      pn = wadd(pn, 1);
      if (!have_path_tail) {
        const long long t_tail = stamps::now();
        warp0_wait(kPathTail);
        stamps::add(stamps::W_TAILS, t_tail);
        t_path = sh.t_path;
        have_path_tail = true;
      }
      const int top = t_path < PC - 1 ? t_path : PC - 1;
      const i64 pv[2] = {vtx, dval};
      if (top - pp <= kWarpCols) {
        shift_path(S, top, pp, pv, lane, 32, false);
        __syncwarp();
      } else {
        if (lane == 0) {
          sh.job = J_SHIFT_PATH;
          sh.top = top;
          sh.p = pp;
          sh.vals[0] = vtx;
          sh.vals[1] = dval;
        }
        call_block(tb, pr, S, sh, st, lane_in);
      }
      if (pp < PC) {
        const int tm = (t_path > pp ? t_path : pp) + 1;
        t_path = tm < PC ? tm : PC;
      }

      // ---- the occurrence loop ----
      const long long t_occ = stamps::now();
      for (i64 j = 0; j < occ_cnt && !ovf; ++j) {
        const int oe = static_cast<int>(j & 31);
        if (oe == 0 && (j > 0 || t > 0)) {
          prefetch_occ(tb, sh, lane, j, occ_lo, occ_cnt, vtx, fwd, ech, ev);
        }
        const i64 cj = sh.pf_cj[oe], ij = sh.pf_ij[oe], base = sh.pf_base[oe];
        const i64 jp = sh.pf_jp[oe], pfx = sh.pf_pfx[oe];
        const int fl = sh.pf_flags[oe];
        const i64 sj = (fl & 1) ? 1 : -1;
        const bool u = (fl & 2) != 0;
        // upper bound of (cj << 40) | ij among the live keys
        const i64 kq = static_cast<i64>((static_cast<u64>(cj) << 40) | static_cast<u64>(ij));
        const i64 nn = n;
        const int p = warp_search(IC, lane, [&](int mid) {
          const i64 key = mid < nn ? static_cast<i64>((static_cast<u64>(chr[mid]) << 40) |
                                                      static_cast<u64>(cmp[mid]))
                                   : kBig;
          return key > kq;
        });
        const int pc = clipi(p, IC - 1);
        const bool in_chr = p < n && chr[pc] == cj;
        const i64 fi_p = fi[pc], bi_p = bi[pc];
        const bool within = in_chr && (fi_p < bi_p ? fi_p : bi_p) <= ij &&
                            ij <= (fi_p > bi_p ? fi_p : bi_p);
        if (within) continue;
        const bool use_prev = fwd ? sj > 0 : sj < 0;
        const bool prev_ok = p - 1 >= 0 && chr[clipi(p - 1, IC - 1)] == cj;
        const bool cand_ok = use_prev ? prev_ok : in_chr;
        const int ccol = clipi(use_prev ? p - 1 : p, IC - 1);
        bool upd = false;
        i64 cs = 0, cend = 0, jp_c = 0, jp_o = 0;
        if (cand_ok) {
          // the candidate is on chromosome cj, so its table words are at base
          cs = sgn[ccol];
          cend = fwd ? bi[ccol] : fi[ccol];
          const i64 c_other = fwd ? fi[ccol] : bi[ccol];
          const i64 at_c = clip(wadd(base, cend), nj);
          jp_c = tb.jpos[at_c];
          const i64 jid_c = tb.jid[at_c];
          const i64 pfx_c = tb.used_pfx[clip(wadd(base, cend), tb.n_pfx - 1)];
          jp_o = tb.jpos[clip(wadd(base, c_other), nj)];
          const i64 start_i = fwd ? cend : ij, end_i = fwd ? ij : cend;
          const bool lo_is_cend = (sj > 0) == fwd;
          const i64 lo_slot = sj > 0 ? start_i : end_i, hi_slot = sj > 0 ? end_i : start_i;
          const bool used_between =
              hi_slot > lo_slot && wsub(lo_is_cend ? pfx : pfx_c, lo_is_cend ? pfx_c : pfx) > 0;
          const i64 ks = sj < 0 ? tb.k : 0;
          const i64 real_diff = wsub(wadd(fwd ? jp : jp_c, ks), wadd(fwd ? jp_c : jp, ks));
          const bool dir_ok = sj > 0 ? real_diff >= 0 : wsub(0, real_diff) >= 0;
          if (cs == sj && !used_between && dir_ok) {
            const i64 cvid = wmul(cs, jid_c);
            bool over = iabs(real_diff) > pr.b;
            if (!over) {
              const int cp = warp_search(PC, lane, [&](int mid) { return pvid[mid] >= cvid; });
              const i64 cdist = S.pdist[clipi(cp, PC - 1)];
              over = (fwd ? wsub(dval, cdist) : wsub(cdist, dval)) > pr.b;
            }
            bool compat = !over;
            if (over) {  // adjacency escape: start.Next() == end, chars match, next vid == ev
              if (fwd) {
                const i64 nxt = wadd(cend, sj);
                if (nxt >= 0 && nxt < tb.chr_len[clip(cj, tb.n_chr_len - 1)] && nxt == ij) {
                  const i64 sq_off = tb.seq_off[clip(cj, tb.n_seq_off - 2)];
                  const i64 sq_len = wsub(tb.seq_off[clip(wadd(cj, 1), tb.n_seq_off - 1)], sq_off);
                  const i64 nseq = tb.n_seq - 1;
                  i64 start_char;
                  if (sj > 0) {
                    start_char = wadd(jp_c, tb.k) < sq_len
                                     ? tb.seq[clip(wadd(wadd(sq_off, jp_c), tb.k), nseq)]
                                     : 0;
                  } else {
                    const i64 prev = comp(tb.seq[clip(wsub(wadd(sq_off, jp_c), 1), nseq)]);
                    start_char = jp_c > 0 && prev > 0 ? prev : 'N';
                  }
                  const i64 nvid = wmul(sj, tb.jid[clip(wadd(base, nxt > 0 ? nxt : 0), nj)]);
                  compat = start_char == ech && nvid == ev;
                }
              } else {
                compat = (fl & 4) != 0 && wadd(ij, sj) == cend;
              }
            }
            upd = compat && cvid != vtx;
          }
        }
        if (upd) {
          const bool cfin = (fwd ? S.b(F_BFIN) : S.b(F_FFIN))[ccol] != 0;
          if (!cfin) {  // ChangeBack / ChangeFront at the candidate
            const bool was_good = iabs(wsub(jp_o, jp_c)) >= pr.m;
            const bool now_good = iabs(wsub(jp_o, jp)) >= pr.m;
            if (lane == 0) {
              S.w(fwd ? F_BI : F_FI)[ccol] = ij;
              S.w(fwd ? F_BDIST : F_FDIST)[ccol] = dval;
              if (fwd ? cs > 0 : cs < 0) S.w(F_CMP)[ccol] = ij;
              if (!was_good && now_good) S.w(F_GOOD)[ccol] = next_good;
              if (u) S.b(fwd ? F_BFIN : F_FFIN)[ccol] = 1;
            }
            if (!was_good && now_good) next_good = wadd(next_good, 1);
            t_inst = t_inst > ccol + 1 ? t_inst : ccol + 1;
            __syncwarp();
          }
        } else if (!u) {
          if (n < IC) {  // insert a new instance at the bound
            const i64 vals[kInst] = {cj, sj, ij, ij, dval, dval, ij, 0, 0, -1, next_ins};
            if (!have_inst_tail) {
              const long long t_tail = stamps::now();
              warp0_wait(kInstTail);
              stamps::add(stamps::W_TAILS, t_tail);
              t_inst = t_inst > sh.t_inst ? t_inst : sh.t_inst;
              have_inst_tail = true;
            }
            const int top = t_inst < IC - 1 ? t_inst : IC - 1;
            if (top - p <= kWarpCols) {
              shift_inst(S, top, p, vals, lane, 32, false);
              __syncwarp();
            } else {
              if (lane == 0) {
                sh.job = J_SHIFT_INST;
                sh.top = top;
                sh.p = p;
                for (int f = 0; f < kInst; ++f) sh.vals[f] = vals[f];
              }
              call_block(tb, pr, S, sh, st, lane_in);
              stamps::count(stamps::C_BLOCK_SHIFTS, 1);
            }
            stamps::count(stamps::C_INSERTS, 1);
            const int tm = (t_inst > p ? t_inst : p) + 1;
            t_inst = tm < IC ? tm : IC;
            n = wadd(n, 1);
            next_ins = wadd(next_ins, 1);
          } else {
            ovf = 1;
          }
        }
      }

      stamps::add(stamps::W_OCC, t_occ);
      if (fwd) {
        rf = dval;
        rv = ev;
      } else {
        lf = dval;
        lv = eu;
      }
      if (!kResident && (after || ovf || t + 1 == pr.limit)) {  // the last push: the live lane is final
        store_lane(1);
        live_stored = true;
      }
      score = score_now();
      have_score = true;
      if (score > best) {
        best = score;
        const int mask = (fwd ? 2 : 0) | (score > 0 ? 4 : 0);
        has_snap = has_snap || score > 0;
        if (mask) {
          store_lane(mask);
          pending = true;
        }
      }
    }
    it = wadd(it, d);
    last = success;
    active = !after && !ovf;
  }
  // the loop's time but its tail waits, scores and stores
  stamps::add(stamps::W_PUSHES, t_loop + (stamps::sum(stamps::W_TAILS) +
                                          stamps::sum(stamps::W_SCORES) +
                                          stamps::sum(stamps::W_STORES) - inner0));

  if (!have_score) score = serve ? init[0] : score_now();  // the lane as it was
  if constexpr (kResident) {  // the lane as the walk leaves it, beside its slab
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kRegs; ++q) keep->reg[q] = reg[q];
      keep->best = best;
      keep->has_snap = has_snap;
      keep->t_inst = t_inst;
      keep->t_path = t_path;
      keep->stored = stored;
      keep->alias = alias;
    }
  } else if (valid && pushes > 0) {
    if (!live_stored) store_lane(1);
    if (lane == 0) {
      static_cast<i64*>(st.p[3 * kLaneFields])[lane_in] = best;
      static_cast<uint8_t*>(st.p[3 * kLaneFields + 1])[lane_in] = has_snap;
    }
  }
  if (walking) {  // each barrier the helpers arrived at is met once
    const long long t_tail = stamps::now();
    if (!have_path_tail) warp0_wait(kPathTail);
    if (!have_inst_tail) warp0_wait(kInstTail);
    stamps::add(stamps::W_TAILS, t_tail);
  }
  if (lane == 0) sh.job = J_DONE;
  __syncwarp();
  block_sync();
  RowOut out;
  out.it = it;
  out.score = score;
  out.n = n;
  out.rf = rf;
  out.lf = lf;
  out.pushes = pushes;
  out.occ_steps = occ_steps;
  out.last = last;
  out.after = after;
  out.ovf = ovf != 0;
  for (int q = 0; q < 5; ++q) out.init[q] = init[q];
  return out;
}

}  // namespace walk
}  // namespace
