// The LCB vote's device code: K6 lcb_vote's algorithm (csrc/lcb_vote.cu,
// whose head says what it computes and how), one row a call of vote_row.
// K6 runs it once a block; K7 lcb_step (csrc/lcb_step.cu) runs it once an
// outer step of its lane, so both kernels vote by this one source.
// vote_row takes every thread of a block of kThreads (256) and meets at
// __syncthreads; it holds a workspace slice only inside the call.
// vote_row<true> is K7's: its lane fields point at the lane's slab and
// registers in shared memory (lane 0 of them), so it reads its columns and
// its path row there and copies no pvid; its hash table is clear when it
// starts (the caller clears it once, with clear_table) and the vote clears
// the slots it claimed on its way out, so a vote touches only those; and
// its winner is taken over the claimed slots alone, by warp 0 where they
// are 32 at most.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "step_stamps.cuh"

namespace {
namespace vote {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTable = 2048;        // hash slots in shared memory, at most
constexpr int kMaxCols = 4096;         // CAP and W: 12 bits each in the packed key
constexpr i64 kBig = 1LL << 60;        // batched_push_device.BIG
constexpr i64 kEmpty = 0x7fffffffffffffffLL;  // a free slot's key (no vid below BIG is it)
constexpr i64 kSeqLimit = 1LL << 40;   // order sequences packed as they are below this
constexpr int kMaxSmem = 232448;       // the most a block may opt in to
constexpr int kLaneFields = 11;        // the lane fields the vote reads
constexpr int kOut = 6;                // best_vid, best_cnt, ochr, oidx, ostr, overflow
constexpr int kMaxPool = 64;           // workspace slices: lock words before the slices

// vote_row<true>'s counts of a row's work, in order
enum Count { C_VOTERS, C_WINDOWS, C_SLOTS, C_ENTRIES, kCounts };

// the lane fields, in the order of the C interface
enum LaneField { L_CHR, L_S, L_FI, L_BI, L_GOOD, L_INS, L_N, L_PVID, L_PN, L_RV, L_LV };

struct Lanes {
  const i64* p[kLaneFields];
};

struct Tables {
  const i64* chr_off;
  const i64* chr_len;
  const i64* jpos;
  const i64* jid;
  const uint8_t* used;
  i64 n_chr_off, n_chr_len, n_j, n_used;  // n_j: jpos and jid
  i64 k;
};

struct Params {
  i64 L, A, depth, b;
  int IC, PC, CAP, W, H;  // H: shared hash slots (a power of two)
  int retry;
  u64* ws;      // the workspace: kMaxPool lock words, then `pool` slices of
                // 3 * ws_slots words; or null
  i64 ws_slots;
  int pool;
  i64* spilled;  // per row: 1 where a vote of the row took the workspace, or null
};

__host__ __device__ inline int round8(int x) { return (x + 7) / 8 * 8; }

// The shared hash table's slots for a call's CAP and W: a power of two of
// at least 2 * CAP * W (64 at least), 2,048 at most.
__host__ __device__ inline int table_slots(int CAP, int W) {
  const long long need = 2LL * CAP * W;
  int h = 64;
  while (h < kMaxTable && h < need) h *= 2;
  return h;
}

// A row spills once its vids claim more than this many shared slots; a
// call whose rows cannot (CAP * W at most this) takes no workspace.
__host__ __device__ inline int spill_limit(int H) { return H / 2; }

// dynamic shared memory: the table (key, total, final words), nine int64
// column arrays of CAP, two int arrays of CAP, the pvid row
__host__ __device__ inline long long smem_bytes(int CAP, int PC, int H) {
  return 24LL * H + 72LL * CAP + 8LL * round8(CAP) + 8LL * PC;
}

// vote_row<true>'s: the table, six int64 column arrays of CAP (the
// instances' strands, ends and order sequences are the slab's rows), two
// int arrays of CAP and the list of claimed slots (spill_limit(H) ints);
// no pvid row (the slab's); 16-byte aligned
__host__ __device__ inline long long resident_smem_bytes(int CAP, int H) {
  return (24LL * H + 48LL * CAP + 8LL * round8(CAP) + 4LL * spill_limit(H) + 15) / 16 * 16;
}

struct Cand {
  i64 neg, okey, arr, vid;
  int col;  // -1: none
};

struct Shared {
  int n_good, n_voters, nofit, spill, claimed, ovf;
  int E;  // alive entries of the current vote
  int S;  // its evaluated window slots (vote_row<true> alone)
  int slice;  // the workspace slice the row holds while it spills
  Cand red[kWarps];
};

// ---- arithmetic as torch's ----

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
__device__ __forceinline__ i64 wmul(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) * static_cast<u64>(b));
}
__device__ __forceinline__ i64 iabs(i64 a) { return a < 0 ? wsub(0, a) : a; }

__device__ __forceinline__ u64 mix(i64 v) {  // splitmix64's finaliser
  u64 x = static_cast<u64>(v);
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// (-total, okey, arrival, vid): a before b; a candidate with col < 0 is none
__device__ __forceinline__ bool before(const Cand& a, const Cand& b) {
  if (a.col < 0) return false;
  if (b.col < 0) return true;
  if (a.neg != b.neg) return a.neg < b.neg;
  if (a.okey != b.okey) return a.okey < b.okey;
  if (a.arr != b.arr) return a.arr < b.arr;
  return a.vid < b.vid;
}

__device__ __forceinline__ Cand shfl_down(const Cand& c, int off) {
  Cand o;
  o.neg = __shfl_down_sync(0xffffffffu, c.neg, off);
  o.okey = __shfl_down_sync(0xffffffffu, c.okey, off);
  o.arr = __shfl_down_sync(0xffffffffu, c.arr, off);
  o.vid = __shfl_down_sync(0xffffffffu, c.vid, off);
  o.col = __shfl_down_sync(0xffffffffu, c.col, off);
  return o;
}

// A hash table: keys, totals and final-entry words, `slots` a power of two.
struct Table {
  i64* key;
  u64* tot;
  u64* fin;
  int slots;
};

// Adds an entry to the table in shared memory; a slot newly claimed past
// `limit` sets *spill (the row then redoes its inserts in the workspace),
// one below it goes to `list` (where given) at its claim's rank.  A table
// of H slots never holds more than limit + kThreads keys, so a free slot is
// always found.
__device__ void insert_shared(const Table& t, i64 vid, u64 w, u64 fk, int* claimed, int limit,
                              volatile int* spill, int* list) {
  const int m = t.slots - 1;
  int h = static_cast<int>(mix(vid)) & m;
  volatile i64* key = t.key;
  while (true) {
    const i64 k = key[h];
    if (k == vid) break;
    if (k == kEmpty) {
      const u64 prev = atomicCAS(reinterpret_cast<u64*>(t.key + h), static_cast<u64>(kEmpty),
                                 static_cast<u64>(vid));
      if (prev == static_cast<u64>(kEmpty)) {
        const int q = atomicAdd(claimed, 1);
        if (q >= limit) {
          *spill = 1;
        } else if (list != nullptr) {
          list[q] = h;
        }
        break;
      }
      if (static_cast<i64>(prev) == vid) break;
    }
    h = (h + 1) & m;
  }
  atomicAdd(t.tot + h, w);
  atomicMax(t.fin + h, fk);
}

// The same in a workspace slice in device memory (read through L2: the
// slots change under the block's atomics).  The slice holds at least twice
// the row's alive entries, so a free slot is always found.
__device__ void insert_global(const Table& t, i64 vid, u64 w, u64 fk) {
  const int m = t.slots - 1;
  int h = static_cast<int>(mix(vid)) & m;
  while (true) {
    const i64 k = static_cast<i64>(__ldcg(reinterpret_cast<const u64*>(t.key + h)));
    if (k == vid) break;
    if (k == kEmpty) {
      const u64 prev = atomicCAS(reinterpret_cast<u64*>(t.key + h), static_cast<u64>(kEmpty),
                                 static_cast<u64>(vid));
      if (prev == static_cast<u64>(kEmpty) || static_cast<i64>(prev) == vid) break;
    }
    h = (h + 1) & m;
  }
  atomicAdd(t.tot + h, w);
  atomicMax(t.fin + h, fk);
}

// A voting instance's derived values, in shared memory by column.
struct Cols {
  i64 *okey, *end, *base, *clen, *opos, *w, *seq, *s;
  u64* skey;  // the order sequence as packed: itself, or its rank
  int* voters;  // the voting columns (at the lane's path end), in any order
  int* vlen;    // by voter: the window's alive length
};

// The window slot d of the instance at column c: whether the window goes
// on there, and the vid it meets.
__device__ __forceinline__ bool slot_ok(const Tables& tb, const Cols& cl, int c, i64 d, bool fwd,
                                        bool tu, const i64* pvid, int PC, i64 pn, i64 depth,
                                        i64 b, i64* vid_out) {
  const i64 s = cl.s[c];
  const i64 it = wadd(cl.end[c], wmul(s, fwd ? d : -d));
  const i64 flat = clip(wadd(cl.base[c], it), tb.n_j - 1);
  // the slot's three table words at once (one round of latency, not three)
  const i64 jid = __ldg(tb.jid + flat);
  const i64 jpos = __ldg(tb.jpos + flat);
  const uint8_t used = __ldg(tb.used + clip(s > 0 ? flat : flat - 1, tb.n_used - 1));
  const i64 vid = wmul(s, jid);
  *vid_out = vid;
  if (!(it >= 0 && it < cl.clen[c])) return false;
  if (!(d < depth)) {
    const i64 pos = wadd(jpos, s < 0 ? tb.k : 0);
    if (!(iabs(wsub(pos, cl.opos[c])) <= b)) return false;
  }
  // torch.searchsorted(pvid row, vid), left: over the whole row
  int lo = 0, hi = PC;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(pvid[mid] >= vid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const i64 at = lo < PC ? pvid[lo] : kBig;
  if (at == vid && static_cast<i64>(lo) < pn) return false;
  if (!tu && (s > 0 || it > 0) && used > 0) return false;
  return true;
}

__device__ __forceinline__ u64 final_key(const Cols& cl, int c, i64 d) {
  return (cl.skey[c] << 24) | (static_cast<u64>(c) << 12) | static_cast<u64>(d - 1);
}

// The winner's outputs o[0..5] from the block's best candidate (thread 0).
__device__ __forceinline__ void emit(const Lanes& ln, const Params& pr, const Cols& cl,
                                     const Cand& best, i64 lane, int ovf, i64* o) {
  const bool has = best.col >= 0 && best.neg < 0;
  o[0] = has ? best.vid : 0;
  o[1] = has ? wsub(0, best.neg) : 0;
  o[2] = has ? ln.p[L_CHR][lane * pr.IC + best.col] : 0;
  o[3] = has ? cl.end[best.col] : 0;
  o[4] = has ? cl.s[best.col] : 0;
  o[5] = ovf;
}

// The candidate of an occupied slot (key k, total tot, final entry fk).
__device__ __forceinline__ Cand cand_of(const Params& pr, const Cols& cl, i64 k, u64 tot,
                                        u64 fk) {
  Cand cd;
  cd.col = static_cast<int>((fk >> 12) & 0xfff);
  const i64 d = static_cast<i64>(fk & 0xfff) + 1;
  cd.neg = static_cast<i64>(0ULL - tot);
  cd.okey = cl.okey[cd.col];
  cd.arr = wadd(wmul(cl.seq[cd.col], pr.W), d - 1);
  cd.vid = k;
  return cd;
}

__device__ __forceinline__ Cand warp_min(Cand best) {
  for (int off = 16; off > 0; off >>= 1) {
    const Cand other = shfl_down(best, off);
    if (before(other, best)) best = other;
  }
  return best;
}

// One vote of the row (try_used `tu`): the windows, the group-by, the
// winner.  Writes o[0..5] (thread 0's copy is the result).  `stamp`: the
// vote's windows and winner go to the step's split (step_stamps.cuh).
// kResident: the table is clear on entry and cleared again on the way out,
// its claimed slots listed in `list`.
template <bool kResident>
__device__ void vote(const Tables& tb, const Lanes& ln, const Params& pr, const Cols& cl,
                     const Table& tab, Shared& sh, const i64* pvid, i64 lane, i64 row, bool fwd,
                     bool tu, i64 pn, i64* o, bool stamp, int* list) {
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const long long t_windows = stamps::now();
  if (!kResident) {
    for (int h = tid; h < tab.slots; h += kThreads) {
      tab.key[h] = kEmpty;
      tab.tot[h] = 0;
      tab.fin[h] = 0;
    }
  }
  if (tid == 0) {
    sh.spill = 0;
    sh.claimed = 0;
    sh.ovf = 0;
    sh.E = 0;
    sh.S = 0;
  }
  __syncthreads();
  const int limit = spill_limit(tab.slots);
  volatile int* spill = &sh.spill;
  // the windows: a warp an instance, 32 slots at a time
  for (int v = warp; v < sh.n_voters; v += kWarps) {
    const int c = cl.voters[v];
    const u64 w = static_cast<u64>(cl.w[c]);
    int len = 0;
    for (int d0 = 1; d0 <= pr.W; d0 += 32) {
      const i64 d = d0 + lid;
      i64 vid = 0;
      const bool ok = d <= pr.W &&
                      slot_ok(tb, cl, c, d, fwd, tu, pvid, pr.PC, pn, pr.depth, pr.b, &vid);
      const unsigned fail = __ballot_sync(0xffffffffu, !ok);
      const int first = fail ? __ffs(fail) - 1 : 32;
      if (lid < first && vid < kBig && !*spill) {
        insert_shared(tab, vid, w, final_key(cl, c, d), &sh.claimed, limit, spill, list);
      }
      len += first;
      if (first < 32) break;
    }
    if (lid == 0) {
      cl.vlen[v] = len;
      if (len == pr.W) sh.ovf = 1;
      atomicAdd(&sh.E, len);
      // the slots evaluated: the alive ones and the one that ends the window
      if (kResident) atomicAdd(&sh.S, len < pr.W ? len + 1 : len);
    }
  }
  __syncthreads();
  // read once by every thread here: thread 0 resets them at the next vote
  const int spilled = sh.spill, claimed = sh.claimed;
  Table t = tab;
  if (spilled) {
    // the workspace route: a free slice of the pool (waiting where none
    // is), cleared to twice the row's entries
    if (pr.ws == nullptr || pr.pool < 1) __trap();
    if (tid == 0) {
      const int first = static_cast<int>(row % pr.pool);
      int q = first;
      while (atomicCAS(pr.ws + q, 0ULL, 1ULL) != 0ULL) {
        q = q + 1 == pr.pool ? 0 : q + 1;
        if (q == first) __nanosleep(500);
      }
      __threadfence();
      sh.slice = q;
    }
    __syncthreads();
    int slots = 64;
    while (slots < 2LL * sh.E) slots *= 2;
    u64* slice = pr.ws + kMaxPool + static_cast<i64>(sh.slice) * 3 * pr.ws_slots;
    t.key = reinterpret_cast<i64*>(slice);
    t.tot = slice + pr.ws_slots;
    t.fin = slice + 2 * pr.ws_slots;
    t.slots = slots;
    for (int h = tid; h < slots; h += kThreads) {
      t.key[h] = kEmpty;
      t.tot[h] = 0;
      t.fin[h] = 0;
    }
    __syncthreads();
    for (int v = warp; v < sh.n_voters; v += kWarps) {
      const int c = cl.voters[v];
      const int len = cl.vlen[v];
      const i64 s = cl.s[c];
      const u64 w = static_cast<u64>(cl.w[c]);
      for (int d0 = 1; d0 <= len; d0 += 32) {
        const i64 d = d0 + lid;
        if (d > len) break;
        const i64 it = wadd(cl.end[c], wmul(s, fwd ? d : -d));
        const i64 vid = wmul(s, __ldg(tb.jid + clip(wadd(cl.base[c], it), tb.n_j - 1)));
        if (vid < kBig) insert_global(t, vid, w, final_key(cl, c, d));
      }
    }
    __syncthreads();
  }
  if (stamp) stamps::add(stamps::V_WINDOWS, t_windows);
  const long long t_winner = stamps::now();
  const int ovf = sh.ovf;
  Cand best;
  best.col = -1;
  best.neg = best.okey = best.arr = best.vid = 0;
  if (kResident && !spilled && claimed <= 32) {
    // the winner of at most 32 vertices: warp 0, a claimed slot a lane
    if (warp == 0) {
      if (lid < claimed) {
        const int h = list[lid];
        best = cand_of(pr, cl, t.key[h], t.tot[h], t.fin[h]);
      }
      best = warp_min(best);
      if (tid == 0) emit(ln, pr, cl, best, lane, ovf, o);
    }
  } else {
    // the winner: a block-wide minimum over the occupied slots (a resident
    // row that did not spill: the claimed ones)
    const bool listed = kResident && !spilled;
    const int n_slots = listed ? claimed : t.slots;
    for (int q = tid; q < n_slots; q += kThreads) {
      const int h = listed ? list[q] : q;
      const i64 k = spilled ? static_cast<i64>(__ldcg(reinterpret_cast<u64*>(t.key + h)))
                            : t.key[h];
      if (k == kEmpty) continue;
      const u64 tot = spilled ? __ldcg(t.tot + h) : t.tot[h];
      const u64 fk = spilled ? __ldcg(t.fin + h) : t.fin[h];
      const Cand cd = cand_of(pr, cl, k, tot, fk);
      if (before(cd, best)) best = cd;
    }
    best = warp_min(best);
    if (lid == 0) sh.red[warp] = best;
    __syncthreads();
    if (tid == 0) {
      for (int q = 1; q < kWarps; ++q) {
        if (before(sh.red[q], best)) best = sh.red[q];
      }
      emit(ln, pr, cl, best, lane, ovf, o);
    }
  }
  __syncthreads();
  if (tid == 0 && spilled) {
    // every read of the slice is done (the barrier above): hand it back
    __threadfence();
    atomicExch(pr.ws + sh.slice, 0ULL);
  }
  if (kResident) {
    // the table clear for the next vote: the claimed slots, or all where the
    // row spilled (its claims past the limit are not listed)
    const int n_clear = spilled ? tab.slots : claimed;
    for (int q = tid; q < n_clear; q += kThreads) {
      const int h = spilled ? q : list[q];
      tab.key[h] = kEmpty;
      tab.tot[h] = 0;
      tab.fin[h] = 0;
    }
  }
  if (stamp) stamps::add(stamps::V_WINNER, t_winner);
}

// The hash table of H slots at `smem` cleared, by the whole block (K7's,
// once a launch; the caller meets at a barrier before the first vote).
__device__ void clear_table(unsigned char* smem, int H) {
  i64* key = reinterpret_cast<i64*>(smem);
  u64* rest = reinterpret_cast<u64*>(key + H);
  for (int h = threadIdx.x; h < H; h += kThreads) {
    key[h] = kEmpty;
    rest[h] = 0;
    rest[H + h] = 0;
  }
}

// One row's vote, by all kThreads threads of the block: lane `lane` (in
// [0, L)) as row `row` of the call (its first workspace slice is row %
// pool), with its valid, forward and try_used flags, and with pr.retry the
// used-retry.  smem: the block's dynamic shared memory, at least
// smem_bytes(CAP, PC, H), 16-byte aligned.  Writes best_vid, best_cnt,
// ochr, oidx, ostr, overflow to o[0..5] (shared memory; every thread may
// read them on return) and returns 1 where a vote took the workspace.
// kResident (K7): ln's fields are the lane's slab rows and registers in
// shared memory, read as lane 0 (`lane` 0), pvid the slab's own; smem
// holds resident_smem_bytes(CAP, H), the table clear (clear_table); and
// thread 0 adds the row's work to `counts` (kCounts words in shared memory):
// its voting instances, those at the lane's path end (a window each), the
// window slots evaluated and the alive entries, the last two the retry's
// where it retried (its windows are the longer: it also takes used
// junctions).
template <bool kResident>
__device__ int vote_row(const Lanes& ln, const Tables& tb, const Params& pr, i64 lane, i64 row,
                        bool valid, bool fwd, bool tu, unsigned char* smem, Shared& sh, i64* o,
                        i64* counts = nullptr) {
  const int tid = threadIdx.x;
  const long long t_cols = stamps::now();
  const int H = pr.H, CAP = pr.CAP;
  Table tab;
  tab.key = reinterpret_cast<i64*>(smem);
  tab.tot = reinterpret_cast<u64*>(tab.key + H);
  tab.fin = tab.tot + H;
  tab.slots = H;
  Cols cl;
  i64* col0 = reinterpret_cast<i64*>(tab.fin + H);
  cl.okey = col0;
  cl.base = col0 + CAP;
  cl.clen = col0 + 2 * CAP;
  cl.opos = col0 + 3 * CAP;
  cl.w = col0 + 4 * CAP;
  cl.skey = reinterpret_cast<u64*>(col0 + 5 * CAP);
  if (kResident) {  // the slab's rows (the order sequences' once use_good is known)
    cl.s = const_cast<i64*>(ln.p[L_S]);
    cl.end = const_cast<i64*>(fwd ? ln.p[L_BI] : ln.p[L_FI]);
    cl.seq = nullptr;
    cl.voters = reinterpret_cast<int*>(col0 + 6 * CAP);
  } else {
    cl.end = col0 + 6 * CAP;
    cl.seq = col0 + 7 * CAP;
    cl.s = col0 + 8 * CAP;
    cl.voters = reinterpret_cast<int*>(col0 + 9 * CAP);
  }
  cl.vlen = cl.voters + round8(CAP);
  int* list = kResident ? cl.vlen + round8(CAP) : nullptr;
  i64* row_pvid = reinterpret_cast<i64*>(cl.vlen + round8(CAP));
  const i64* pvid = kResident ? ln.p[L_PVID] : row_pvid;

  const i64 n = valid ? ln.p[L_N][lane] : 0;
  const i64 start = valid ? (fwd ? ln.p[L_RV][lane] : ln.p[L_LV][lane]) : kBig;
  const i64 pn = ln.p[L_PN][lane];
  if (tid == 0) {
    sh.n_good = 0;
    sh.n_voters = 0;
    sh.nofit = 0;
  }
  if (!kResident) {
    for (int j = tid; j < pr.PC; j += kThreads) row_pvid[j] = ln.p[L_PVID][lane * pr.PC + j];
  }
  const i64 at = lane * pr.IC;
  __syncthreads();
  for (int c = tid; c < CAP; c += kThreads) {
    if (c < n && ln.p[L_GOOD][at + c] >= 0) atomicAdd(&sh.n_good, 1);
  }
  __syncthreads();
  const bool use_good = sh.n_good >= 2;
  if (kResident) cl.seq = const_cast<i64*>(use_good ? ln.p[L_GOOD] : ln.p[L_INS]);
  // the columns: the voting instances' derived values
  for (int c = tid; c < CAP; c += kThreads) {
    const i64 good = ln.p[L_GOOD][at + c];
    if (!(c < n && (!use_good || good >= 0))) continue;
    const i64 chr = ln.p[L_CHR][at + c];
    const i64 s = ln.p[L_S][at + c];
    const i64 fi = ln.p[L_FI][at + c];
    const i64 bi = ln.p[L_BI][at + c];
    const i64 end = fwd ? bi : fi;
    const i64 base = __ldg(tb.chr_off + clip(chr, tb.n_chr_off - 2));
    const i64 nj = tb.n_j - 1;
    if (wmul(s, __ldg(tb.jid + clip(wadd(base, end), nj))) != start) continue;
    const i64 seq = use_good ? good : ln.p[L_INS][at + c];
    const i64 jf = __ldg(tb.jpos + clip(wadd(base, fi), nj));
    const i64 jb = __ldg(tb.jpos + clip(wadd(base, bi), nj));
    cl.okey[c] = static_cast<i64>((s > 0 ? 1ULL << 62 : 0ULL) | (static_cast<u64>(chr) << 40) |
                                  static_cast<u64>(end));
    cl.base[c] = base;
    cl.clen[c] = __ldg(tb.chr_len + clip(chr, tb.n_chr_len - 1));
    cl.opos[c] = wadd(__ldg(tb.jpos + clip(wadd(base, end), nj)), s < 0 ? tb.k : 0);
    cl.w[c] = wadd(iabs(wsub(jf, jb)), 1);
    cl.skey[c] = static_cast<u64>(seq);
    if (!kResident) {
      cl.end[c] = end;
      cl.seq[c] = seq;
      cl.s[c] = s;
    }
    if (seq < 0 || seq >= kSeqLimit) sh.nofit = 1;
    cl.voters[atomicAdd(&sh.n_voters, 1)] = c;
  }
  __syncthreads();
  if (sh.nofit) {
    // pack each voting instance's rank by (order sequence, column) instead
    for (int v = tid; v < sh.n_voters; v += kThreads) {
      const int c = cl.voters[v];
      u64 rank = 0;
      for (int q = 0; q < sh.n_voters; ++q) {
        const int e = cl.voters[q];
        rank += cl.seq[e] < cl.seq[c] || (cl.seq[e] == cl.seq[c] && e < c);
      }
      cl.skey[c] = rank;
    }
    __syncthreads();
  }
  stamps::add(stamps::V_COLS, t_cols);
  stamps::count(stamps::C_VOTES, 1);
  stamps::count(stamps::C_VOTERS, sh.n_voters);
  stamps::count(stamps::C_ROUNDS, (sh.n_voters + kWarps - 1) / kWarps);
  vote<kResident>(tb, ln, pr, cl, tab, sh, pvid, lane, row, fwd, tu, pn, o, true, list);
  int spilled = sh.spill;
  if (pr.retry && valid && fwd && o[0] == 0 && o[5] == 0) {
    const long long t_retry = stamps::now();
    vote<kResident>(tb, ln, pr, cl, tab, sh, pvid, lane, row, fwd, true, pn, o, false, list);
    stamps::add(stamps::V_RETRY, t_retry);
    stamps::count(stamps::C_RETRIES, 1);
    spilled |= sh.spill;
  }
  if (kResident && tid == 0) {
    counts[C_VOTERS] += use_good ? sh.n_good : n;  // n <= CAP: the caller retiers past it
    counts[C_WINDOWS] += sh.n_voters;
    counts[C_SLOTS] += sh.S;
    counts[C_ENTRIES] += sh.E;
  }
  return spilled;
}

}  // namespace vote
}  // namespace
