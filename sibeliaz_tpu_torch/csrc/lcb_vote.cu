// K6 lcb_vote: the LCB vote (MostPopularVertex over a lane's instances) for
// both device LCB engines, for Hopper (sm_90a).
//
// Replaces sibeliaz_tpu/lcb/resident.py::_vote_gathered (:214-345), jitted
// as _vote_round (:348), and the vote with its used-retry inside the
// while_loop of sibeliaz_tpu/lcb/fused.py (:241-260, the retry under a
// lax.cond); XLA programs, not Pallas kernels.  Its plain version is
// lcb/vote.py::vote_plain.
//
// Per gathered row r (lane idx[r], clipped to [0, L); rows may repeat and
// come in any order; an invalid row has n = 0 and votes for nothing):
//   * the voting instances: the live columns (col < n, of the first CAP),
//     the good ones where at least 2 are good; their order sequence
//     (good_seq or insert_seq to match); of them those whose end vertex
//     (bi forward, fi backward) is the lane's path end (rv forward, lv
//     backward) have a window;
//   * each window: d = 1..W junctions on from the end, while the step is in
//     range, within (d < depth, or |pos - opos| <= b with both shifted by k
//     on the minus strand), off the lane's path (torch.searchsorted over the
//     whole pvid row, then pp < pn) and allowed by `used` unless try_used;
//     the window ends at its first failure, and a window alive at d = W
//     sets the row's overflow flag;
//   * the order-free winner (docs/design.md §3): each alive entry (i, d)
//     votes weight |jpos[fi] - jpos[bi]| + 1 of instance i for its vid; per
//     vid the total and the group's final entry, the largest in the plain
//     version's arrival order (instances by (order sequence, column), then
//     d); the winner is the lexicographic minimum of (-total, the final
//     entry's origin key (s>0)<<62 | chr<<40 | end, its arrival
//     order_seq * W + d - 1, vid); the origin columns are the winning
//     entry's instance's (chr, end, s).  Where nothing votes, or the least
//     -total is not below 0, the row reports vid 0, count 0 and origin 0.
// With `retry`, a valid forward row whose vote found no winner and no
// overflow votes again with try_used set, in the same block, and that
// vote's results replace the first's (the fused engine's used-retry, with
// no read of the card).  Every table index is clipped as in the plain
// version; sums and products wrap at 64 bits as torch's do.
//
// What bounds it: the bytes of each row's instance columns and path row,
// and the table words (jpos, jid, used) of every evaluated window slot, all
// read once; at the engines' shapes a few KB a row, far under the launch
// and the chain of dependent loads (the lane's columns, their junction
// words, then the windows), so in practice latency.
// The design:
//   * one block of 256 threads a row; the row's instance columns and derived
//     values (end, base, chromosome length, origin position and key, weight,
//     order sequence) and its whole pvid row in shared memory;
//   * one warp a voting instance walks its window 32 d's at a time, one a
//     lane (the table words of neighbouring lanes are neighbouring), and a
//     ballot finds the first failing d: only len + 1 slots of a window are
//     evaluated, not all W;
//   * the group-by is an open-addressing hash table keyed by vid in shared
//     memory (2,048 slots at most): a 64-bit atomicAdd for the total and a
//     64-bit atomicMax on (order sequence or its rank, column, d) packed
//     for the final entry.  Sums and maxima are order-free, so the result
//     does not depend on the atomics' order;
//   * a row whose vids claim more than half the table spills: it takes a
//     slice of a device workspace that the wrapper allocates and keeps (a
//     pool of a few slices, 2 slots an element of CAP * W, 24 bytes a slot,
//     each behind a lock word), redoes its inserts there (the window lengths
//     kept), cleared to the size its alive entries need, and hands the slice
//     back.  Where every slice is taken the row waits for one: a holder
//     waits for nothing, so it ends and frees its slice;
//   * an order sequence outside [0, 2^40) (never seen from the engines) is
//     replaced by its rank among the row's voting instances, so the packed
//     key keeps the plain version's order whatever the data;
//   * the winner is a block-wide minimum over the occupied slots.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

struct Args {
  const i64* idx;
  const uint8_t* valid;
  const uint8_t* fwd;
  const uint8_t* try_used;
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

struct Cand {
  i64 neg, okey, arr, vid;
  int col;  // -1: none
};

struct Shared {
  int n_good, n_voters, nofit, spill, claimed, ovf;
  int E;  // alive entries of the current vote
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
// `limit` sets *spill (the row then redoes its inserts in the workspace).
// A table of H slots never holds more than limit + kThreads keys, so a free
// slot is always found.
__device__ void insert_shared(const Table& t, i64 vid, u64 w, u64 fk, int* claimed, int limit,
                              volatile int* spill) {
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
        if (atomicAdd(claimed, 1) >= limit) *spill = 1;
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
  const i64 vid = wmul(s, __ldg(tb.jid + flat));
  *vid_out = vid;
  if (!(it >= 0 && it < cl.clen[c])) return false;
  if (!(d < depth)) {
    const i64 pos = wadd(__ldg(tb.jpos + flat), s < 0 ? tb.k : 0);
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
  if (!tu && (s > 0 || it > 0)) {
    const i64 uslot = s > 0 ? flat : flat - 1;
    if (__ldg(tb.used + clip(uslot, tb.n_used - 1)) > 0) return false;
  }
  return true;
}

__device__ __forceinline__ u64 final_key(const Cols& cl, int c, i64 d) {
  return (cl.skey[c] << 24) | (static_cast<u64>(c) << 12) | static_cast<u64>(d - 1);
}

// One vote of the row (try_used `tu`): the windows, the group-by, the
// winner.  Writes o[0..5] (thread 0's copy is the result).
__device__ void vote(const Tables& tb, const Lanes& ln, const Params& pr, const Cols& cl,
                     const Table& tab, Shared& sh, const i64* pvid, i64 lane, i64 row, bool fwd,
                     bool tu, i64 pn, i64* o) {
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  for (int h = tid; h < tab.slots; h += kThreads) {
    tab.key[h] = kEmpty;
    tab.tot[h] = 0;
    tab.fin[h] = 0;
  }
  if (tid == 0) {
    sh.spill = 0;
    sh.claimed = 0;
    sh.ovf = 0;
    sh.E = 0;
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
        insert_shared(tab, vid, w, final_key(cl, c, d), &sh.claimed, limit, spill);
      }
      len += first;
      if (first < 32) break;
    }
    if (lid == 0) {
      cl.vlen[v] = len;
      if (len == pr.W) sh.ovf = 1;
      atomicAdd(&sh.E, len);
    }
  }
  __syncthreads();
  Table t = tab;
  if (sh.spill) {
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
  // the winner: a block-wide minimum over the occupied slots
  Cand best;
  best.col = -1;
  best.neg = best.okey = best.arr = best.vid = 0;
  for (int h = tid; h < t.slots; h += kThreads) {
    const bool shared = !sh.spill;
    const i64 k = shared ? t.key[h] : static_cast<i64>(__ldcg(reinterpret_cast<u64*>(t.key + h)));
    if (k == kEmpty) continue;
    const u64 tot = shared ? t.tot[h] : __ldcg(t.tot + h);
    const u64 fk = shared ? t.fin[h] : __ldcg(t.fin + h);
    Cand cd;
    cd.col = static_cast<int>((fk >> 12) & 0xfff);
    const i64 d = static_cast<i64>(fk & 0xfff) + 1;
    cd.neg = static_cast<i64>(0ULL - tot);
    cd.okey = cl.okey[cd.col];
    cd.arr = wadd(wmul(cl.seq[cd.col], pr.W), d - 1);
    cd.vid = k;
    if (before(cd, best)) best = cd;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const Cand other = shfl_down(best, off);
    if (before(other, best)) best = other;
  }
  if (lid == 0) sh.red[warp] = best;
  __syncthreads();
  if (tid == 0) {
    for (int q = 1; q < kWarps; ++q) {
      if (before(sh.red[q], best)) best = sh.red[q];
    }
    const bool has = best.col >= 0 && best.neg < 0;
    o[0] = has ? best.vid : 0;
    o[1] = has ? wsub(0, best.neg) : 0;
    o[2] = has ? ln.p[L_CHR][lane * pr.IC + best.col] : 0;
    o[3] = has ? cl.end[best.col] : 0;
    o[4] = has ? cl.s[best.col] : 0;
    o[5] = sh.ovf;
  }
  __syncthreads();
  if (tid == 0 && sh.spill) {
    // every read of the slice is done (the barrier above): hand it back
    __threadfence();
    atomicExch(pr.ws + sh.slice, 0ULL);
  }
}

__global__ void __launch_bounds__(kThreads, 2) lcb_vote_kernel(Lanes ln, Tables tb, Args a,
                                                            Params pr, i64* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const i64 row = blockIdx.x;
  const int H = pr.H, CAP = pr.CAP;
  Table tab;
  tab.key = reinterpret_cast<i64*>(smem);
  tab.tot = reinterpret_cast<u64*>(tab.key + H);
  tab.fin = tab.tot + H;
  tab.slots = H;
  Cols cl;
  i64* col0 = reinterpret_cast<i64*>(tab.fin + H);
  cl.okey = col0;
  cl.end = col0 + CAP;
  cl.base = col0 + 2 * CAP;
  cl.clen = col0 + 3 * CAP;
  cl.opos = col0 + 4 * CAP;
  cl.w = col0 + 5 * CAP;
  cl.seq = col0 + 6 * CAP;
  cl.s = col0 + 7 * CAP;
  cl.skey = reinterpret_cast<u64*>(col0 + 8 * CAP);
  cl.voters = reinterpret_cast<int*>(col0 + 9 * CAP);
  cl.vlen = cl.voters + round8(CAP);
  i64* pvid = reinterpret_cast<i64*>(cl.vlen + round8(CAP));

  const i64 lane = clip(a.idx[row], pr.L - 1);
  const bool valid = a.valid[row] != 0;
  const bool fwd = a.fwd[row] != 0;
  const bool tu = a.try_used[row] != 0;
  const i64 n = valid ? ln.p[L_N][lane] : 0;
  const i64 start = valid ? (fwd ? ln.p[L_RV][lane] : ln.p[L_LV][lane]) : kBig;
  const i64 pn = ln.p[L_PN][lane];
  if (tid == 0) {
    sh.n_good = 0;
    sh.n_voters = 0;
    sh.nofit = 0;
  }
  for (int j = tid; j < pr.PC; j += kThreads) pvid[j] = ln.p[L_PVID][lane * pr.PC + j];
  const i64 at = lane * pr.IC;
  __syncthreads();
  for (int c = tid; c < CAP; c += kThreads) {
    if (c < n && ln.p[L_GOOD][at + c] >= 0) atomicAdd(&sh.n_good, 1);
  }
  __syncthreads();
  const bool use_good = sh.n_good >= 2;
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
    cl.end[c] = end;
    cl.base[c] = base;
    cl.clen[c] = __ldg(tb.chr_len + clip(chr, tb.n_chr_len - 1));
    cl.opos[c] = wadd(__ldg(tb.jpos + clip(wadd(base, end), nj)), s < 0 ? tb.k : 0);
    cl.w[c] = wadd(iabs(wsub(jf, jb)), 1);
    cl.seq[c] = seq;
    cl.skey[c] = static_cast<u64>(seq);
    cl.s[c] = s;
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
  __shared__ i64 o[kOut];
  vote(tb, ln, pr, cl, tab, sh, pvid, lane, row, fwd, tu, pn, o);
  int spilled = sh.spill;
  if (pr.retry && valid && fwd && o[0] == 0 && o[5] == 0) {
    vote(tb, ln, pr, cl, tab, sh, pvid, lane, row, fwd, true, pn, o);
    spilled |= sh.spill;
  }
  if (tid < kOut) out[tid * pr.A + row] = o[tid];
  if (tid == 0 && pr.spilled != nullptr) pr.spilled[row] = spilled;
}

cudaError_t set_vote_attributes(long long smem) {
  cudaError_t err = cudaFuncSetAttribute(
      lcb_vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(lcb_vote_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

bool shape_ok(int PC, int CAP, int W) {
  return PC >= 1 && CAP >= 1 && W >= 1 && CAP <= kMaxCols && W <= kMaxCols &&
         smem_bytes(CAP, PC, table_slots(CAP, W)) <= kMaxSmem;
}

}  // namespace

// The workspace words a slice of a vote at CAP (the columns voted, after the
// n_max cut) and W takes: 3 * slots, slots a power of two of at least
// 2 * CAP * W; 0 where no row can spill (CAP * W at most half the shared
// table); -1 for a shape the kernel does not take.  A call's workspace is
// kMaxPool lock words, zero between calls, then `pool` such slices.
extern "C" long long sz_lcb_vote_workspace_words(int PC, int CAP, int W) {
  if (!shape_ok(PC, CAP, W)) return -1;
  const int H = table_slots(CAP, W);
  if (static_cast<long long>(CAP) * W <= spill_limit(H)) return 0;
  long long slots = 64;
  while (slots < 2LL * CAP * W) slots *= 2;
  return 3 * slots;
}

// lanes: host array of 11 device pointers (chr, s, fi, bi, good_seq,
// insert_seq: [L, IC]; n: [L]; pvid: [L, PC]; pn, rv, lv: [L]; all int64,
// row-major).  tables: host array of 5 device pointers (chr_off, chr_len,
// jpos, jid: int64; used: uint8); table_lens: their lengths (chr_off,
// chr_len, jpos = jid, used), each at least 1.  args: host array of 4
// device pointers (idx: [A] int64; valid, fwd, try_used: [A] bool).  out:
// [6, A] int64 (best_vid, best_cnt, ochr, oidx, ostr, overflow).  ws:
// kMaxPool lock words (zero), then `pool` (1 to kMaxPool) slices of
// sz_lcb_vote_workspace_words(PC, CAP, W) words; or null where that is 0.
// spilled: [A] int64, 1 where a vote of the row took the workspace, or
// null.  CAP: the columns voted (at most IC).  Returns a CUDA error code
// (0: launched).
extern "C" int sz_lcb_vote(const long long* lanes, const long long* tables,
                           const long long* table_lens, const long long* args, void* out,
                           void* ws, int pool, void* spilled, long long L, long long A, int IC,
                           int PC, int CAP, int W, long long k, long long depth, long long b,
                           int retry, void* stream) {
  if (L < 1 || A < 0 || A > 0x7fffffffLL || IC < 1 || CAP > IC || !shape_ok(PC, CAP, W)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long words = sz_lcb_vote_workspace_words(PC, CAP, W);
  if (words > 0 && (ws == nullptr || pool < 1 || pool > kMaxPool)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (A == 0) return 0;
  Lanes ln{};
  for (int q = 0; q < kLaneFields; ++q) ln.p[q] = reinterpret_cast<const i64*>(lanes[q]);
  Tables tb{};
  tb.chr_off = reinterpret_cast<const i64*>(tables[0]);
  tb.chr_len = reinterpret_cast<const i64*>(tables[1]);
  tb.jpos = reinterpret_cast<const i64*>(tables[2]);
  tb.jid = reinterpret_cast<const i64*>(tables[3]);
  tb.used = reinterpret_cast<const uint8_t*>(tables[4]);
  tb.n_chr_off = table_lens[0];
  tb.n_chr_len = table_lens[1];
  tb.n_j = table_lens[2];
  tb.n_used = table_lens[3];
  tb.k = k;
  Args a{};
  a.idx = reinterpret_cast<const i64*>(args[0]);
  a.valid = reinterpret_cast<const uint8_t*>(args[1]);
  a.fwd = reinterpret_cast<const uint8_t*>(args[2]);
  a.try_used = reinterpret_cast<const uint8_t*>(args[3]);
  Params pr{};
  pr.L = L;
  pr.A = A;
  pr.depth = depth;
  pr.b = b;
  pr.IC = IC;
  pr.PC = PC;
  pr.CAP = CAP;
  pr.W = W;
  pr.H = table_slots(CAP, W);
  pr.retry = retry;
  pr.ws = words > 0 ? static_cast<u64*>(ws) : nullptr;
  pr.ws_slots = words / 3;
  pr.pool = words > 0 ? pool : 0;
  pr.spilled = static_cast<i64*>(spilled);
  const long long smem = smem_bytes(CAP, PC, pr.H);
  const cudaError_t err = set_vote_attributes(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lcb_vote_kernel<<<static_cast<unsigned>(A), kThreads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(ln, tb, a, pr, static_cast<i64*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The vote blocks an SM holds at once at CAP, W and PC, or minus a CUDA
// error.
extern "C" int sz_lcb_vote_blocks_per_sm(int PC, int CAP, int W) {
  if (!shape_ok(PC, CAP, W)) return -static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(CAP, PC, table_slots(CAP, W));
  cudaError_t err = set_vote_attributes(smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lcb_vote_kernel, kThreads,
                                                        static_cast<size_t>(smem));
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
