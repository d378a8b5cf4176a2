// K6 lcb_vote: the LCB vote (MostPopularVertex over a lane's instances) for
// both device LCB engines, for Hopper (sm_90a).  A row's vote is
// lcb_vote.cuh's vote_row<false>; K7 lcb_step's blocks run vote_row<true>,
// the same vote on a lane kept in shared memory; this file holds the
// kernel a row a block, its chain probe and its C interface.
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

#include "lcb_vote.cuh"

using namespace vote;

namespace {

struct Args {
  const i64* idx;
  const uint8_t* valid;
  const uint8_t* fwd;
  const uint8_t* try_used;
};

__global__ void __launch_bounds__(kThreads, 2) lcb_vote_kernel(Lanes ln, Tables tb, Args a,
                                                            Params pr, i64* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  __shared__ i64 o[kOut];
  const i64 row = blockIdx.x;
  const int spilled = vote_row<false>(ln, tb, pr, clip(a.idx[row], pr.L - 1), row,
                                      a.valid[row] != 0, a.fwd[row] != 0, a.try_used[row] != 0,
                                      smem, sh, o);
  if (threadIdx.x < kOut) out[threadIdx.x * pr.A + row] = o[threadIdx.x];
  if (threadIdx.x == 0 && pr.spilled != nullptr) pr.spilled[row] = spilled;
}


// The chain floor's probe of one vote whose windows end in their first
// round of 32 slots: `iters` rounds, each the vote's dependent chain at its
// least: the columns' words (three dependent loads served from L2: a lane
// field, its chromosome's offset, the end's junction), the window slot's
// table words (one load from L2) and its path search (ten dependent shared
// loads, PC 1,024), a ballot and the hash insert's three shared atomics, the
// winner's warp reduction (five shuffles), and the vote's seven barriers of
// 256 threads.
__global__ void __launch_bounds__(kThreads) lcb_vote_probe_kernel(const i64* table, int iters,
                                                                  i64* out) {
  __shared__ i64 path[1024];
  __shared__ unsigned long long slots[64];
  __shared__ i64 zero;
  const int tid = threadIdx.x;
  for (int j = tid; j < 1024; j += kThreads) path[j] = 2LL * j;
  if (tid < 64) slots[tid] = 0;
  if (tid == 0) zero = 0;
  __syncthreads();
  i64 v = 0;
  for (int step = 0; step < iters; ++step) {
    v = __ldcg(table + v);
    v = __ldcg(table + v);
    v = __ldcg(table + v);
    __syncthreads();
    __syncthreads();
    __syncthreads();
    __syncthreads();
    v = __ldcg(table + v);
    int lo = 0, hi = 1024;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (path[mid] < v) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, lo < 1024);
    const int h = static_cast<int>(v + m) & 63;
    atomicCAS(slots + h, 0ULL, 1ULL);
    atomicAdd(slots + h, 1ULL);
    const unsigned long long got = atomicMax(slots + h, 1ULL);
    __syncthreads();
    i64 x = static_cast<i64>(got);
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    __syncthreads();
    __syncthreads();
    v += zero * (x + lo);
  }
  if (tid == 0) out[0] = v;
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

// table: n int64 entries, each an index into the table (a pointer chase);
// out: one int64.
extern "C" int sz_lcb_vote_probe(const void* table, int iters, void* out, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  lcb_vote_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(table), iters, static_cast<i64*>(out));
  return static_cast<int>(cudaGetLastError());
}
