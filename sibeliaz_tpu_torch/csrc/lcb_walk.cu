// K5 lcb_walk: the LCB walk's device loop for both device LCB engines, for
// Hopper (sm_90a).
//
// Replaces the jax.lax.while_loop of pushes of
// sibeliaz_tpu/lcb/resident.py::_walk_device (:138) and
// sibeliaz_tpu/lcb/fused.py::_walk_chunk (:128), each iteration one
// resident.py::_push_score_snap (:102), whose push,
// batched_push_device.py::_push_impl_traced (:307), runs the pushed
// vertex's occurrences as a jax.lax.fori_loop (:528); XLA programs, not
// Pallas kernels. The port ran both loops from the host, one read of the
// card a push and about a hundred torch launches an occurrence step.
//
// Per row r of the call (lane rows[r], or lane r where rows is null; a row
// at or past L is a sentinel: it reads lane L-1, never walks and never
// writes the state), from the iterator (c, i, s) in direction fwd, while the
// lane is active, has not reached the target vid tvid and has not
// overflowed, for at most `limit` pushes:
//   * the edge at the iterator (edge_of), the pushed vertex and its
//     occurrence range;
//   * membership of the vertex in the path table (a lower bound over the
//     sorted pvid row) and, on success, its insertion with its distance;
//   * for each occurrence of the vertex, in order: the upper bound of the
//     occurrence's (chr << 40) | idx among the live instances' keys, the
//     within test, the strand-dependent candidate, the compatibility test
//     (used junctions between from the used prefix sums, the distance
//     bounds, the adjacency escape), then either ChangeBack/Front of the
//     candidate or the insertion of a new instance (its eleven fields
//     shifted right at the bound), an overflow at IC;
//   * the score (a block reduction over the live good instances), and on an
//     improvement the lane copied to the rewind slab (forward pushes) and
//     to the result slab (a positive score), the best score and the
//     snapshot flag updated;
//   * the iterator one junction on, `last` the push's success.
// Per row it writes i, last, at_target, the score, n, the flanks and the
// overflow flag of the final state, its push count and its occurrence
// steps (the pushed vertices' occurrence counts, summed). Binary searches
// are torch.searchsorted's, step for step, so the plain version's answers
// are the kernel's on any input; every table index is clipped as there;
// sums and products wrap at 64 bits as torch's do.
//
// What bounds it: latency on a serial chain. Each occurrence step depends
// on the one before (a later occurrence sees the instances the earlier ones
// changed), and each is a chain of dependent loads: occurrence -> chromosome
// offset -> junction id -> binary search -> candidate fields -> junction
// positions, used prefix and sequence bytes. The bytes (each walking row's
// three slabs in and out, a few table words a step) and the operations are
// far below the card's rates. The design takes the chain off the host and
// off device memory where it can:
//   * one thread block a row (rows never read each other, so a block needs
//     no other block); the lane's instance slab and path table live in
//     dynamic shared memory for the whole call (11 x IC + 2 x PC int64
//     words: 61,440 bytes at IC 512, PC 1024), so the binary searches and
//     the candidate's fields are shared-memory reads;
//   * thread 0 runs the scalar chain of a step and applies a ChangeBack
//     itself; the whole block shifts for an insertion (descending rounds of
//     blockDim columns, read, barrier, write) and reduces the score;
//   * the rewind and result slabs are written to device memory on each
//     improvement only, the live lane once at the end, and a row that made
//     no push writes no state. The caller's output buffers start as copies
//     of the inputs and alias none of them: the kernel reads only the
//     inputs and writes only the outputs.
// Making the chain shorter (a warp-parallel search, the tables' rows staged
// ahead) is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInst = 11;        // instance fields of a lane (LANE_FIELDS[:11])
constexpr int kLaneFields = 22;  // LANE_FIELDS
constexpr int kLeaves = 3 * kLaneFields + 2;  // ln, rw, sn, best_score, has_snap
constexpr i64 kBig = 1LL << 60;
constexpr i64 kNegInf = -2147483647LL;  // oracle.NEG_INF_SCORE
constexpr int kMaxSmem = 232448;        // the most a block may opt in to

// LANE_FIELDS, in order
enum Field {
  F_CHR, F_S, F_FI, F_BI, F_FDIST, F_BDIST, F_CMP, F_FFIN, F_BFIN, F_GOOD, F_INS,
  F_N, F_NEXT_GOOD, F_NEXT_INS, F_RF, F_LF, F_OVF, F_PVID, F_PDIST, F_PN, F_RV, F_LV
};
// the lane's scalar registers, in shared memory
enum Reg { R_N, R_NEXT_GOOD, R_NEXT_INS, R_RF, R_LF, R_OVF, R_PN, R_RV, R_LV, kRegs };
__constant__ int kRegField[kRegs] = {F_N, F_NEXT_GOOD, F_NEXT_INS, F_RF, F_LF,
                                     F_OVF, F_PN, F_RV, F_LV};
// per-row results, in order
enum Result { O_I, O_LAST, O_AT, O_SCORE, O_N, O_RF, O_LF, O_OVF, O_PUSHES, O_OCC };

__host__ __device__ constexpr bool is_bool(int f) {
  return f == F_FFIN || f == F_BFIN || f == F_OVF;
}

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

struct Args {
  const i64* rows;  // null: row r is lane r
  const i64* c;
  const i64* i;
  const i64* s;
  const uint8_t* fwd;
  const i64* tvid;
  const uint8_t* active;
  const uint8_t* last;
};

struct Params {
  i64 L, A, m, b, flank;
  int IC, PC, limit;
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
__device__ __forceinline__ i64 wmul(i64 a, i64 b) {
  return static_cast<i64>(static_cast<u64>(a) * static_cast<u64>(b));
}
__device__ __forceinline__ i64 iabs(i64 a) { return a < 0 ? wsub(0, a) : a; }

// batched_push_device._COMP_TBL: the complement of an upper-case base, 0
// for any other byte
__device__ __forceinline__ i64 comp(i64 ch) {
  return ch == 'A' ? 'T' : ch == 'C' ? 'G' : ch == 'G' ? 'C' : ch == 'T' ? 'A' : 0;
}

// torch.searchsorted's lower bound (side="left") over row[0, W)
__device__ int lower_bound(const i64* row, int W, i64 val) {
  int start = 0, end = W;
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    if (!(row[mid] >= val)) {
      start = mid + 1;
    } else {
      end = mid;
    }
  }
  return start;
}

__device__ __forceinline__ i64 load(const void* p, int f, i64 at) {
  return is_bool(f) ? static_cast<i64>(static_cast<const uint8_t*>(p)[at])
                    : static_cast<const i64*>(p)[at];
}

__device__ __forceinline__ void store(void* p, int f, i64 at, i64 v) {
  if (is_bool(f)) {
    static_cast<uint8_t*>(p)[at] = v != 0;
  } else {
    static_cast<i64*>(p)[at] = v;
  }
}

// lane `lane` of slab q (0 live, 1 rewind, 2 result) of `out`, from shared
// memory; the whole block
__device__ void store_lane(const Leaves& out, int q, i64 lane, const i64* slab,
                           const i64* reg, int IC, int PC) {
  for (int f = 0; f < kInst; ++f) {
    for (int col = threadIdx.x; col < IC; col += blockDim.x) {
      store(out.p[q * kLaneFields + f], f, lane * IC + col, slab[f * IC + col]);
    }
  }
  const i64* path = slab + kInst * IC;
  for (int col = threadIdx.x; col < PC; col += blockDim.x) {
    store(out.p[q * kLaneFields + F_PVID], F_PVID, lane * PC + col, path[col]);
    store(out.p[q * kLaneFields + F_PDIST], F_PDIST, lane * PC + col, path[PC + col]);
  }
  if (threadIdx.x < kRegs) {
    const int f = kRegField[threadIdx.x];
    store(out.p[q * kLaneFields + f], f, lane, reg[threadIdx.x]);
  }
}

// new[col] = old[col - 1] for p < col < W and new[p] = vals[field], in
// `nf` fields laid out `stride` words apart (batched_push_device._row_insert);
// the whole block, p the same in every thread. Each round reads before a
// barrier and writes after it; a round writes only columns above those the
// next round reads.
__device__ void shift_insert(i64* base, int nf, int stride, int W, int p, const i64* vals) {
  for (int hi = W - 1; hi > p; hi -= blockDim.x) {
    const int col = hi - static_cast<int>(threadIdx.x);
    const bool mine = col > p;
    i64 v[kInst];
    if (mine) {
      for (int f = 0; f < nf; ++f) v[f] = base[f * stride + col - 1];
    }
    __syncthreads();
    if (mine) {
      for (int f = 0; f < nf; ++f) base[f * stride + col] = v[f];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && p < W) {
    for (int f = 0; f < nf; ++f) base[f * stride + p] = vals[f];
  }
  __syncthreads();
}

// resident._score_of of the lane in shared memory; the whole block; the
// result in every thread
__device__ i64 score_of(const Tables& tb, const i64* slab, const i64* reg, int IC,
                        i64 flank, i64* red) {
  const i64 nj = tb.n_j - 1;
  const i64 n = reg[R_N], rf = reg[R_RF], lf = reg[R_LF];
  i64 sum = 0;
  int bad = 0;
  for (int col = threadIdx.x; col < IC; col += blockDim.x) {
    if (col < n && slab[F_GOOD * IC + col] >= 0) {
      const i64 base = tb.chr_off[clip(slab[F_CHR * IC + col], tb.n_chr_off - 2)];
      const i64 jf = tb.jpos[clip(wadd(base, slab[F_FI * IC + col]), nj)];
      const i64 jb = tb.jpos[clip(wadd(base, slab[F_BI * IC + col]), nj)];
      const i64 right_pen = wsub(rf, slab[F_BDIST * IC + col]);
      const i64 left_pen = wadd(wsub(0, lf), slab[F_FDIST * IC + col]);
      bad |= (left_pen >= flank) | (right_pen >= flank);
      const i64 pen = wadd(right_pen, left_pen);
      sum = wadd(sum, wsub(iabs(wsub(jf, jb)), wmul(pen, pen)));
    }
  }
  for (int off = 16; off > 0; off >>= 1) sum = wadd(sum, __shfl_down_sync(0xffffffffu, sum, off));
  bad = __any_sync(0xffffffffu, bad);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by the last call's threads
  if ((threadIdx.x & 31) == 0) {
    red[warp] = sum;
    red[kWarps + warp] = bad;
  }
  __syncthreads();
  i64 total = 0;
  int any_bad = 0;
  for (int w = 0; w < kWarps; ++w) {
    total = wadd(total, red[w]);
    any_bad |= static_cast<int>(red[kWarps + w]);
  }
  return any_bad ? kNegInf : total;
}

// what thread 0 hands the block
struct Shared {
  i64 go;        // the walk goes on: one more push
  i64 success;   // the push's success
  i64 pp;        // path-table insertion column
  i64 occ_go;    // one more occurrence step
  i64 ins;       // this step inserts an instance at column p
  i64 p;
  i64 copy_rw, copy_sn;
  i64 wrote;     // the row made a push: its live lane goes out
  i64 vals[kInst];
};

__global__ void __launch_bounds__(kThreads)
lcb_walk_kernel(Leaves in, Leaves out, Tables tb, Args a, Params pr, i64* res) {
  extern __shared__ i64 slab[];  // [kInst][IC] instances, [PC] pvid, [PC] pdist
  __shared__ i64 reg[kRegs];
  __shared__ i64 red[2 * kWarps];
  __shared__ Shared sh;
  const int IC = pr.IC, PC = pr.PC;
  const int tid = threadIdx.x;
  const i64 r = blockIdx.x;
  const i64 lane_in = a.rows != nullptr ? a.rows[r] : r;
  const bool valid = lane_in >= 0 && lane_in < pr.L;
  const i64 src = clip(lane_in, pr.L - 1);
  i64* pvid = slab + kInst * IC;
  i64* pdist = pvid + PC;

  for (int f = 0; f < kInst; ++f) {
    for (int col = tid; col < IC; col += blockDim.x) {
      slab[f * IC + col] = load(in.p[f], f, src * IC + col);
    }
  }
  for (int col = tid; col < PC; col += blockDim.x) {
    pvid[col] = load(in.p[F_PVID], F_PVID, src * PC + col);
    pdist[col] = load(in.p[F_PDIST], F_PDIST, src * PC + col);
  }
  if (tid < kRegs) reg[tid] = load(in.p[kRegField[tid]], kRegField[tid], src);

  // the walk's registers, thread 0's alone
  const i64 nj = tb.n_j - 1;
  const i64 c = a.c[r], s = a.s[r], tvid = a.tvid[r];
  const bool fwd = a.fwd[r] != 0;
  const i64 cbase0 = tb.chr_off[clip(c, tb.n_chr_off - 2)];
  i64 it = a.i[r];
  i64 last = a.last[r] != 0;
  i64 best = static_cast<const i64*>(in.p[3 * kLaneFields])[src];
  i64 has_snap = static_cast<const uint8_t*>(in.p[3 * kLaneFields + 1])[src];
  i64 pushes = 0, occ_steps = 0;
  bool active = valid && a.active[r] != 0 && wmul(s, tb.jid[clip(wadd(cbase0, it), nj)]) != tvid;
  // the push's registers, thread 0's alone
  i64 eu = 0, ev = 0, ech = 0, vtx = 0, dval = 0, occ_lo = 0, occ_cnt = 0;

  for (int step = 0; step < pr.limit; ++step) {
    __syncthreads();  // the slab is loaded / the last push's copies are done
    if (tid == 0) {
      sh.go = active;
      if (active) {
        // ---- edge_of ----
        const i64 nbr = fwd ? wadd(it, s) : wsub(it, s);
        const i64 idx_self = clip(wadd(cbase0, it), nj), idx_nbr = clip(wadd(cbase0, nbr), nj);
        const i64 id_self = tb.jid[idx_self], id_nbr = tb.jid[idx_nbr];
        eu = wmul(s, fwd ? id_self : id_nbr);
        ev = wmul(s, fwd ? id_nbr : id_self);
        const i64 p_self = tb.jpos[idx_self], p_nbr = tb.jpos[idx_nbr];
        const i64 elen = iabs(wsub(p_nbr, p_self));
        const i64 p_start = fwd ? p_self : p_nbr;
        const i64 sq_off = tb.seq_off[clip(c, tb.n_seq_off - 2)];
        const i64 sq_len = tb.seq_off[clip(c + 1, tb.n_seq_off - 1)] - sq_off;
        if (s > 0) {
          ech = p_start + tb.k < sq_len ? tb.seq[clip(sq_off + p_start + tb.k, tb.n_seq - 1)] : 0;
        } else {
          const i64 cb = comp(tb.seq[clip(sq_off + p_start - 1, tb.n_seq - 1)]);
          ech = p_start > 0 && cb > 0 ? cb : 'N';
        }
        vtx = fwd ? ev : eu;
        const i64 av = iabs(vtx);
        occ_lo = tb.occ_off[clip(av, tb.n_occ_off - 2)];
        occ_cnt = tb.occ_off[clip(wadd(av, 1), tb.n_occ_off - 1)] - occ_lo;
        pushes += 1;
        occ_steps = wadd(occ_steps, occ_cnt);
        // ---- membership + path-table insert ----
        const int pp = lower_bound(pvid, PC, vtx);
        const bool member = pvid[clip(pp, PC - 1)] == vtx && pp < reg[R_PN];
        const bool success = !member && !reg[R_OVF];
        dval = fwd ? wadd(reg[R_RF], elen) : wsub(reg[R_LF], elen);
        sh.success = success;
        sh.pp = pp;
        sh.vals[0] = vtx;
        sh.vals[1] = dval;
        if (success) {
          reg[R_OVF] = reg[R_OVF] || reg[R_PN] >= PC - 1;
          reg[R_PN] += 1;
        }
      }
    }
    __syncthreads();
    if (!sh.go) break;
    const bool success = sh.success;
    if (success) shift_insert(pvid, 2, PC, PC, static_cast<int>(sh.pp), sh.vals);

    // ---- the occurrence loop ----
    for (i64 j = 0;; ++j) {
      if (tid == 0) {
        const bool act = success && j < occ_cnt && !reg[R_OVF];
        sh.occ_go = act;
        sh.ins = 0;
        if (act) {
          const i64* chr = slab + F_CHR * IC;
          const i64 n = reg[R_N];
          auto g = [&](int f, i64 q) { return slab[f * IC + clip(q, IC - 1)]; };
          const i64 oi = clip(occ_lo + j, tb.n_occ - 1);
          const i64 cj = tb.occ_chr[oi], ij = tb.occ_idx[oi];
          const i64 n_off = tb.n_chr_off - 2;
          const i64 base = tb.chr_off[clip(cj, n_off)];
          const i64 stored = tb.jid[clip(wadd(base, ij), nj)];
          const i64 sj = stored == vtx ? 1 : -1;
          // upper bound of (cj << 40) | ij among the live keys
          const i64 kq = static_cast<i64>((static_cast<u64>(cj) << 40) | static_cast<u64>(ij));
          int start = 0, end = IC;
          while (start < end) {
            const int mid = start + ((end - start) >> 1);
            const i64 key = mid < n ? static_cast<i64>((static_cast<u64>(chr[mid]) << 40) |
                                                       static_cast<u64>(slab[F_CMP * IC + mid]))
                                    : kBig;
            if (!(key > kq)) {
              start = mid + 1;
            } else {
              end = mid;
            }
          }
          const i64 p = start;
          const bool in_chr = p < n && g(F_CHR, p) == cj;
          const i64 fi_p = g(F_FI, p), bi_p = g(F_BI, p);
          const bool within = in_chr && (fi_p < bi_p ? fi_p : bi_p) <= ij &&
                              ij <= (fi_p > bi_p ? fi_p : bi_p);
          const bool use_prev = fwd ? sj > 0 : sj < 0;
          const i64 cand = use_prev ? p - 1 : p;
          const bool prev_ok = p - 1 >= 0 && g(F_CHR, p - 1) == cj;
          const bool cand_ok = use_prev ? prev_ok : in_chr;
          // ---- compatibility ----
          const i64 cc = g(F_CHR, cand), cs = g(F_S, cand);
          const i64 cend = fwd ? g(F_BI, cand) : g(F_FI, cand);
          const bool same_strand = cs == sj;
          const i64 start_i = fwd ? cend : ij, end_i = fwd ? ij : cend;
          const i64 lo_slot = sj > 0 ? start_i : end_i, hi_slot = sj > 0 ? end_i : start_i;
          const i64 cbase = tb.chr_off[clip(cc, n_off)];
          const i64 npfx = tb.n_pfx - 1;
          const bool used_between =
              hi_slot > lo_slot && tb.used_pfx[clip(wadd(cbase, hi_slot), npfx)] -
                                       tb.used_pfx[clip(wadd(cbase, lo_slot), npfx)] > 0;
          const i64 kshift = sj < 0 ? tb.k : 0;
          const i64 spos_abs = tb.jpos[clip(wadd(cbase, start_i), nj)];
          const i64 pos_start = wadd(spos_abs, kshift);
          const i64 pos_end = wadd(tb.jpos[clip(wadd(cbase, end_i), nj)], kshift);
          const i64 real_diff = wsub(pos_end, pos_start);
          const i64 cvid = wmul(cs, tb.jid[clip(wadd(cbase, cend), nj)]);
          const int cp = lower_bound(pvid, PC, cvid);
          const i64 cdist = pdist[clip(cp, PC - 1)];
          const i64 anc_diff = fwd ? wsub(dval, cdist) : wsub(cdist, dval);
          const bool dir_ok = sj > 0 ? real_diff >= 0 : wsub(0, real_diff) >= 0;
          const bool over = iabs(real_diff) > pr.b || anc_diff > pr.b;
          // adjacency escape: start.Next() == end, chars match, next vid == ev
          const i64 nxt_i = wadd(start_i, sj);
          const bool nxt_valid = nxt_i >= 0 && nxt_i < tb.chr_len[clip(cc, tb.n_chr_len - 1)];
          const i64 sq_off = tb.seq_off[clip(cc, tb.n_seq_off - 2)];
          const i64 sq_len = tb.seq_off[clip(cc + 1, tb.n_seq_off - 1)] - sq_off;
          const i64 nseq = tb.n_seq - 1;
          i64 start_char;
          if (sj > 0) {
            start_char = spos_abs + tb.k < sq_len ? tb.seq[clip(sq_off + spos_abs + tb.k, nseq)]
                                                  : 0;
          } else {
            const i64 prev_comp = comp(tb.seq[clip(sq_off + spos_abs - 1, nseq)]);
            start_char = spos_abs > 0 && prev_comp > 0 ? prev_comp : 'N';
          }
          const i64 nvid = wmul(sj, tb.jid[clip(wadd(cbase, nxt_i > 0 ? nxt_i : 0), nj)]);
          const bool escape = nxt_valid && start_char == ech && nxt_i == end_i && nvid == ev;
          const bool compat = cand_ok && same_strand && !used_between && dir_ok &&
                              (!over || escape);
          const bool upd = compat && cvid != vtx;
          const i64 uslot = sj > 0 ? wadd(base, ij) : wsub(wadd(base, ij), 1);
          const bool u = (sj > 0 || ij > 0) && tb.used[clip(uslot, tb.n_used - 1)] > 0;
          if (!within && upd) {
            const bool cfin = fwd ? g(F_BFIN, cand) != 0 : g(F_FFIN, cand) != 0;
            if (!cfin) {  // ChangeBack / ChangeFront at the candidate
              const i64 c_other = fwd ? g(F_FI, cand) : g(F_BI, cand);
              const i64 jp_other = tb.jpos[clip(wadd(cbase, c_other), nj)];
              const i64 jp_end_old = tb.jpos[clip(wadd(cbase, cend), nj)];
              const bool was_good = iabs(wsub(jp_other, jp_end_old)) >= pr.m;
              const i64 jp_end_new = tb.jpos[clip(wadd(base, ij), nj)];
              const bool now_good = iabs(wsub(jp_other, jp_end_new)) >= pr.m;
              const i64 col = clip(cand, IC - 1);
              slab[(fwd ? F_BI : F_FI) * IC + col] = ij;
              slab[(fwd ? F_BDIST : F_FDIST) * IC + col] = dval;
              if (fwd ? cs > 0 : cs < 0) slab[F_CMP * IC + col] = ij;
              if (!was_good && now_good) {
                slab[F_GOOD * IC + col] = reg[R_NEXT_GOOD];
                reg[R_NEXT_GOOD] += 1;
              }
              if (u) slab[(fwd ? F_BFIN : F_FFIN) * IC + col] = 1;
            }
          } else if (!within && !u && !upd) {
            if (n < IC) {  // insert a new instance at the bound
              const i64 vals[kInst] = {cj, sj, ij, ij, dval, dval, ij, 0, 0, -1,
                                       reg[R_NEXT_INS]};
              for (int f = 0; f < kInst; ++f) sh.vals[f] = vals[f];
              sh.ins = 1;
              sh.p = p;
              reg[R_N] += 1;
              reg[R_NEXT_INS] += 1;
            } else {
              reg[R_OVF] = 1;
            }
          }
        }
      }
      __syncthreads();
      const bool go = sh.occ_go, ins = sh.ins;
      const int p = static_cast<int>(sh.p);
      __syncthreads();  // read by all before thread 0 writes the next step's
      if (!go) break;
      if (ins) shift_insert(slab, kInst, IC, IC, p, sh.vals);
    }

    if (tid == 0 && success) {
      if (fwd) {
        reg[R_RF] = dval;
        reg[R_RV] = ev;
      } else {
        reg[R_LF] = dval;
        reg[R_LV] = eu;
      }
    }
    __syncthreads();
    const i64 score = score_of(tb, slab, reg, IC, pr.flank, red);
    if (tid == 0) {
      const bool improved = success && score > best;
      if (improved) best = score;
      sh.copy_rw = improved && fwd;
      sh.copy_sn = improved && score > 0;
      has_snap |= sh.copy_sn;
      it = wadd(it, fwd ? s : wsub(0, s));
      last = success;
      active = wmul(s, tb.jid[clip(wadd(cbase0, it), nj)]) != tvid && !reg[R_OVF];
    }
    __syncthreads();
    if (sh.copy_rw) store_lane(out, 1, lane_in, slab, reg, IC, PC);
    if (sh.copy_sn) store_lane(out, 2, lane_in, slab, reg, IC, PC);
  }

  __syncthreads();
  const i64 score = score_of(tb, slab, reg, IC, pr.flank, red);
  if (tid == 0) sh.wrote = valid && pushes > 0;
  __syncthreads();
  if (sh.wrote) {
    store_lane(out, 0, lane_in, slab, reg, IC, PC);
    if (tid == 0) {
      static_cast<i64*>(out.p[3 * kLaneFields])[lane_in] = best;
      static_cast<uint8_t*>(out.p[3 * kLaneFields + 1])[lane_in] = has_snap != 0;
    }
  }
  if (tid == 0) {
    const i64 A = pr.A;
    res[O_I * A + r] = it;
    res[O_LAST * A + r] = last;
    res[O_AT * A + r] = wmul(s, tb.jid[clip(wadd(cbase0, it), nj)]) == tvid;
    res[O_SCORE * A + r] = score;
    res[O_N * A + r] = reg[R_N];
    res[O_RF * A + r] = reg[R_RF];
    res[O_LF * A + r] = reg[R_LF];
    res[O_OVF * A + r] = reg[R_OVF] != 0;
    res[O_PUSHES * A + r] = pushes;
    res[O_OCC * A + r] = occ_steps;
  }
}

// The chain floor's probe: `iters` steps of four dependent loads served
// from L2 (a pointer chase over `table`) by thread 0 and one barrier of the
// block, the least one occurrence step of the walk can cost.
__global__ void __launch_bounds__(kThreads) lcb_chain_probe_kernel(const i64* table, int iters,
                                                                   i64* out) {
  __shared__ i64 x;
  i64 v = 0;
  for (int step = 0; step < iters; ++step) {
    if (threadIdx.x == 0) {
      v = __ldcg(table + v);
      v = __ldcg(table + v);
      v = __ldcg(table + v);
      v = __ldcg(table + v);
      x = v;
    }
    __syncthreads();
    v = x;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = v;
}

// Dynamic shared memory a block takes at slab widths IC and PC.
long long smem_bytes(int IC, int PC) {
  return (static_cast<long long>(kInst) * IC + 2LL * PC) * 8;
}

}  // namespace

// in_leaves, out_leaves: host arrays of the 68 device pointers of
// resident._state_leaves (ln, rw, sn: the 22 LANE_FIELDS each; best_score,
// has_snap), input and output, [L, IC] / [L, PC] / [L] row-major, int64
// but the bool (1-byte) ffin, bfin, overflow and has_snap; no output may
// alias an input, and every output starts as a copy of its input.
// tables: host array of 11 device pointers (chr_off, chr_len, jpos, jid,
// used_pfx, used, seq_off, seq, occ_off, occ_chr, occ_idx: int64 but the
// uint8 used and seq); table_lens: host array of their 9 lengths (chr_off,
// chr_len, jpos = jid, used_pfx, used, seq_off, seq, occ_off, occ_chr =
// occ_idx); args: host array of 8 device pointers over A rows (rows, null
// for lane r at row r, else int64 and distinct below L; c, i, s, tvid
// int64; fwd, active, last bool); res: [10, A] int64, written. Returns
// cudaGetLastError() after the launch, or the first error before it.
extern "C" int sz_lcb_walk(const long long* in_leaves, const long long* out_leaves,
                           const long long* tables, const long long* table_lens,
                           const long long* args, void* res, long long L, long long A, int IC,
                           int PC, long long k, long long m, long long b, long long flank,
                           int limit, void* stream) {
  const long long smem = smem_bytes(IC, PC);
  if (L < 1 || A < 0 || A > 0x7fffffffLL || IC < 1 || PC < 1 || limit < 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (A == 0) return 0;
  Leaves in{}, out{};
  for (int q = 0; q < kLeaves; ++q) {
    in.p[q] = reinterpret_cast<void*>(in_leaves[q]);
    out.p[q] = reinterpret_cast<void*>(out_leaves[q]);
  }
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
  tb.n_chr_off = table_lens[0];
  tb.n_chr_len = table_lens[1];
  tb.n_j = table_lens[2];
  tb.n_pfx = table_lens[3];
  tb.n_used = table_lens[4];
  tb.n_seq_off = table_lens[5];
  tb.n_seq = table_lens[6];
  tb.n_occ_off = table_lens[7];
  tb.n_occ = table_lens[8];
  tb.k = k;
  Args a{};
  a.rows = reinterpret_cast<const i64*>(args[0]);
  a.c = reinterpret_cast<const i64*>(args[1]);
  a.i = reinterpret_cast<const i64*>(args[2]);
  a.s = reinterpret_cast<const i64*>(args[3]);
  a.fwd = reinterpret_cast<const uint8_t*>(args[4]);
  a.tvid = reinterpret_cast<const i64*>(args[5]);
  a.active = reinterpret_cast<const uint8_t*>(args[6]);
  a.last = reinterpret_cast<const uint8_t*>(args[7]);
  const Params pr{L, A, m, b, flank, IC, PC, limit};
  // set at every launch: the attribute belongs to the current device's
  // context, and a host call costs little beside the kernel
  const cudaError_t err = cudaFuncSetAttribute(
      lcb_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lcb_walk_kernel<<<static_cast<unsigned>(A), kThreads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(in, out, tb, a, pr,
                                                         static_cast<i64*>(res));
  return static_cast<int>(cudaGetLastError());
}

// table: n int64 entries, each an index into the table (a pointer chase);
// out: one int64.
extern "C" int sz_lcb_chain_probe(const void* table, int iters, void* out, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  lcb_chain_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(table), iters, static_cast<i64*>(out));
  return static_cast<int>(cudaGetLastError());
}
