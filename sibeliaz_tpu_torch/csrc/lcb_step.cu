// K7 lcb_step: the fused LCB engine's outer step loop, each lane run to its
// end in one launch, for Hopper (sm_90a).
//
// Replaces the jax.lax.while_loop of sibeliaz_tpu/lcb/fused.py (:326),
// whose body is fused.py::_phase_step (:222-324); an XLA program, not a
// Pallas kernel.  Its plain version is lcb/step.py's host loop over the
// same step, through K6's and K5's plain versions.
//
// Per lane (a block each; lanes never read each other), from the carry (the
// state's live, rewind and result slabs, best score and snapshot flag, and
// the 13 protocol registers of fused.CARRY_REGISTERS), while the lane is
// active and the carry's step count plus the lane's own steps is below
// steps_limit, one outer step as _phase_step takes it:
//   * a lane not mid-walk votes (K6's vote with the forward-only used-retry):
//     an instance count past the tier's cap CAP, or a window still alive at
//     W, sends it to `retier` and ends it; a winner starts a walk (wc wi ws
//     wt from the winner's origin and vid, wlast cleared); no winner
//     completes the lane's extend attempt;
//   * a walking lane makes up to `chunk` pushes toward its target (K5's
//     walk); an overflow sends it to `hostfb` (the widest slabs, slab_max)
//     or `retier` and ends it; reaching the target completes the attempt
//     with the walk's score;
//   * a completed attempt advances the protocol registers
//     (blocksfinder.h:252-306): an extend within min_run of the outer
//     iteration's start stays in the inner loop (forward, accumulating
//     positivity), else the inner loop breaks: a positive forward sweep
//     opens a new outer iteration, a spent one rewinds the live slab from
//     the rewind slab (the best prefix) and turns backward; the backward
//     sweep's end ends the lane.
// The carry is written in place.  Per lane it also writes its steps, its
// pushes, its occurrence steps (the pushed vertices' occurrence counts,
// summed), whether a vote took the spill workspace, and the work its steps
// did, counted in the block's shared memory as it is done: the walks'
// score terms (a chunk's pushes times the lane's instances after it), the
// votes' voting instances, windows, evaluated slots and alive entries
// (vote_row's counts), and whether its best score rose, and rose above 0
// (a rewind slab and a result slab written).  The host reads them with the
// other results, in its one read of the run.
//
// What bounds it: the serial chain of a lane's steps.  Each step depends on
// the one before (its vote reads the instances the last walk left), a vote
// is a few rounds of dependent table loads and barriers, and a walk's
// occurrence steps are K5's chain; the bytes a run moves (each lane's slab
// in and out, the tables its votes and walks read) are far under it.  So
// the longest lane sets a launch's time.  The design (PR 21's, from the
// split of a step that csrc/step_stamps.cuh's stamps gave: of PR 20's ~22
// us a step at 1,995 MHz, the vote's columns, windows and winner took ~7,
// the slab's load, live store and the wait for them ~8; and PR 20's one
// block an SM ran a lane set of more than 132 lanes in two waves):
//   * one launch a lane set, one block of 256 threads a lane, two blocks an
//     SM (128 registers a thread, and at most 110,592 dynamic shared bytes
//     a block: step_table), so a lane set of up to 264 lanes runs in one
//     wave; no host work and no read of the card between steps: a finished
//     lane's block ends (no compaction); a lane that does not step loads
//     nothing;
//   * the lane is resident: its live slab is loaded into shared memory once
//     (TMA bulk copies on an mbarrier) and stored once at its end, its nine
//     registers, best score and snapshot flag kept beside it
//     (walk::Resident); the vote (vote_row<true>, all 8 warps) reads its
//     columns and path row there, the walk (walk_row<true>, warps 0-1, its
//     barriers named ones over those 64 threads while warps 2-7 wait at the
//     step's barrier) pushes there, and the uniform tails are found once a
//     load and kept up to date by the walks; the forward sweep's rewind is
//     a bulk load of the rewind slab (after the bulk stores to it are
//     done).  The rewind and result snapshots still go out by bulk stores
//     as the walk takes them, a row a lane of warp 0, never waited for but
//     before a load or a store to the same slab; a forward improvement
//     stores the rewind slab alone and the result slab is copied from it
//     once, where the rewind slab is about to change (walk::Resident's
//     alias);
//   * the vote region (hash table, six columns, claimed-slot list) sits
//     beside the slab (step_smem's layout 1; the vote's strands, ends and
//     order sequences are the slab's rows); the table is cleared once, and
//     each vote clears the slots it claimed and takes its winner over them
//     (by warp 0 where they are 32 at most), not over all its slots;
//   * one mbarrier serves every load of the block (its phase in a
//     register of every thread); between the async proxy (the bulk copies)
//     and the generic one each hand-over is a completed bulk group or a
//     proxy fence, then a barrier;
//   * a spilling vote holds its workspace slice only inside the vote.

#include "lcb_vote.cuh"
#include "lcb_walk.cuh"
#include "step_stamps.cuh"

namespace {

typedef long long i64;

constexpr int kThreads = vote::kThreads;  // 256; the walk takes threads 0-63
constexpr int kRegisters = 13;            // fused.CARRY_REGISTERS

// fused.CARRY_REGISTERS, in order
enum Register {
  R_STAGE, R_POSITIVE, R_PREV_LEN, R_SCORE, R_ACTIVE, R_RETIER, R_HOSTFB, R_IN_WALK, R_WC,
  R_WI, R_WS, R_WT, R_WLAST
};
// per-lane results, in order (kernels.LaneSteps' rows)
enum Result {
  S_STEPS, S_PUSHES, S_OCC, S_SPILLED, S_TERMS, S_VOTERS, S_WINDOWS, S_SLOTS, S_ENTRIES, S_ROSE,
  S_ROSE_POS, kResults
};
static_assert(S_ENTRIES - S_VOTERS + 1 == vote::kCounts, "a row for each of vote_row's counts");

struct Carry {
  void* p[kRegisters];
};

struct StepParams {
  i64 CAP;       // the tier's vote cap: a lane with more instances retiers
  int slab_max;  // the tier's slabs are the widest: a slab overflow goes to hostfb
  i64 min_run;
  i64 start, limit;  // the carry's step count and the step limit
};

// The lane's protocol registers and its step's decisions (thread 0 writes
// them, the block reads them after a barrier).
struct Lane {
  i64 stage, prev_len, score, wc, wi, ws, wt;
  bool positive, active, retier, hostfb, in_walk, wlast;
  i64 steps, pushes, occ;
  int spilled;
  bool go, votes, to_bwd;
  i64 terms;                  // the walks' score terms
  i64 counts[vote::kCounts];  // the votes' work (vote_row<true>'s counts)
  i64 best0;                  // the best score the lane came in with
};

__device__ __forceinline__ i64 wsub(i64 a, i64 b) {
  return static_cast<i64>(static_cast<unsigned long long>(a) - static_cast<unsigned long long>(b));
}

// every access of this thread to global memory, ordered against the bulk
// copies (the async proxy)
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// The slab q (0 live, 1 rewind) of `lane` into S, by the whole block:
// thread 0 issues the bulk copies of the rows that take them on the
// mbarrier `bar` (at phase `parity`), threads 32 and up copy the others by
// the vectorised loop; every thread waits for the copies.  Returns whether
// the mbarrier's phase moved on (the caller flips its parity after a
// barrier).  The caller has waited for every bulk store reading S.
__device__ bool load_slab(const walk::Leaves& st, const walk::Params& pr, const walk::Slab& S,
                          int q, i64 lane, unsigned long long* bar, unsigned parity) {
  const int tid = threadIdx.x;
  unsigned tx = 0;
  for (int k = 0; k < walk::kLaneRows; ++k) {
    int bytes, field;
    walk::lane_row(S, k, bytes, field);
    if (walk::bulk_row(pr, q, k)) tx += bytes;
  }
  if (tid == 0 && tx > 0) {
    walk::mbar_expect_tx(bar, tx);
    for (int k = 0; k < walk::kLaneRows; ++k) {
      int bytes, field;
      uint8_t* sm = walk::lane_row(S, k, bytes, field);
      if (walk::bulk_row(pr, q, k)) {
        walk::bulk_load(sm, walk::global_row(st, q, field, lane, bytes), bytes, bar);
      }
    }
  } else if (tid >= 32) {
    for (int k = 0; k < walk::kLaneRows; ++k) {
      int bytes, field;
      uint8_t* sm = walk::lane_row(S, k, bytes, field);
      if (!walk::bulk_row(pr, q, k)) {
        walk::copy_bytes(sm, walk::global_row(st, q, field, lane, bytes), bytes, tid - 32,
                         kThreads - 32);
      }
    }
    walk::fence_async_smem();  // those rows may go out by bulk stores
  }
  if (tx > 0) walk::mbar_wait(bar, parity);
  return tx > 0;
}

// The slab's uniform tails into keep (zeroed by thread 0 before the barrier
// that precedes this), by the whole block after the slab is in.
__device__ void find_tails(const walk::Slab& S, walk::Resident& keep) {
  const int tid = threadIdx.x;
  const int tp = __reduce_max_sync(0xffffffffu, walk::path_tail_part(S, tid, kThreads));
  const int ti = __reduce_max_sync(0xffffffffu, walk::inst_tail_part(S, tid, kThreads));
  if ((tid & 31) == 0) {
    atomicMax(&keep.t_path, tp);
    atomicMax(&keep.t_inst, ti);
  }
}

// Slab q's rows of `lane` from S, by the whole block: a row a thread of
// warp 0 by bulk copies (each of those threads commits its group), the rows
// bulk copies cannot take by threads 32 and up.
__device__ void store_slab(const walk::Leaves& st, const walk::Params& pr, const walk::Slab& S,
                           int q, i64 lane) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    if (tid < walk::kLaneRows && walk::bulk_row(pr, q, tid)) {
      int bytes, field;
      uint8_t* sm = walk::lane_row(S, tid, bytes, field);
      walk::bulk_store(walk::global_row(st, q, field, lane, bytes), sm, bytes);
    }
    walk::bulk_commit();
  } else {
    walk::store_rows_by_loop(st, pr, S, q, lane, tid - 32, kThreads - 32);
  }
}

// Register r (kRegField's order) of slab q of `lane`, to device memory.
__device__ __forceinline__ void store_register(const walk::Leaves& st, int q, i64 lane, int r,
                                               i64 v) {
  const int f = walk::kRegField[r];
  void* p = st.p[q * walk::kLaneFields + f];
  if (walk::is_bool(f)) {
    static_cast<uint8_t*>(p)[lane] = v != 0;
  } else {
    static_cast<i64*>(p)[lane] = v;
  }
}

// The lane's 9 registers of slab q from device memory into keep (threads
// 0-8).
__device__ void load_registers(const walk::Leaves& st, int q, i64 lane, walk::Resident& keep) {
  const int tid = threadIdx.x;
  if (tid < walk::kRegs) {
    const int f = walk::kRegField[tid];
    const void* p = st.p[q * walk::kLaneFields + f];
    keep.reg[tid] = walk::is_bool(f) ? static_cast<const uint8_t*>(p)[lane]
                                     : static_cast<const i64*>(p)[lane];
  }
}

// two blocks an SM (128 registers a thread): a launch's lanes, PHASE_LANES
// at most, then run in one wave on the card's 132 SMs
__global__ void __launch_bounds__(kThreads, 2)
lcb_step_kernel(walk::Leaves st, walk::Tables wtb, walk::Params wpr, vote::Tables vtb,
                vote::Params vpr, Carry cr, StepParams sp, i64* out, i64* stamp_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ walk::Shared wsh;
  __shared__ walk::Resident keep;
  __shared__ vote::Shared vsh;
  __shared__ i64 vo[vote::kOut];
  __shared__ Lane R;
  const int tid = threadIdx.x;
  const i64 lane = blockIdx.x;
  const i64 L = wpr.L;
  const walk::Slab S = walk::slab_of(smem, wpr.IC, wpr.PC);
  unsigned char* vregion = smem + walk::slab_bytes(wpr.IC, wpr.PC);
  // the vote's lane fields: the slab's rows and the kept registers, as lane 0
  vote::Lanes vln;
  vln.p[vote::L_CHR] = S.w(walk::F_CHR);
  vln.p[vote::L_S] = S.w(walk::F_S);
  vln.p[vote::L_FI] = S.w(walk::F_FI);
  vln.p[vote::L_BI] = S.w(walk::F_BI);
  vln.p[vote::L_GOOD] = S.w(walk::F_GOOD);
  vln.p[vote::L_INS] = S.w(walk::F_INS);
  vln.p[vote::L_N] = &keep.reg[0];
  vln.p[vote::L_PVID] = S.pvid;
  vln.p[vote::L_PN] = &keep.reg[6];
  vln.p[vote::L_RV] = &keep.reg[7];
  vln.p[vote::L_LV] = &keep.reg[8];

  stamps::clear();
  stamps::mark(stamps::NS_START);
  stamps::mark_sm(stamps::SM);
  const long long t_total = stamps::now();
  if (tid == 0) {
    walk::mbar_init(&wsh.bar, 1);
    auto r64 = [&](int r) { return static_cast<const i64*>(cr.p[r])[lane]; };
    auto r8 = [&](int r) { return static_cast<const uint8_t*>(cr.p[r])[lane] != 0; };
    R.stage = r64(R_STAGE);
    R.positive = r8(R_POSITIVE);
    R.prev_len = r64(R_PREV_LEN);
    R.score = r64(R_SCORE);
    R.active = r8(R_ACTIVE);
    R.retier = r8(R_RETIER);
    R.hostfb = r8(R_HOSTFB);
    R.in_walk = r8(R_IN_WALK);
    R.wc = r64(R_WC);
    R.wi = r64(R_WI);
    R.ws = r64(R_WS);
    R.wt = r64(R_WT);
    R.wlast = r8(R_WLAST);
    R.steps = R.pushes = R.occ = R.terms = 0;
    for (int c = 0; c < vote::kCounts; ++c) R.counts[c] = 0;
    R.spilled = 0;
    R.go = R.active && sp.start < sp.limit;
    keep.t_inst = keep.t_path = 0;
    keep.stored = 0;
    keep.alias = 0;
  }
  __syncthreads();
  const bool steps_any = R.go;
  unsigned parity = 0;  // the mbarrier's phase for the next load
  if (steps_any) {
    // ---- the lane in, once: its live slab, registers, best score, flag ----
    load_registers(st, 0, lane, keep);
    if (tid == walk::kRegs) {
      keep.best = R.best0 = static_cast<const i64*>(st.p[3 * walk::kLaneFields])[lane];
    }
    if (tid == walk::kRegs + 1) {
      keep.has_snap = static_cast<const uint8_t*>(st.p[3 * walk::kLaneFields + 1])[lane];
    }
    vote::clear_table(vregion, vpr.H);
    if (load_slab(st, wpr, S, 0, lane, &wsh.bar, parity)) parity ^= 1;
    __syncthreads();
    find_tails(S, keep);
    __syncthreads();
  }

  while (steps_any) {
    // ---- the step's decisions ----
    if (tid == 0) {
      R.go = R.active && sp.start + R.steps < sp.limit;
      R.votes = false;
      if (R.go && !R.in_walk) {
        if (keep.reg[0] > sp.CAP) {  // cap overflow: re-run at a bigger tier
          R.retier = true;
          R.active = false;
        } else {
          R.votes = true;
        }
      }
    }
    __syncthreads();
    if (!R.go) break;
    const bool fwd = R.stage == 0;
    bool no_winner = false;  // thread 0's
    // ---- the step's vote, for a lane not mid-walk ----
    if (R.votes) {
      const int spilled = vote::vote_row<true>(vln, vtb, vpr, 0, lane, true, fwd, false, vregion,
                                               vsh, vo, R.counts);
      if (tid == 0) {
        R.spilled |= spilled;
        if (vo[5] != 0) {  // a window alive at W: re-run at a wider tier
          R.retier = true;
          R.active = false;
        } else if (vo[0] != 0) {  // a winner: a fresh walk toward it
          R.wc = vo[2];
          R.wi = vo[3];
          R.ws = vo[4];
          R.wt = vo[0];
          R.wlast = false;
          R.in_walk = true;
        } else {
          no_winner = true;
        }
      }
      __syncthreads();
    }

    // ---- a chunk of the walk, for a walking lane ----
    bool walk_done = false, ret = false;  // thread 0's
    if (tid < walk::kThreads && R.in_walk) {
      walk::Row row;
      row.lane = lane;
      row.c = R.wc;
      row.i = R.wi;
      row.s = R.ws;
      row.tvid = R.wt;
      row.fwd = fwd;
      row.active = true;
      row.last = R.wlast;
      row.serve = false;
      const walk::RowOut o = walk::walk_row<true>(st, wtb, wpr, row, smem, wsh, &keep);
      if (tid == 0) {
        R.pushes += o.pushes;
        R.occ += o.occ_steps;
        R.terms += o.pushes * o.n;
        R.wi = o.it;
        R.wlast = o.last;
        if (o.ovf) {  // a slab overflowed: a wider tier, or the host oracle
          if (sp.slab_max) {
            R.hostfb = true;
          } else {
            R.retier = true;
          }
          R.active = false;
        }
        walk_done = o.after && !o.ovf;
        R.in_walk = !o.after && !o.ovf;
        if (walk_done) R.score = o.score;
        ret = walk_done && o.last;
      }
    }

    // ---- the protocol registers, for a completed extend attempt ----
    const long long t_regs = stamps::now();
    if (tid == 0) {
      const bool fin = no_winner || walk_done;
      const i64 middle = wsub(keep.reg[3], keep.reg[4]);  // the live slab's rf - lf
      const bool cont = ret && wsub(middle, R.prev_len) <= sp.min_run;
      if (fwd && cont && R.score > 0) R.positive = true;
      const bool brk = R.active && fin && !cont;
      const bool outer_cont = fwd ? ret && R.positive : ret && R.score > 0;
      if (brk && outer_cont) {  // a new outer iteration
        R.prev_len = middle;
        if (fwd) R.positive = false;
      }
      R.to_bwd = brk && !outer_cont && fwd;
      if (brk && !outer_cont && !fwd) R.active = false;  // the backward sweep is done
      if (R.to_bwd) {  // the best-prefix rewind: the live slab from the rewind slab
        R.stage = 1;
        R.score = 0;
        R.positive = false;
        auto rw = [&](int f) { return static_cast<const i64*>(st.p[walk::kLaneFields + f])[lane]; };
        R.prev_len = wsub(rw(walk::F_RF), rw(walk::F_LF));
        keep.stored = 0;
        keep.t_inst = keep.t_path = 0;
      }
      R.steps += 1;
    }
    __syncthreads();
    stamps::add(stamps::REGISTERS, t_regs);
    if (R.to_bwd) {
      const long long t_rewind = stamps::now();
      if (tid < 32) {
        walk::bulk_wait_all();  // the stores to the rewind slab are done, and done reading S
        fence_async_global();   // and ordered before the loads of it
      }
      walk::fence_async_smem();  // this thread's writes to S, before bulk loads into it
      __syncthreads();
      load_registers(st, 1, lane, keep);
      if (load_slab(st, wpr, S, 1, lane, &wsh.bar, parity)) parity ^= 1;
      __syncthreads();
      const bool copy = keep.alias != 0;
      if (copy) {  // the result slab's due copy of the rewind slab, now the live one
        if (tid < walk::kRegs) store_register(st, 2, lane, tid, keep.reg[tid]);
        store_slab(st, wpr, S, 2, lane);
      }
      find_tails(S, keep);
      __syncthreads();
      if (tid == 0 && copy) {
        keep.alias = 0;
        keep.stored |= 4;
      }
      stamps::add(stamps::REWIND, t_rewind);
    }
  }
  stamps::add(stamps::TOTAL, t_total);
  stamps::mark(stamps::NS_END);

  if (steps_any) {
    // ---- the lane out, once: its live slab, registers, best score, flag ----
    if (keep.alias) {  // the result slab's due copy of the rewind slab, device to device
      if (tid < 32) {
        walk::bulk_wait_all();  // the rewind slab's bulk stores are done,
        fence_async_global();   // and ordered before the block's reads of it
      }
      __syncthreads();
      for (int k = 0; k < walk::kLaneRows; ++k) {
        int bytes, field;
        walk::lane_row(S, k, bytes, field);
        walk::copy_bytes(walk::global_row(st, 2, field, lane, bytes),
                         walk::global_row(st, 1, field, lane, bytes), bytes, tid, kThreads);
      }
      if (tid < walk::kRegs) {
        const int f = walk::kRegField[tid];
        const void* p = st.p[walk::kLaneFields + f];
        store_register(st, 2, lane, tid, walk::is_bool(f) ? static_cast<const uint8_t*>(p)[lane]
                                                          : static_cast<const i64*>(p)[lane]);
      }
    }
    walk::fence_async_smem();  // this thread's writes to S, before the bulk stores read it
    __syncthreads();
    store_slab(st, wpr, S, 0, lane);
    if (tid < walk::kRegs) store_register(st, 0, lane, tid, keep.reg[tid]);
    if (tid == walk::kRegs) static_cast<i64*>(st.p[3 * walk::kLaneFields])[lane] = keep.best;
    if (tid == walk::kRegs + 1) {
      static_cast<uint8_t*>(st.p[3 * walk::kLaneFields + 1])[lane] = keep.has_snap != 0;
    }
  }
  if (tid == 0) {
    auto w64 = [&](int r, i64 v) { static_cast<i64*>(cr.p[r])[lane] = v; };
    auto w8 = [&](int r, bool v) { static_cast<uint8_t*>(cr.p[r])[lane] = v; };
    w64(R_STAGE, R.stage);
    w8(R_POSITIVE, R.positive);
    w64(R_PREV_LEN, R.prev_len);
    w64(R_SCORE, R.score);
    w8(R_ACTIVE, R.active);
    w8(R_RETIER, R.retier);
    w8(R_HOSTFB, R.hostfb);
    w8(R_IN_WALK, R.in_walk);
    w64(R_WC, R.wc);
    w64(R_WI, R.wi);
    w64(R_WS, R.ws);
    w64(R_WT, R.wt);
    w8(R_WLAST, R.wlast);
    out[S_STEPS * L + lane] = R.steps;
    out[S_PUSHES * L + lane] = R.pushes;
    out[S_OCC * L + lane] = R.occ;
    out[S_SPILLED * L + lane] = R.spilled;
    out[S_TERMS * L + lane] = R.terms;
    for (int c = 0; c < vote::kCounts; ++c) out[(S_VOTERS + c) * L + lane] = R.counts[c];
    const bool rose = steps_any && keep.best > R.best0;
    out[S_ROSE * L + lane] = rose;
    out[S_ROSE_POS * L + lane] = rose && keep.best > 0;
    if (stamps::kOn && stamp_out != nullptr) {
      for (int p = 0; p < stamps::kParts; ++p) stamp_out[p * L + lane] = stamps::sum(p);
    }
  }
  if (tid < 32) walk::bulk_wait_all();  // the stores are done before the block's shared memory goes
}

// The dynamic shared bytes under which two blocks share an SM (of its
// 228 KB: the static shared memory and 1 KB a block besides).
constexpr long long kTwoBlocks = 110592;

// A launch's vote table: the largest power of two of at most K6's
// table_slots(CAP, W) slots (and at least 64) with which the slab and the
// vote's region fit kTwoBlocks, else K6's.  A row spills past half of it.
int step_table(int IC, int PC, int CAP, int W) {
  const int full = vote::table_slots(CAP, W);
  const long long slab = walk::slab_bytes(IC, PC);
  for (int H = full; H >= 64; H /= 2) {
    if (slab + vote::resident_smem_bytes(CAP, H) <= kTwoBlocks) return H;
  }
  return full;
}

// The dynamic shared memory of a launch at these shapes: layout 1 (the
// kernel's) keeps the slab resident beside the vote's region (table of
// step_table slots, columns, claimed-slot list; the vote reads pvid and
// three of its columns from the slab); layout 0 (PR 20's kernel's) gave
// the vote's region and the walk's slab the same bytes in turn.  -1 for a
// shape K5's or K6's algorithm does not take.
long long step_smem(int IC, int PC, int CAP, int W, int layout) {
  if (IC < 1 || PC < 1 || CAP < 1 || W < 1 || CAP > IC || CAP > vote::kMaxCols ||
      W > vote::kMaxCols || layout < 0 || layout > 1) {
    return -1;
  }
  const long long votes = vote::smem_bytes(CAP, PC, vote::table_slots(CAP, W));
  const long long slab = walk::slab_bytes(IC, PC);
  const long long bytes =
      layout == 0 ? (votes > slab ? votes : slab)
                  : slab + vote::resident_smem_bytes(CAP, step_table(IC, PC, CAP, W));
  return votes <= vote::kMaxSmem && slab <= walk::kMaxSmem && bytes <= walk::kMaxSmem ? bytes : -1;
}

// The spill workspace's words a slice at these shapes (as K6's
// sz_lcb_vote_workspace_words, with K7's table): 0 where no vote can spill
// (CAP * W at most half of it), -1 for a shape K7 does not take.
long long step_workspace_words(int IC, int PC, int CAP, int W) {
  if (step_smem(IC, PC, CAP, W, 1) < 0) return -1;
  if (static_cast<long long>(CAP) * W <= vote::spill_limit(step_table(IC, PC, CAP, W))) return 0;
  long long slots = 64;
  while (slots < 2LL * CAP * W) slots *= 2;
  return 3 * slots;
}

cudaError_t set_step_attributes(long long smem) {
  cudaError_t err = cudaFuncSetAttribute(
      lcb_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(lcb_step_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

}  // namespace

// leaves: host array of the 68 device pointers of _state_leaves (as
// sz_lcb_walk's), walked in place, no two overlapping; registers: host
// array of the 13 device pointers of fused.CARRY_REGISTERS ([L]; stage,
// prev_len, score, wc, wi, ws, wt int64, the others bool), written in
// place; tables, table_lens: as sz_lcb_walk's.  out: [sz_lcb_step_result_rows(),
// L] int64 (per lane its steps, pushes, occurrence steps, spilled, score
// terms, voting instances, windows, evaluated slots, alive entries, best
// score risen, risen above 0).  ws: the vote's workspace
// (kMaxPool lock words, zero, then `pool` slices of
// sz_lcb_step_workspace_words(IC, PC, CAP, W) words), or null where that is 0.
// CAP: the tier's vote cap (the vote reads min(CAP, IC) columns); slab_max:
// the tier's slabs are the widest; start: the carry's step count; limit:
// the step limit; chunk: the pushes of a walk chunk (WALK_CHUNK).  stamps:
// null, or in a build with SZ_STEP_STAMPS [sz_lcb_step_stamp_parts(), L]
// int64, each lane's split of its steps (step_stamps.cuh's parts); the
// default build refuses one.  Returns a CUDA error code (0: launched).
extern "C" int sz_lcb_step(const long long* leaves, const long long* registers,
                           const long long* tables, const long long* table_lens, void* out,
                           void* ws, int pool, long long L, int IC, int PC, long long CAP, int W,
                           long long k, long long depth, long long m, long long b,
                           long long flank, long long min_run, int slab_max, long long start,
                           long long limit, int chunk, void* stamp_out, void* stream) {
  const int CAPv = static_cast<int>(CAP < IC ? (CAP > 0 ? CAP : 1) : IC);
  const long long smem = step_smem(IC, PC, CAPv, W, 1);
  if (L < 1 || L > 0x7fffffffLL || smem < 0 || chunk < 0 ||
      (!stamps::kOn && stamp_out != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long words = step_workspace_words(IC, PC, CAPv, W);
  if (words < 0 || (words > 0 && (ws == nullptr || pool < 1 || pool > vote::kMaxPool))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  walk::Leaves st{};
  for (int q = 0; q < walk::kLeaves; ++q) st.p[q] = reinterpret_cast<void*>(leaves[q]);
  const walk::Tables wtb = walk::tables_of(tables, table_lens, k);
  walk::Params wpr{L, 0, m, b, flank, IC, PC, chunk, walk::bulk_rows(leaves, IC, PC)};
  vote::Tables vtb{};
  vtb.chr_off = wtb.chr_off;
  vtb.chr_len = wtb.chr_len;
  vtb.jpos = wtb.jpos;
  vtb.jid = wtb.jid;
  vtb.used = wtb.used;
  vtb.n_chr_off = wtb.n_chr_off;
  vtb.n_chr_len = wtb.n_chr_len;
  vtb.n_j = wtb.n_j;
  vtb.n_used = wtb.n_used;
  vtb.k = k;
  vote::Params vpr{};
  vpr.L = L;
  vpr.A = L;
  vpr.depth = depth;
  vpr.b = b;
  vpr.IC = IC;
  vpr.PC = PC;
  vpr.CAP = CAPv;
  vpr.W = W;
  vpr.H = step_table(IC, PC, CAPv, W);
  vpr.retry = 1;
  vpr.ws = words > 0 ? static_cast<unsigned long long*>(ws) : nullptr;
  vpr.ws_slots = words / 3;
  vpr.pool = words > 0 ? pool : 0;
  vpr.spilled = nullptr;
  Carry cr{};
  for (int r = 0; r < kRegisters; ++r) cr.p[r] = reinterpret_cast<void*>(registers[r]);
  const StepParams sp{CAP, slab_max, min_run, start, limit};
  const cudaError_t err = set_step_attributes(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lcb_step_kernel<<<static_cast<unsigned>(L), kThreads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(st, wtb, wpr, vtb, vpr, cr, sp,
                                                         static_cast<i64*>(out),
                                                         static_cast<i64*>(stamp_out));
  return static_cast<int>(cudaGetLastError());
}

// The vote workspace's words a slice of a launch at these shapes (the
// wrapper allocates min(VOTE_POOL, L) slices), 0 where no vote can spill;
// -1 for a shape the kernel does not take (its shared memory past the
// opt-in, or CAP or W past 4,096).  CAP: the tier's (cut to IC).
extern "C" long long sz_lcb_step_workspace_words(int IC, int PC, int CAP, int W) {
  return step_workspace_words(IC, PC, CAP < IC ? CAP : IC, W);
}

// The rows of a launch's per-lane results (kernels.LaneSteps' counts).
extern "C" int sz_lcb_step_result_rows() { return kResults; }

// The rows of a stamped launch's split (step_stamps.cuh's parts), 0 in the
// default build.
extern "C" int sz_lcb_step_stamp_parts() { return stamps::kOn ? stamps::kParts : 0; }

// The step blocks an SM holds at once at these shapes in shared-memory
// layout `layout` (1: the slab resident beside the vote's region, the
// kernel's; 0: PR 20's, the vote's region and the slab in turn), and that
// layout's dynamic shared bytes in *smem_out; minus a CUDA error.
extern "C" int sz_lcb_step_blocks_per_sm(int IC, int PC, int CAP, int W, int layout,
                                         long long* smem_out) {
  const long long smem = step_smem(IC, PC, CAP < IC ? CAP : IC, W, layout);
  if (smem < 0) return -static_cast<int>(cudaErrorInvalidValue);
  if (smem_out != nullptr) *smem_out = smem;
  cudaError_t err = set_step_attributes(smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lcb_step_kernel, kThreads,
                                                        static_cast<size_t>(smem));
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
