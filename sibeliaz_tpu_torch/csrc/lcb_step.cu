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
// summed) and whether a vote took the spill workspace.
//
// What bounds it: the serial chain of a lane's steps.  Each step depends on
// the one before (its vote reads the instances the last walk left), a vote
// is a few rounds of dependent table loads and barriers, and a walk's
// occurrence steps are K5's chain; the bytes a run moves (each lane's slab
// in and out, the tables its votes and walks read) are far under it.  So
// the longest lane sets a launch's time.  The design:
//   * one launch a lane set, one block of 256 threads a lane, and no host
//     work and no read of the card between steps: a finished lane's block
//     ends (no compaction);
//   * the vote is K6's vote_row (csrc/lcb_vote.cuh) on all 8 warps and the
//     walk K5's walk_row (csrc/lcb_walk.cuh) on warps 0-1 (warp 0 walks,
//     warp 1 finds the uniform tails), its barriers named ones over those
//     64 threads while warps 2-7 wait at the step's barrier; thread 0 keeps
//     the protocol registers in shared memory;
//   * the vote's region (hash table, columns, pvid row) and the walk's slab
//     take the same dynamic shared memory in turn: each walk loads the
//     lane's slab by TMA bulk copies and stores the live slab back at its
//     last push, where the next vote reads it.  The other layout (the slab
//     resident for the whole run, the vote reading pvid from it) needs the
//     sum of the two regions; sz_lcb_step_blocks_per_sm gives both
//     occupancies;
//   * one mbarrier serves every walk of the block (walk_row tracks its
//     phase); between the async proxy (the bulk copies) and the generic one
//     (the vote's reads, the rewind's copy) each hand-over is a completed
//     bulk group or a proxy fence, then a barrier;
//   * a spilling vote holds its workspace slice only inside the vote.

#include "lcb_vote.cuh"
#include "lcb_walk.cuh"

extern "C" long long sz_lcb_vote_workspace_words(int PC, int CAP, int W);

namespace {

typedef long long i64;

constexpr int kThreads = vote::kThreads;  // 256; the walk takes threads 0-63
constexpr int kRegisters = 13;            // fused.CARRY_REGISTERS

// fused.CARRY_REGISTERS, in order
enum Register {
  R_STAGE, R_POSITIVE, R_PREV_LEN, R_SCORE, R_ACTIVE, R_RETIER, R_HOSTFB, R_IN_WALK, R_WC,
  R_WI, R_WS, R_WT, R_WLAST
};
// per-lane results, in order
enum Result { S_STEPS, S_PUSHES, S_OCC, S_SPILLED };

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
};

__device__ __forceinline__ i64 wsub(i64 a, i64 b) {
  return static_cast<i64>(static_cast<unsigned long long>(a) - static_cast<unsigned long long>(b));
}

// every access of this thread to global memory, ordered against the bulk
// copies (the async proxy)
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
lcb_step_kernel(walk::Leaves st, walk::Tables wtb, walk::Params wpr, vote::Lanes vln,
                vote::Tables vtb, vote::Params vpr, Carry cr, StepParams sp, i64* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ walk::Shared wsh;
  __shared__ vote::Shared vsh;
  __shared__ i64 vo[vote::kOut];
  __shared__ Lane R;
  const int tid = threadIdx.x;
  const i64 lane = blockIdx.x;
  const i64 L = wpr.L;
  const int IC = wpr.IC, PC = wpr.PC;
  auto lane_reg = [&](int slab, int f) {  // the lane's register f of slab (0 live, 1 rewind)
    const void* p = st.p[slab * walk::kLaneFields + f];
    return walk::is_bool(f) ? static_cast<i64>(static_cast<const uint8_t*>(p)[lane])
                            : static_cast<const i64*>(p)[lane];
  };

  if (tid == 0) {
    walk::mbar_init(&wsh.bar, 1);
    wsh.parity = 0;
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
    R.steps = R.pushes = R.occ = 0;
    R.spilled = 0;
  }
  __syncthreads();

  for (;;) {
    // ---- the step's vote, for a lane not mid-walk ----
    if (tid == 0) {
      R.go = R.active && sp.start + R.steps < sp.limit;
      R.votes = false;
      if (R.go && !R.in_walk) {
        if (lane_reg(0, walk::F_N) > sp.CAP) {  // cap overflow: re-run at a bigger tier
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
    if (R.votes) {
      const int spilled = vote::vote_row(vln, vtb, vpr, lane, lane, true, fwd, false, smem, vsh, vo);
      walk::fence_async_smem();  // this thread's writes to the region, before bulk loads into it
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
    }
    __syncthreads();

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
      const walk::RowOut o = walk::walk_row(st, wtb, wpr, row, smem, wsh);
      if (tid == 0) {
        walk::bulk_wait_all();  // the slabs' bulk stores are done,
        fence_async_global();   // and ordered before the block's reads of the lane
        R.pushes += o.pushes;
        R.occ += o.occ_steps;
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
    if (tid == 0) {
      const bool fin = no_winner || walk_done;
      const i64 middle = wsub(lane_reg(0, walk::F_RF), lane_reg(0, walk::F_LF));
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
        R.prev_len = wsub(lane_reg(1, walk::F_RF), lane_reg(1, walk::F_LF));
      }
      R.steps += 1;
    }
    __syncthreads();
    if (R.to_bwd) {
      for (int f = 0; f < walk::kLaneFields; ++f) {
        const bool inst = f < walk::kInst, path = f == walk::F_PVID || f == walk::F_PDIST;
        const i64 bytes = (walk::is_bool(f) ? 1 : 8) * (inst ? IC : path ? PC : 1);
        walk::copy_bytes(static_cast<uint8_t*>(st.p[f]) + lane * bytes,
                         static_cast<const uint8_t*>(st.p[walk::kLaneFields + f]) + lane * bytes,
                         bytes, tid, kThreads);
      }
      fence_async_global();  // the copy, before the next walk's bulk loads read it
    }
    __syncthreads();
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
  }
}

// The dynamic shared memory of a launch at these shapes: layout 0 (the
// kernel's) gives the vote's region and the walk's slab the same bytes in
// turn; layout 1 keeps the slab resident beside the vote's region, whose
// pvid row it would then read from the slab.  -1 for a shape K5's or K6's
// algorithm does not take.
long long step_smem(int IC, int PC, int CAP, int W, int layout) {
  if (IC < 1 || PC < 1 || CAP < 1 || W < 1 || CAP > IC || CAP > vote::kMaxCols ||
      W > vote::kMaxCols || layout < 0 || layout > 1) {
    return -1;
  }
  const long long votes = vote::smem_bytes(CAP, PC, vote::table_slots(CAP, W));
  const long long slab = walk::slab_bytes(IC, PC);
  const long long bytes = layout == 0 ? (votes > slab ? votes : slab) : votes - 8LL * PC + slab;
  return votes <= vote::kMaxSmem && slab <= walk::kMaxSmem && bytes <= walk::kMaxSmem ? bytes : -1;
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
// place; tables, table_lens: as sz_lcb_walk's.  out: [4, L] int64 (per lane
// its steps, pushes, occurrence steps, spilled).  ws: the vote's workspace
// (kMaxPool lock words, zero, then `pool` slices of
// sz_lcb_vote_workspace_words(PC, CAP, W) words), or null where that is 0.
// CAP: the tier's vote cap (the vote reads min(CAP, IC) columns); slab_max:
// the tier's slabs are the widest; start: the carry's step count; limit:
// the step limit; chunk: the pushes of a walk chunk (WALK_CHUNK).  Returns
// a CUDA error code (0: launched).
extern "C" int sz_lcb_step(const long long* leaves, const long long* registers,
                           const long long* tables, const long long* table_lens, void* out,
                           void* ws, int pool, long long L, int IC, int PC, long long CAP, int W,
                           long long k, long long depth, long long m, long long b,
                           long long flank, long long min_run, int slab_max, long long start,
                           long long limit, int chunk, void* stream) {
  const int CAPv = static_cast<int>(CAP < IC ? (CAP > 0 ? CAP : 1) : IC);
  const long long smem = step_smem(IC, PC, CAPv, W, 0);
  if (L < 1 || L > 0x7fffffffLL || smem < 0 || chunk < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long words = sz_lcb_vote_workspace_words(PC, CAPv, W);
  if (words < 0 || (words > 0 && (ws == nullptr || pool < 1 || pool > vote::kMaxPool))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  walk::Leaves st{};
  for (int q = 0; q < walk::kLeaves; ++q) st.p[q] = reinterpret_cast<void*>(leaves[q]);
  const walk::Tables wtb = walk::tables_of(tables, table_lens, k);
  walk::Params wpr{L, 0, m, b, flank, IC, PC, chunk, walk::bulk_rows(leaves, IC, PC)};
  // the vote's lane fields (lcb/kernels.py's VOTE_LANE_FIELDS) of the live slab
  const int vote_fields[vote::kLaneFields] = {walk::F_CHR, walk::F_S,  walk::F_FI, walk::F_BI,
                                              walk::F_GOOD, walk::F_INS, walk::F_N, walk::F_PVID,
                                              walk::F_PN,  walk::F_RV, walk::F_LV};
  vote::Lanes vln{};
  for (int q = 0; q < vote::kLaneFields; ++q) {
    vln.p[q] = reinterpret_cast<const i64*>(leaves[vote_fields[q]]);
  }
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
  vpr.H = vote::table_slots(CAPv, W);
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
                    static_cast<cudaStream_t>(stream)>>>(st, wtb, wpr, vln, vtb, vpr, cr, sp,
                                                         static_cast<i64*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The step blocks an SM holds at once at these shapes in shared-memory
// layout `layout` (0: the vote's region and the slab in turn, the kernel's;
// 1: the slab resident beside the vote's region), and that layout's dynamic
// shared bytes in *smem_out; minus a CUDA error.
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
