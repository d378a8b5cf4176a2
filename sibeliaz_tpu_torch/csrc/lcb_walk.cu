// K5 lcb_walk: the LCB walk's device loop for both device LCB engines, for
// Hopper (sm_90a).  A row's walk is lcb_walk.cuh's walk_row<false>; K7
// lcb_step's blocks run walk_row<true>, the same walk on a lane kept in
// shared memory; this file holds the kernel a row a block, its probes and
// its C interface.
//
// Replaces the jax.lax.while_loop of pushes of
// sibeliaz_tpu/lcb/resident.py::_walk_device (:138) and
// sibeliaz_tpu/lcb/fused.py::_walk_chunk (:128), each iteration one
// resident.py::_push_score_snap (:102), whose push,
// batched_push_device.py::_push_impl_traced (:307), runs the pushed
// vertex's occurrences as a jax.lax.fori_loop (:528); XLA programs, not
// Pallas kernels.
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
//   * the score (a reduction over the live good instances), and on an
//     improvement the lane copied to the rewind slab (forward pushes) and
//     to the result slab (a positive score), the best score and the
//     snapshot flag updated;
//   * the iterator one junction on, `last` the push's success.
// Per row it writes i, last, at_target, the score, n, the flanks and the
// overflow flag of the final state, its push count and its occurrence
// steps (the pushed vertices' occurrence counts, summed). The searches give
// torch.searchsorted's answers (the rows are sorted, as it requires); every
// table index is clipped as in the plain version; sums and products wrap at
// 64 bits as torch's do.
//
// The state is walked in place: a row writes only its own lane (the live
// slab once at the end, the rewind and result slabs on an improvement), and
// a row that made no push writes nothing. Rows name distinct lanes, so no
// block reads what another writes, but for the sentinels, which read lane
// L-1: where a row walks lane L-1, that row's block reports the sentinels'
// state results (lane L-1 as it was) and the sentinels leave them alone.
//
// What bounds it: on the recorded calls (a push or two a row) the bytes of
// each walking row's slab, read once and written up to three times, and the
// chain of dependent table loads before the first push; on long pushes the
// latency of the serial chain (each occurrence step depends on the one
// before: a later occurrence sees the instances the earlier ones changed).
// The design:
//   * one block of 64 threads a row: warp 0 walks, warp 1 helps; four
//     blocks an SM at IC 512 / PC 1024 (54,272 bytes of slab: nine int64
//     instance rows, ffin and bfin as bytes, pvid and pdist), and the
//     registers of a thread (up to 255) hold warp 0's chain without spills;
//   * a walking row's slab arrives by TMA bulk copies, one a field row,
//     issued by one thread once its first edges are loaded (so that those
//     loads do not queue behind the copies) and awaited on one mbarrier; it
//     goes out by bulk stores from shared memory, the live lane as soon as
//     the last push's occurrences are done; a field whose rows' size or
//     start is not a multiple of 16 bytes is copied by a vectorised loop
//     instead; a row that does not walk loads no slab and scores its lane
//     where it lies;
//   * the edges of 32 pushes, and the occurrence-only table words of 32
//     occurrence steps (occurrence, chromosome offset, junction id and
//     strand, position, used flag and prefix, the backward escape's
//     start-side terms), are loaded ahead, one a lane, so a step's serial
//     part is a search over the live keys, the candidate's fields, one round
//     of table loads at the candidate's end and the search for its vertex;
//   * the three searches are warp-parallel: a round probes 32 pivots, one a
//     lane, and a ballot keeps the span up to the first that goes left: two
//     rounds up to 1,024 columns;
//   * a shift moves only the columns below the row's uniform tail (the
//     columns from which every field equals the last column's), which warp
//     1 finds while warp 0 starts the first push and hands over at a named
//     barrier, and warp 0 keeps up to date; so a shift is usually short: up
//     to 64 columns warp 0 shifts alone, and the block joins, at a barrier,
//     only for a longer shift, a score over more than 64 instances, and a
//     store by the vectorised loop.

#include "lcb_walk.cuh"

using namespace walk;

namespace {

constexpr int kBlocksPerSm = 4;

// per-row results, in order
enum Result { O_I, O_LAST, O_AT, O_SCORE, O_N, O_RF, O_LF, O_OVF, O_PUSHES, O_OCC };

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

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lcb_walk_kernel(Leaves st, Tables tb, Args a, Params pr, i64* res) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ Shared sh;
  const int lane = threadIdx.x & 31;
  const i64 r = blockIdx.x;
  const i64 L = pr.L;
  Row row;
  row.lane = a.rows != nullptr ? a.rows[r] : r;
  row.c = a.c[r];
  row.i = a.i[r];
  row.s = a.s[r];
  row.tvid = a.tvid[r];
  row.fwd = a.fwd[r] != 0;
  row.active = a.active[r] != 0;
  row.last = a.last[r] != 0;
  row.serve = a.rows != nullptr && row.lane == L - 1;
  if (threadIdx.x == 0) {  // walk_row's first barrier orders this before any use
    mbar_init(&sh.bar, 1);
    sh.parity = 0;
  }
  const RowOut o = walk_row<false>(st, tb, pr, row, smem, sh, nullptr);
  if (threadIdx.x >= 32) return;
  const i64 lane_in = row.lane;
  const i64 it = o.it, score = o.score, n = o.n, rf = o.rf, lf = o.lf;
  const i64 pushes = o.pushes, occ_steps = o.occ_steps;
  const bool last = o.last, after = o.after, ovf = o.ovf, serve = row.serve;
  const i64* init = o.init;

  // a sentinel leaves its state results to the row that walks lane L-1
  bool defer = false;
  if (a.rows != nullptr && lane_in >= L) {
    for (i64 q = lane; q < pr.A; q += 32) defer |= a.rows[q] == L - 1;
    defer = __any_sync(0xffffffffu, defer);
  }
  const i64 A = pr.A;
  uint8_t* bytes_of = reinterpret_cast<uint8_t*>(res);
  if (lane == 0) {
    res[O_I * A + r] = it;
    bytes_of[8 * O_LAST * A + r] = last;
    bytes_of[8 * O_AT * A + r] = after;
    res[O_PUSHES * A + r] = pushes;
    res[O_OCC * A + r] = occ_steps;
    if (!defer) {
      res[O_SCORE * A + r] = score;
      res[O_N * A + r] = n;
      res[O_RF * A + r] = rf;
      res[O_LF * A + r] = lf;
      bytes_of[8 * O_OVF * A + r] = ovf != 0;
    }
  }
  if (serve) {
    for (i64 q = lane; q < A; q += 32) {
      if (a.rows[q] >= L) {
        res[O_SCORE * A + q] = init[0];
        res[O_N * A + q] = init[1];
        res[O_RF * A + q] = init[2];
        res[O_LF * A + q] = init[3];
        bytes_of[8 * O_OVF * A + q] = init[4] != 0;
      }
    }
  }
  if (lane == 0) bulk_wait_read();  // shared memory stays until the stores have read it
}

// The chain floor's probe of the kernel's first design, whose thread 0 ran
// each occurrence step: `iters` steps of four dependent loads served from
// L2 (a pointer chase over `table`) by thread 0 and one barrier of 256
// threads.
__global__ void __launch_bounds__(256) lcb_chain_probe_kernel(const i64* table, int iters,
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

// The chain floor's probe of this step: `iters` steps of one dependent load
// served from L2 (the candidate's table words, loaded together) by warp 0
// of a walk block and one __syncwarp, the least one occurrence step costs.
__global__ void __launch_bounds__(kThreads) lcb_step_probe_kernel(const i64* table, int iters,
                                                                  i64* out) {
  if (threadIdx.x >= 32) return;
  i64 v = 0;
  for (int step = 0; step < iters; ++step) {
    v = __ldcg(table + v);
    __syncwarp();
  }
  if (threadIdx.x == 0) out[0] = v;
}

cudaError_t set_walk_attributes(long long smem) {
  cudaError_t err = cudaFuncSetAttribute(
      lcb_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(lcb_walk_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

}  // namespace

// leaves: host array of the 68 device pointers of _state_leaves (ln, rw,
// sn: the 22 LANE_FIELDS each; best_score, has_snap), [L, IC] / [L, PC] /
// [L] row-major, int64 but the bool (1-byte) ffin, bfin, overflow and
// has_snap; walked in place, no two overlapping. tables: host array of 11
// device pointers (chr_off, chr_len, jpos, jid, used_pfx, used, seq_off,
// seq, occ_off, occ_chr, occ_idx: int64 but the uint8 used and seq);
// table_lens: host array of their 9 lengths (chr_off, chr_len, jpos = jid,
// used_pfx, used, seq_off, seq, occ_off, occ_chr = occ_idx); args: host
// array of 8 device pointers over A rows (rows, null for lane r at row r,
// else int64 and distinct below L; c, i, s, tvid int64; fwd, active, last
// bool); res: [10, A] int64, written (last, at_target and overflow as bytes
// at the start of their rows). Returns cudaGetLastError() after the
// launch, or the first error before it.
extern "C" int sz_lcb_walk(const long long* leaves, const long long* tables,
                           const long long* table_lens, const long long* args, void* res,
                           long long L, long long A, int IC, int PC, long long k, long long m,
                           long long b, long long flank, int limit, void* stream) {
  const long long smem = slab_bytes(IC, PC);
  if (L < 1 || A < 0 || A > 0x7fffffffLL || IC < 1 || PC < 1 || limit < 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (A == 0) return 0;
  Leaves st{};
  for (int q = 0; q < kLeaves; ++q) st.p[q] = reinterpret_cast<void*>(leaves[q]);
  const Tables tb = tables_of(tables, table_lens, k);
  Args a{};
  a.rows = reinterpret_cast<const i64*>(args[0]);
  a.c = reinterpret_cast<const i64*>(args[1]);
  a.i = reinterpret_cast<const i64*>(args[2]);
  a.s = reinterpret_cast<const i64*>(args[3]);
  a.fwd = reinterpret_cast<const uint8_t*>(args[4]);
  a.tvid = reinterpret_cast<const i64*>(args[5]);
  a.active = reinterpret_cast<const uint8_t*>(args[6]);
  a.last = reinterpret_cast<const uint8_t*>(args[7]);
  Params pr{L, A, m, b, flank, IC, PC, limit, 0};
  pr.bulk = bulk_rows(leaves, IC, PC);
  // set at every launch: the attributes belong to the current device's
  // context, and a host call costs little beside the kernel
  const cudaError_t err = set_walk_attributes(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lcb_walk_kernel<<<static_cast<unsigned>(A), kThreads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(st, tb, a, pr, static_cast<i64*>(res));
  return static_cast<int>(cudaGetLastError());
}

// The walk blocks an SM holds at once at slab widths IC and PC, or minus a
// CUDA error.
extern "C" int sz_lcb_walk_blocks_per_sm(int IC, int PC) {
  const long long smem = slab_bytes(IC, PC);
  if (IC < 1 || PC < 1 || smem > kMaxSmem) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_walk_attributes(smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lcb_walk_kernel, kThreads,
                                                        static_cast<size_t>(smem));
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// table: n int64 entries, each an index into the table (a pointer chase);
// out: one int64.
extern "C" int sz_lcb_chain_probe(const void* table, int iters, void* out, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  lcb_chain_probe_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(table), iters, static_cast<i64*>(out));
  return static_cast<int>(cudaGetLastError());
}

// As sz_lcb_chain_probe, for this step's probe.
extern "C" int sz_lcb_step_probe(const void* table, int iters, void* out, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  lcb_step_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(table), iters, static_cast<i64*>(out));
  return static_cast<int>(cudaGetLastError());
}

