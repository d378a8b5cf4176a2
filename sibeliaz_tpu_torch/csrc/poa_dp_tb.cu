// K3 poa_dp_tb: banded sequence-vs-DAG POA DP and its traceback for a batch
// of POA blocks, for Hopper (sm_90a).
//
// Replaces sibeliaz_tpu/align/tpu_poa.py::_dp_single (:74), _tb_single
// (:164) and their vmap, _dp_tb_batch (:205). Per block, rank r of the
// DAG's topological order covers sequence rows [off[r], off[r] + W):
//   ext[p][e]  = predecessor p's H at row off[r] + e - 1 (e = 0..W), or
//                GAP * row for the virtual source, or NEG = -2^29 when the
//                slot is unused or the row lies outside p's window;
//   diag[w]    = max_p ext[p][w] + (seq[row] == char[r] ? 5 : -4),
//   horiz[w]   = max_p ext[p][w + 1] - 8, each with the first arg-max slot;
//   base       = max(diag, horiz), a match when diag >= horiz;
//   H[r][w]    = max_{w' <= w}(base[w'] + 8w') - 8w  (the insertion chain
//                as a damped running maximum), an insertion where it
//                exceeds base.
// The direction byte holds the slot in bits 0-3, match in bit 4 and
// insertion in bit 5. The sink is the sink rank with the highest H at row
// seq_len, ties to the smallest rank; the traceback walks the direction
// bytes from there to the source, exactly as _tb_single.
//
// What bounds it: latency on a serial chain, not bytes and not arithmetic.
// Rank r reads any earlier rank's H row, so a block's ranks run one after
// the other (25-60 k of them for a 25 kbp copy), and a dispatch holds only
// 2-11 blocks, one SM each. A rank costs what lies on its dependent path:
// where its predecessor row and its own metadata come from, the block-wide
// max-scan with its barriers, and the instructions one SM must execute for W
// cells. The design shortens each of these:
//   * poa_meta_kernel, a parallel pre-pass, writes one 80-byte record per
//     rank (window offset, character, valid-slot mask, sink flag, and every
//     slot's predecessor rank with that predecessor's window offset), so
//     nothing in the rank loop waits on a load that depends on a load. The
//     DP stages the records into shared memory 32 ranks ahead (cp.async,
//     double-buffered) and walks the valid slots only;
//   * a thread keeps its COLS columns' H and sequence bytes in registers
//     from one rank to the next (the kernel is a template on COLS). A chain
//     step - one predecessor, the rank before, the window moved on by one
//     row or none: every rank when a second copy meets the first - takes its
//     ext values from those registers, one neighbour's value from shared
//     memory and at most one new sequence byte (a window that is no whole
//     number of threads' columns chains only where it does not move);
//   * the last `depth` H rows live in a shared-memory ring, interleaved so
//     that neighbouring threads hit neighbouring banks; any other
//     predecessor in the ring is read from there, an older one from device
//     memory. H and the direction bytes are stored to device memory once,
//     off the dependent path (the traceback and far predecessors read them);
//   * two block barriers per rank: warp scan, lane 31 posts the warp's
//     aggregate, barrier, every warp folds the aggregates itself, pass 2
//     from registers, ring row written, barrier;
//   * each thread keeps the best sink score among the cells it writes, so
//     no pass over H follows the loop;
//   * poa_tb_kernel walks the traceback with one warp in lock step: lane l
//     holds word l of the current rank's record, so the next rank's window
//     offset is known with the rank, and the records and direction bytes the
//     walk will need are copied into shared memory ahead of it along the
//     predicted diagonal (cp.async), so a step waits on shared memory only.
// Windows wider than COLS * threads run as several column chunks per rank,
// each with its own scan and a carried maximum, reading device memory
// only. All arithmetic is int32. Ranks past the last one with any
// predecessor are padding and are skipped; predecessors must have lower
// ranks (a topological order).

#include <climits>
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPreds = 8;
constexpr int kNeg = -(1 << 29);
constexpr int kMatch = 5;
constexpr int kMismatch = -4;
constexpr int kGap = -8;
constexpr int kDirMatch = 1 << 4;
constexpr int kDirIns = 1 << 5;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
// A rank's record: word 0 its window offset, word 1 its character (bits
// 0-7), valid-slot mask (8-15) and sink flag (16), words 2+2p and 3+2p slot
// p's predecessor rank and that predecessor's window offset; 18, 19 unused.
constexpr int kRec = 20;
constexpr int kTile = 32;  // ranks staged into shared memory at a time
constexpr int kStageWords = 2 * kTile * kRec;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ int warp_incl_max(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

__device__ __forceinline__ void keep_better(int& s, int& r, int s2, int r2) {
  if (s2 > s || (s2 == s && r2 < r)) {
    s = s2;
    r = r2;
  }
}

// One thread per rank: the rank's record, and the block's ranks in use
// (1 + the last rank with any predecessor) as a maximum into r_used[b].
__global__ void poa_meta_kernel(const uint8_t* __restrict__ node_char,
                                const int32_t* __restrict__ pred_idx,
                                const uint8_t* __restrict__ pred_ok,
                                const uint8_t* __restrict__ sink_mask,
                                const int32_t* __restrict__ off, int n_max,
                                int n_pad, int32_t* __restrict__ meta,
                                int32_t* __restrict__ r_used) {
  const int b = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nm = static_cast<size_t>(n_max);
  const int32_t* off_b = off + b * (nm + 1);
  int last = 0;
  if (r < n_max) {
    const size_t row = (b * nm + r) * kMaxPreds;
    int rec[kRec];
    int mask = 0;
#pragma unroll
    for (int p = 0; p < kMaxPreds; ++p) {
      if (pred_ok[row + p] != 0) mask |= 1 << p;
      const int pid = pred_idx[row + p];
      rec[2 + 2 * p] = pid;
      rec[3 + 2 * p] = (pid >= 0 && pid <= n_max) ? off_b[pid] : 0;
    }
    rec[0] = off_b[r];
    rec[1] = node_char[b * nm + r] | (mask << 8) |
             ((sink_mask[b * nm + r] != 0) << 16);
    rec[18] = rec[19] = 0;
    int4* dst = reinterpret_cast<int4*>(
        meta + (static_cast<size_t>(b) * n_pad + r) * kRec);
#pragma unroll
    for (int q = 0; q < kRec / 4; ++q) {
      dst[q] = make_int4(rec[4 * q], rec[4 * q + 1], rec[4 * q + 2],
                         rec[4 * q + 3]);
    }
    if (mask) last = r + 1;
  }
  last = __reduce_max_sync(kFull, last);
  if ((threadIdx.x & 31) == 0 && last > 0) atomicMax(&r_used[b], last);
}

// One ext value v of slot s at column c: the first arg-max keeps the
// earlier slot on ties.
template <int N>
__device__ __forceinline__ void take(int (&bv)[N], int (&bs)[N], int c, int v,
                                     int s) {
  if (v > bv[c]) {
    bv[c] = v;
    bs[c] = s;
  }
}

template <int COLS>
__device__ __forceinline__ void store_h(int32_t* p, const int (&h)[COLS]) {
  if constexpr (COLS >= 4) {
#pragma unroll
    for (int q = 0; q < COLS / 4; ++q) {
      __stcg(reinterpret_cast<int4*>(p) + q,
             make_int4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]));
    }
  } else if constexpr (COLS == 2) {
    __stcg(reinterpret_cast<int2*>(p), make_int2(h[0], h[1]));
  } else {
    __stcg(p, h[0]);
  }
}

template <int COLS>
__device__ __forceinline__ void store_d(uint8_t* p, const int (&d)[COLS]) {
  if constexpr (COLS >= 4) {
#pragma unroll
    for (int q = 0; q < COLS / 4; ++q) {
      reinterpret_cast<uint32_t*>(p)[q] =
          static_cast<uint32_t>(d[4 * q]) |
          (static_cast<uint32_t>(d[4 * q + 1]) << 8) |
          (static_cast<uint32_t>(d[4 * q + 2]) << 16) |
          (static_cast<uint32_t>(d[4 * q + 3]) << 24);
    }
  } else if constexpr (COLS == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(d[0] | (d[1] << 8));
  } else {
    p[0] = static_cast<uint8_t>(d[0]);
  }
}

// Starts the asynchronous copy of one tile of records into its half of the
// staging buffer.
__device__ __forceinline__ void stage_records(const int32_t* meta_b, int* s_meta,
                                              int tile) {
  const int4* src = reinterpret_cast<const int4*>(
      meta_b + static_cast<size_t>(tile) * kTile * kRec);
  int4* dst = reinterpret_cast<int4*>(s_meta + (tile & 1) * kTile * kRec);
  for (int q = threadIdx.x; q < kTile * kRec / 4; q += blockDim.x) {
    __pipeline_memcpy_async(dst + q, src + q, 16);
  }
  __pipeline_commit();
}

// The best ext value and its first arg-max slot at ext columns wb ..
// wb + COLS of one rank (row j0 is ext column wb's sequence row), over the
// valid slots of the rank's record in slot order; the first unused slot
// competes as NEG at its place. A predecessor at most `depth` ranks back is
// read from the ring (slot `cur` is rank r's), an older one from H.
template <int COLS>
__device__ __forceinline__ void gather_ext(int (&bv)[COLS + 1],
                                           int (&bs)[COLS + 1], const int* rec,
                                           unsigned mask, int r, int j0,
                                           int n_max, int W, int S, int T,
                                           const int* s_ring, int cur, int depth,
                                           const int32_t* Hb) {
  constexpr int LOG = COLS == 1 ? 0 : COLS == 2 ? 1 : COLS == 4 ? 2 : 3;
  const unsigned uw = static_cast<unsigned>(W);
#pragma unroll
  for (int c = 0; c <= COLS; ++c) {
    bv[c] = INT_MIN;
    bs[c] = kMaxPreds;
  }
  const int fu = __ffs(~mask & 0xff) - 1;
  bool unused_done = fu < 0;
  for (unsigned m = mask; m; m &= m - 1) {
    const int s = __ffs(m) - 1;
    if (!unused_done && fu < s) {
#pragma unroll
      for (int c = 0; c <= COLS; ++c) take(bv, bs, c, kNeg, fu);
      unused_done = true;
    }
    const int2 pp = *reinterpret_cast<const int2*>(rec + 2 + 2 * s);
    const int pid = pp.x;
    const int i0 = j0 - pp.y;  // ext column wb in the predecessor's window
    if (pid == n_max) {  // the virtual source
#pragma unroll
      for (int c = 0; c <= COLS; ++c) {
        const bool ok = static_cast<unsigned>(i0 + c) < uw && j0 + c >= 0;
        take(bv, bs, c, ok ? kGap * (j0 + c) : kNeg, s);
      }
    } else if (r - pid <= depth) {  // a row in the ring
      int slot = cur - (r - pid);
      if (slot < 0) slot += depth;
      const int* row = s_ring + slot * COLS * T;
#pragma unroll
      for (int c = 0; c <= COLS; ++c) {
        const int idx = i0 + c;
        const bool ok = static_cast<unsigned>(idx) < uw && j0 + c >= 0;
        take(bv, bs, c, ok ? row[(idx & (COLS - 1)) * T + (idx >> LOG)] : kNeg,
             s);
      }
    } else {  // an older row, from device memory (L2: another thread wrote it)
      const int32_t* row = Hb + static_cast<size_t>(pid) * S;
#pragma unroll
      for (int c = 0; c <= COLS; ++c) {
        const int idx = i0 + c;
        const bool ok = static_cast<unsigned>(idx) < uw && j0 + c >= 0;
        take(bv, bs, c, ok ? __ldcg(row + idx) : kNeg, s);
      }
    }
  }
  if (!unused_done) {
#pragma unroll
    for (int c = 0; c <= COLS; ++c) take(bv, bs, c, kNeg, fu);
  }
}

// One chain step at a thread's columns: h holds the rank before's H there
// and becomes this rank's match / deletion values, dd their directions.
// SHIFT = 1: the window moved on by one row, ext column c is h[c] and the
// last one `edge`, the right neighbour's first value. SHIFT = 0: it did not
// move, ext column c is h[c - 1] and the first one `edge`, the left
// neighbour's last value. The one unused slot after slot 0 takes what lies
// below NEG.
template <int COLS, int SHIFT>
__device__ __forceinline__ void chain_cells(int (&h)[COLS], int (&dd)[COLS],
                                            const int (&sq)[COLS], int ch,
                                            int edge) {
  int e[COLS + 1], es[COLS + 1];
#pragma unroll
  for (int c = 0; c <= COLS; ++c) {
    const int v = SHIFT == 1 ? (c < COLS ? h[c < COLS ? c : 0] : edge)
                             : (c > 0 ? h[c > 0 ? c - 1 : 0] : edge);
    es[c] = v < kNeg;
    e[c] = max(v, kNeg);
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int diag = e[c] + (sq[c] == ch ? kMatch : kMismatch);
    const int horiz = e[c + 1] + kGap;
    const bool is_match = diag >= horiz;
    h[c] = is_match ? diag : horiz;
    dd[c] = is_match ? (es[c] | kDirMatch) : es[c + 1];
  }
}

// The DP of one POA block per thread block. Thread t owns columns
// [chunk * COLS * T + t * COLS, + COLS) of every rank; the window is one
// chunk unless CHUNKED; WHOLE says that W is a multiple of COLS, so that no
// thread's columns straddle the window's end. Dynamic shared memory: the staged records, 32 warp
// aggregates, then the ring of `depth` rows (none when CHUNKED), row
// element w at (w % COLS) * T + w / COLS.
//
// Unchunked, a thread keeps its columns' H of the last rank (h) and the
// sequence bytes under them (sq) in registers. A chain step - one
// predecessor, the rank before, in slot 0, the window moved on by one row
// (only if WHOLE) or none - takes its ext values from h and
// one neighbour's value from the ring, and at most one new sequence byte.
// Every other rank gathers.
template <int COLS, bool CHUNKED, bool WHOLE>
__global__ void __launch_bounds__(kMaxThreads, 1)
poa_dp_kernel(const uint8_t* __restrict__ seq0p,
              const int32_t* __restrict__ seq_len,
              const int32_t* __restrict__ meta,
              const int32_t* __restrict__ r_used_g, int n_max, int n_pad,
              int W, int S, int P, int seq_stride, int depth, int32_t* H,
              uint8_t* __restrict__ dirs, int32_t* __restrict__ out_r,
              int32_t* __restrict__ out_i, int32_t* __restrict__ sink_out) {
  extern __shared__ int4 s_dyn[];
  int* s_meta = reinterpret_cast<int*>(s_dyn);
  int* s_warp = s_meta + kStageWords;
  int* s_ring = s_warp + 32;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const size_t nm = static_cast<size_t>(n_max);
  const uint8_t* seq = seq0p + static_cast<size_t>(b) * seq_stride;
  const int32_t* meta_b = meta + static_cast<size_t>(b) * n_pad * kRec;
  int32_t* Hb = H + b * (nm + 1) * S;
  int32_t* Hr = Hb;                // row r of H and of the direction bytes
  uint8_t* Dr = dirs + b * nm * S;
  const int r_used = max(1, r_used_g[b]);
  const int n = seq_len[b];
  const int row_words = COLS * T;
  const int G = CHUNKED ? (W + row_words - 1) / row_words : 1;

  stage_records(meta_b, s_meta, 0);
  __pipeline_wait_prior(0);
  __syncthreads();

  int cur = 0;  // ring slot of rank r, and where it and the slot before start
  int cur_at = 0, prev_at = 0;
  int sink_s = INT_MIN, sink_r = INT_MAX;  // this thread's best sink cell
  int first_inv = -1;  // the first rank that is no sink in its window
  int h[COLS], sq[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) h[c] = sq[c] = 0;

  for (int r = 0; r < r_used; ++r, Hr += S, Dr += S) {
    const int rr = r & (kTile - 1);
    const int tile = r / kTile;
    if (rr == 0 && (tile + 1) * kTile < r_used) {
      stage_records(meta_b, s_meta, tile + 1);
    }
    const int* rec = s_meta + ((tile & 1) * kTile + rr) * kRec;
    const int4 head = *reinterpret_cast<const int4*>(rec);
    const int off_r = head.x;
    const int ch = head.y & 0xff;
    const int sidx = n - off_r;
    bool sink_here = false;
    if (first_inv < 0 || (head.y & 0x10000)) {
      sink_here = (head.y & 0x10000) && sidx >= 0 && sidx < W;
      if (!sink_here && first_inv < 0) first_inv = r;
    }
    const int shift = off_r - head.w;  // rows the window moved on from slot 0's
    bool chain = false;
    if constexpr (!CHUNKED) {
      // a window that moves on under a thread that straddles its end would
      // need the new byte in the middle of sq: such a rank gathers
      chain = depth > 0 && ((head.y >> 8) & 0xff) == 1 &&
              head.z == r - 1 && head.w >= 0 &&
              (shift == 0 || (shift == 1 && WHOLE));
    }
    int carry = INT_MIN;  // the scan's maximum over the earlier chunks

    for (int g = 0; g < G; ++g) {
      const int wb = (CHUNKED ? g * row_words : 0) + tid * COLS;
      int dd[COLS];
      if (chain) {
        // ext column wb + c is column wb + c + shift - 1 of the rank before
        const int* prow = s_ring + prev_at;
        if (shift == 1) {
          const int right = wb + COLS < W ? prow[tid + 1] : kNeg;
#pragma unroll
          for (int c = 0; c + 1 < COLS; ++c) sq[c] = sq[c + 1];
          if (wb < W) sq[COLS - 1] = seq[off_r + wb + COLS - 1];
          chain_cells<COLS, 1>(h, dd, sq, ch, right);
        } else {
          const int left = tid > 0 ? prow[(COLS - 1) * T + tid - 1] : kNeg;
          chain_cells<COLS, 0>(h, dd, sq, ch, left);
        }
      } else {
        int bv[COLS + 1], bs[COLS + 1];
        gather_ext<COLS>(bv, bs, rec, (head.y >> 8) & 0xff, r, off_r + wb - 1,
                         n_max, W, S, T, s_ring, cur, depth, Hb);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          sq[c] = seq[off_r + min(wb + c, W - 1)];
          const int diag = bv[c] + (sq[c] == ch ? kMatch : kMismatch);
          const int horiz = bv[c + 1] + kGap;
          const bool is_match = diag >= horiz;
          h[c] = is_match ? diag : horiz;
          dd[c] = is_match ? (bs[c] | kDirMatch) : bs[c + 1];
        }
      }

      // the block's exclusive max-scan of base + 8w, over the chunks so far
      int agg = INT_MIN;
      if (wb + COLS <= W) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) agg = max(agg, h[c] + 8 * (wb + c));
      } else {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          if (wb + c < W) agg = max(agg, h[c] + 8 * (wb + c));
        }
      }
      const int incl = warp_incl_max(agg);
      if (lane == 31) s_warp[warp] = incl;
      __syncthreads();  // A: the warp aggregates are posted
      const int other = lane < nwarps ? s_warp[lane] : INT_MIN;
      const int before = __reduce_max_sync(kFull, lane < warp ? other : INT_MIN);
      int run = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) run = INT_MIN;
      run = max(max(run, before), carry);
      if (CHUNKED) carry = max(carry, __reduce_max_sync(kFull, other));

      // pass 2: the damped running maximum; insertions where it beats base
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int w8 = 8 * (wb + c);
        run = max(run, h[c] + w8);
        if (run - w8 > h[c]) {
          h[c] = run - w8;
          dd[c] = kDirIns;
        }
      }
      if (sink_here && sidx >= wb && sidx < wb + COLS) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          if (wb + c == sidx) keep_better(sink_s, sink_r, h[c], r);
        }
      }
      if (!CHUNKED && !WHOLE) {  // past the window the next chain step reads NEG
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          if (wb + c >= W) h[c] = kNeg;
        }
      }
      if (!CHUNKED && depth > 0) {
        int* row = s_ring + cur_at + tid;
#pragma unroll
        for (int c = 0; c < COLS; ++c) row[c * T] = h[c];
      }
      if (wb < W) {  // rows are S apart, a multiple of 8: aligned, and whole
        store_h<COLS>(Hr + wb, h);
        store_d<COLS>(Dr + wb, dd);
      }
      if (rr == kTile - 1 && g == G - 1) __pipeline_wait_prior(0);
      __syncthreads();  // B: row r (and the next records) are complete
    }
    prev_at = cur_at;
    cur_at += row_words;
    if (++cur >= depth) cur = cur_at = 0;
  }

  // the traceback registers start as -1 (None)
  int32_t* orow = out_r + static_cast<size_t>(b) * P;
  int32_t* irow = out_i + static_cast<size_t>(b) * P;
  for (int t = tid; t < P; t += T) {
    orow[t] = -1;
    irow[t] = -1;
  }

  // sink choice at row seq_len: max score, ties to the smallest rank; a
  // rank that is no sink in its window (or is padding) scores exactly NEG
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int os = __shfl_down_sync(kFull, sink_s, d);
    const int orank = __shfl_down_sync(kFull, sink_r, d);
    keep_better(sink_s, sink_r, os, orank);
  }
  if (lane == 0) {
    s_warp[warp] = sink_s;
    s_meta[warp] = sink_r;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int k = 1; k < nwarps; ++k) {
    keep_better(sink_s, sink_r, s_warp[k], s_meta[k]);
  }
  if (first_inv < 0 && r_used < n_max) first_inv = r_used;
  if (first_inv >= 0) keep_better(sink_s, sink_r, kNeg, first_inv);
  sink_out[2 * b] = sink_s;
  sink_out[2 * b + 1] = sink_r;
}

// The traceback's cache in shared memory: the records and 32 direction bytes
// each of the ranks the walk will reach next, copied ahead of it.
constexpr int kTbSlots = 128;  // ranks cached, by rank modulo kTbSlots
constexpr int kTbSeg = 32;     // direction bytes cached per rank
constexpr int kTbWin = 32;     // ranks per round of copies
constexpr int kTbPeriod = 16;  // steps between two rounds

// Starts the copy of the records of ranks hi - 31 .. hi into their slots.
__device__ __forceinline__ void tb_copy_records(const int32_t* meta_b,
                                                int4* s_rec4, int hi) {
  constexpr int kParts = kRec / 4;  // int4s per record
  const int4* src = reinterpret_cast<const int4*>(meta_b);
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    const int j = static_cast<int>(threadIdx.x) + 32 * q;
    const int rho = hi - (kTbWin - 1) + j / kParts;
    if (rho >= 0) {
      __pipeline_memcpy_async(
          s_rec4 + (rho & (kTbSlots - 1)) * kParts + j % kParts,
          src + static_cast<size_t>(rho) * kParts + j % kParts, 16);
    }
  }
}

// Starts the copy of kTbSeg direction bytes of each of ranks hi - 31 .. hi
// (lane l: rank hi - l; their records are in shared memory) around the
// column the walk will reach them at if it goes on from (r, i) along the
// diagonal, from the 4-byte boundary below. Returns the first cached column
// of this lane's rank.
__device__ __forceinline__ int tb_copy_dirs(const uint8_t* Db, const int* s_rec,
                                            uint8_t* s_dir, int hi, int r, int i,
                                            int W, int S) {
  const int lane = threadIdx.x;
  const int rho = hi - lane;
  unsigned long long from = 0;  // 0: no such rank
  int first_col = 0;
  if (rho >= 0) {
    const int col = i - (r - rho) - s_rec[(rho & (kTbSlots - 1)) * kRec];
    const int start = min(max(col - kTbSeg / 2, 0), W - kTbSeg);
    const uint8_t* p = Db + static_cast<size_t>(rho) * S + start;
    const int below = static_cast<int>(reinterpret_cast<unsigned long long>(p) & 3);
    from = reinterpret_cast<unsigned long long>(p) - below;
    first_col = start - below;
  }
#pragma unroll
  for (int q = 0; q < kTbWin / 4; ++q) {  // four ranks, eight words each
    const int of_lane = 4 * q + (lane >> 3);
    const unsigned long long src = __shfl_sync(kFull, from, of_lane);
    if (src != 0) {
      __pipeline_memcpy_async(
          s_dir + ((hi - of_lane) & (kTbSlots - 1)) * kTbSeg + (lane & 7) * 4,
          reinterpret_cast<const uint8_t*>(src) + (lane & 7) * 4, 4);
    }
  }
  return first_col;
}

// The traceback of one POA block per warp, all lanes in lock step; lane l
// holds word l of the current rank's record. Every kTbPeriod steps the warp
// publishes the copies that have arrived and starts the next: records
// run ahead of the direction bytes, whose place depends on a record's
// window offset. A rank or a column that the cache does not hold (a walk
// that leaves the diagonal, a graph that is no chain) is read from device
// memory.
__global__ void __launch_bounds__(32)
poa_tb_kernel(const int32_t* __restrict__ seq_len,
              const int32_t* __restrict__ meta,
              const int32_t* __restrict__ sink_in,
              const uint8_t* __restrict__ dirs, int n_max, int n_pad, int W,
              int S, int P, int32_t* __restrict__ out_r,
              int32_t* __restrict__ out_i, int32_t* __restrict__ tcount,
              int32_t* __restrict__ best_sc) {
  __shared__ int4 s_rec4[kTbSlots * (kRec / 4)];
  __shared__ __align__(16) uint8_t s_dir[kTbSlots * kTbSeg];
  __shared__ int s_rtag[kTbSlots];  // the rank whose record a slot holds
  __shared__ int s_dtag[kTbSlots];  // the rank whose direction bytes it holds
  __shared__ int s_dcol[kTbSlots];  // the first column of those bytes
  const int* s_rec = reinterpret_cast<const int*>(s_rec4);
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t* meta_b = meta + static_cast<size_t>(b) * n_pad * kRec;
  const uint8_t* Db = dirs + static_cast<size_t>(b) * n_max * S;
  int32_t* orow = out_r + static_cast<size_t>(b) * P;
  int32_t* irow = out_i + static_cast<size_t>(b) * P;
  const int word_of = min(lane, kRec - 1);
  for (int k = lane; k < kTbSlots; k += 32) s_rtag[k] = s_dtag[k] = -1;
  __syncwarp();

  int i = seq_len[b];
  int r = sink_in[2 * b + 1];
  int word = meta_b[static_cast<size_t>(r) * kRec + word_of];
  int off_r = __shfl_sync(kFull, word, 0);
  bool at_src = false;
  int t = 0;

  // The next rank to copy a record for, the next to copy direction bytes
  // for, and the windows (their highest ranks) whose copies are on the way.
  int rec_next = r, dir_next = r;
  int rec_sent = -1, dir_sent = -1, dir_sent_col = 0;
  const bool cached = W >= kTbSeg;
  auto round = [&]() {
    __pipeline_wait_prior(0);
    if (rec_sent >= 0 && rec_sent - lane >= 0) {
      s_rtag[(rec_sent - lane) & (kTbSlots - 1)] = rec_sent - lane;
    }
    if (dir_sent >= 0 && dir_sent - lane >= 0) {
      s_dtag[(dir_sent - lane) & (kTbSlots - 1)] = dir_sent - lane;
      s_dcol[(dir_sent - lane) & (kTbSlots - 1)] = dir_sent_col;
    }
    __syncwarp();
    const int rec_have = rec_next;  // records of the ranks above are cached
    rec_sent = dir_sent = -1;
    // a slot may be refilled once the walk has passed its rank
    if (rec_next >= 0 && rec_next - (kTbWin - 1) > r - kTbSlots) {
      tb_copy_records(meta_b, s_rec4, rec_next);
      rec_sent = rec_next;
      rec_next -= kTbWin;
    }
    if (dir_next >= 0 && max(dir_next - (kTbWin - 1), 0) > rec_have) {
      dir_sent_col = tb_copy_dirs(Db, s_rec, s_dir, dir_next, r, i, W, S);
      dir_sent = dir_next;
      dir_next -= kTbWin;
    }
    __pipeline_commit();
  };
  if (cached) {
    for (int k = 0; k < kTbSlots / kTbWin; ++k) round();
  }

  while ((i > 0 || !at_src) && t < P) {
    if (cached && (t & (kTbPeriod - 1)) == kTbPeriod - 1) round();
    const int slot = r & (kTbSlots - 1);
    const int c = min(max(i - off_r, 0), W - 1);
    const int in_seg = c - s_dcol[slot];
    int d;
    if (s_dtag[slot] == r && in_seg >= 0 && in_seg < kTbSeg) {
      d = s_dir[slot * kTbSeg + in_seg];
    } else {
      d = Db[static_cast<size_t>(r) * S + c];
    }
    const bool ins_bit = (d & kDirIns) != 0;
    const bool match_bit = (d & kDirMatch) != 0;
    const bool is_match = !at_src && !ins_bit && match_bit;
    const bool is_del = !at_src && !ins_bit && !match_bit;
    const bool gap_seq = at_src || ins_bit;
    if (lane == 0) {
      orow[t] = gap_seq ? -1 : r;
      irow[t] = (gap_seq || is_match) ? i - 1 : -1;
    }
    if (gap_seq || is_match) --i;
    const int pslot = min(d & 0xF, kMaxPreds - 1);
    const int p = __shfl_sync(kFull, word, 2 + 2 * pslot);
    const int p_off = __shfl_sync(kFull, word, 3 + 2 * pslot);
    if (is_match || is_del) {
      if (p == n_max) {
        at_src = true;
      } else {
        r = p;
        off_r = p_off;
        const int to = r & (kTbSlots - 1);
        word = s_rtag[to] == r ? s_rec[to * kRec + word_of]
                               : meta_b[static_cast<size_t>(r) * kRec + word_of];
      }
    }
    ++t;
  }
  if (lane == 0) {
    tcount[b] = t;
    best_sc[b] = sink_in[2 * b];
  }
}

// `iters` dependent steps of one shared-memory round trip and one block
// barrier: the least one rank of the DP's serial chain can cost.
__global__ void __launch_bounds__(kMaxThreads)
poa_chain_probe_kernel(int iters, int32_t* out) {
  __shared__ int s[2][kMaxThreads];
  const int tid = threadIdx.x;
  const int next = tid + 1 == static_cast<int>(blockDim.x) ? 0 : tid + 1;
  int v = tid;
  for (int it = 0; it < iters; ++it) {
    s[it & 1][tid] = v;
    __syncthreads();
    v = s[it & 1][next] + 1;
  }
  out[blockIdx.x * blockDim.x + tid] = v;
}

template <int COLS, bool CHUNKED, bool WHOLE>
cudaError_t launch_dp(int B, int threads, size_t smem, cudaStream_t st,
                      const uint8_t* seq0p, const int32_t* seq_len,
                      const int32_t* meta, const int32_t* r_used, int n_max,
                      int n_pad, int W, int S, int P, int seq_stride, int depth,
                      int32_t* H, uint8_t* dirs, int32_t* out_r, int32_t* out_i,
                      int32_t* sink) {
  const cudaError_t err = cudaFuncSetAttribute(
      poa_dp_kernel<COLS, CHUNKED, WHOLE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  poa_dp_kernel<COLS, CHUNKED, WHOLE><<<B, threads, smem, st>>>(
      seq0p, seq_len, meta, r_used, n_max, n_pad, W, S, P, seq_stride, depth, H,
      dirs, out_r, out_i, sink);
  return cudaGetLastError();
}

using LaunchDp = decltype(&launch_dp<1, false, true>);

template <bool CHUNKED, bool WHOLE>
LaunchDp pick_launch(int cols) {
  switch (cols) {
    case 1: return &launch_dp<1, CHUNKED, WHOLE>;
    case 2: return &launch_dp<2, CHUNKED, WHOLE>;
    case 4: return &launch_dp<4, CHUNKED, WHOLE>;
    default: return &launch_dp<8, CHUNKED, WHOLE>;
  }
}

}  // namespace

// One thread block per POA block. Inputs and outputs as in
// sibeliaz_tpu_torch/align/kernels.py. Scratch: H [B, n_max+1, S] int32,
// dirs [B, n_max, S] uint8 (S >= W, a multiple of 8: every thread's columns
// are one aligned vector store), meta [B, n_pad, 20] int32 (n_pad >= n_max,
// a multiple of 32), aux [3 B] int32. cols (1, 2, 4 or 8 columns per thread),
// threads (a multiple of 32) and depth (ring rows) are the launch shape;
// windows wider than cols * threads run in chunks, without a ring. split_ms,
// if given, receives the milliseconds of the pre-pass, the DP and the
// traceback (and the call then waits for the stream). Returns a CUDA error
// code, 0 on success.
extern "C" int sz_poa_dp_tb(const void* seq0p, const void* seq_len,
                            const void* node_char, const void* pred_idx,
                            const void* pred_ok, const void* sink_mask,
                            const void* off, int B, int n_max, int W, int P,
                            int seq_stride, void* H, void* dirs, int S,
                            void* out_r, void* out_i, void* tcount,
                            void* best_sc, void* meta, int n_pad, void* aux,
                            int cols, int threads, int depth, float* split_ms,
                            void* stream) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      n_pad < n_max || n_pad % kTile != 0 || depth < 0 || S < W ||
      S % 8 != 0 ||
      (cols != 1 && cols != 2 && cols != 4 && cols != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_words = cols * threads;
  const int G = (W + row_words - 1) / row_words;
  const size_t smem =
      (kStageWords + 32 + static_cast<size_t>(depth) * row_words) * sizeof(int);
  if ((G > 1 && depth > 0) || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* r_used = static_cast<int32_t*>(aux);
  int32_t* sink = r_used + B;
  cudaEvent_t ev[4];
  if (split_ms) {
    for (auto& e : ev) cudaEventCreate(&e);
    cudaEventRecord(ev[0], st);
  }
  cudaError_t err = cudaMemsetAsync(r_used, 0, B * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  poa_meta_kernel<<<dim3((n_max + 255) / 256, B), 256, 0, st>>>(
      static_cast<const uint8_t*>(node_char),
      static_cast<const int32_t*>(pred_idx),
      static_cast<const uint8_t*>(pred_ok),
      static_cast<const uint8_t*>(sink_mask), static_cast<const int32_t*>(off),
      n_max, n_pad, static_cast<int32_t*>(meta), r_used);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_ms) cudaEventRecord(ev[1], st);
  const LaunchDp launch = G > 1          ? pick_launch<true, false>(cols)
                          : W % cols == 0 ? pick_launch<false, true>(cols)
                                          : pick_launch<false, false>(cols);
  err = launch(B, threads, smem, st, static_cast<const uint8_t*>(seq0p),
               static_cast<const int32_t*>(seq_len),
               static_cast<const int32_t*>(meta), r_used, n_max, n_pad, W, S, P,
               seq_stride, depth, static_cast<int32_t*>(H),
               static_cast<uint8_t*>(dirs), static_cast<int32_t*>(out_r),
               static_cast<int32_t*>(out_i), sink);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split_ms) cudaEventRecord(ev[2], st);
  poa_tb_kernel<<<B, 32, 0, st>>>(
      static_cast<const int32_t*>(seq_len), static_cast<const int32_t*>(meta),
      sink, static_cast<const uint8_t*>(dirs), n_max, n_pad, W, S, P,
      static_cast<int32_t*>(out_r), static_cast<int32_t*>(out_i),
      static_cast<int32_t*>(tcount), static_cast<int32_t*>(best_sc));
  err = cudaGetLastError();
  if (split_ms) {
    cudaEventRecord(ev[3], st);
    cudaEventSynchronize(ev[3]);
    for (int k = 0; k < 3; ++k) {
      cudaEventElapsedTime(&split_ms[k], ev[k], ev[k + 1]);
    }
    for (auto& e : ev) cudaEventDestroy(e);
  }
  return static_cast<int>(err);
}

// Runs `iters` steps of the chain probe in one block of `threads` threads;
// out holds `threads` ints. Returns a CUDA error code.
extern "C" int sz_poa_chain_probe(int threads, int iters, void* out,
                                  void* stream) {
  if (threads < 32 || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  poa_chain_probe_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
