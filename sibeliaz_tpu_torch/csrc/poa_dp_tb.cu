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
// What bounds it: latency, not bytes. Rank r reads any earlier rank's H
// row, so the rank loop is serial: each rank costs its predecessor gathers
// (mostly L2 hits: the row just written), one block-wide max-scan and its
// barriers. A 25 kbp copy is ~25-60 k ranks in a row. The design does not
// make one block faster; it keeps many in flight: one thread block per POA
// block (the batch axis), the rank loop inside the block, threads striding
// over the window in contiguous chunks so that the scan is a serial pass
// per thread plus one warp-shuffle and shared-memory pass across threads.
// H and the direction bytes live in device memory (the wrapper's scratch).
// The traceback is one thread's serial walk. All arithmetic is int32.
// Ranks past the last one with any predecessor are padding and are
// skipped; predecessors must have lower ranks (a topological order).

#include <climits>
#include <cstdint>

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

__device__ __forceinline__ int warp_incl_max(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

// Exclusive max-scan of one value per thread in thread order (INT_MIN for
// thread 0). blockDim.x is a multiple of 32; s_warp holds 32 ints.
__device__ __forceinline__ int block_excl_max(int v, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_incl_max(v);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < static_cast<int>(blockDim.x >> 5) ? s_warp[lane] : INT_MIN;
    w = warp_incl_max(w);
    s_warp[lane] = w;
  }
  __syncthreads();
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = INT_MIN;
  if (warp > 0) excl = max(excl, s_warp[warp - 1]);
  return excl;
}

// Best ext value over the predecessor slots at window column e (row
// off_r + e - 1), first arg-max slot on ties.
__device__ __forceinline__ int ext_best(int e, int off_r, const int* pid,
                                        const bool* pok, const int* poff,
                                        const int32_t* Hb, int n_max, int W,
                                        int& slot) {
  const int j = off_r + e - 1;
  int best = kNeg;
  slot = 0;
#pragma unroll
  for (int p = 0; p < kMaxPreds; ++p) {
    int v = kNeg;
    if (pok[p] && j >= 0) {
      const int idx = j - poff[p];
      if (idx >= 0 && idx < W) {
        v = pid[p] == n_max ? kGap * j
                            : Hb[static_cast<size_t>(pid[p]) * W + idx];
      }
    }
    if (p == 0 || v > best) {
      best = v;
      slot = p;
    }
  }
  return best;
}

__device__ __forceinline__ void keep_better(int& s, int& r, int s2, int r2) {
  if (s2 > s || (s2 == s && r2 < r)) {
    s = s2;
    r = r2;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
poa_dp_tb_kernel(const uint8_t* __restrict__ seq0p,
                 const int32_t* __restrict__ seq_len,
                 const uint8_t* __restrict__ node_char,
                 const int32_t* __restrict__ pred_idx,
                 const uint8_t* __restrict__ pred_ok,
                 const uint8_t* __restrict__ sink_mask,
                 const int32_t* __restrict__ off, int n_max, int W, int P,
                 int seq_stride, int cols, int32_t* H, uint8_t* dirs,
                 int32_t* __restrict__ out_r, int32_t* __restrict__ out_i,
                 int32_t* __restrict__ tcount,
                 int32_t* __restrict__ best_sc) {
  __shared__ int s_warp[32];
  __shared__ int s_rank[32];
  __shared__ int s_used;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t nm = static_cast<size_t>(n_max);
  const uint8_t* seq = seq0p + static_cast<size_t>(b) * seq_stride;
  const uint8_t* chars = node_char + b * nm;
  const int32_t* pidx_b = pred_idx + b * nm * kMaxPreds;
  const uint8_t* pok_b = pred_ok + b * nm * kMaxPreds;
  const uint8_t* sink = sink_mask + b * nm;
  const int32_t* off_b = off + b * (nm + 1);
  int32_t* Hb = H + b * (nm + 1) * W;
  uint8_t* Db = dirs + b * nm * W;

  // ranks in use: 1 + the last rank with any predecessor (at least 1)
  if (tid == 0) s_used = 0;
  __syncthreads();
  int last = 0;
  for (int r = tid; r < n_max; r += blockDim.x) {
    bool any = false;
#pragma unroll
    for (int p = 0; p < kMaxPreds; ++p) {
      any |= pok_b[static_cast<size_t>(r) * kMaxPreds + p] != 0;
    }
    if (any) last = r + 1;
  }
  atomicMax(&s_used, last);
  __syncthreads();
  const int r_used = max(1, s_used);

  const int w0 = tid * cols;
  const int w1 = min(W, w0 + cols);
  for (int r = 0; r < r_used; ++r) {
    const int off_r = off_b[r];
    const int ch = chars[r];
    int pid[kMaxPreds];
    int poff[kMaxPreds];
    bool pok[kMaxPreds];
#pragma unroll
    for (int p = 0; p < kMaxPreds; ++p) {
      const size_t k = static_cast<size_t>(r) * kMaxPreds + p;
      pok[p] = pok_b[k] != 0;
      pid[p] = pidx_b[k];
      poff[p] = pok[p] ? off_b[pid[p]] : 0;
    }
    int32_t* Hr = Hb + static_cast<size_t>(r) * W;
    uint8_t* Dr = Db + static_cast<size_t>(r) * W;

    // pass 1: match / deletion per column, stored as H = base; the
    // thread's running max of base + 8w feeds the block scan
    int agg = INT_MIN;
    if (w0 < w1) {
      int slot_e;
      int best_e = ext_best(w0, off_r, pid, pok, poff, Hb, n_max, W, slot_e);
      for (int w = w0; w < w1; ++w) {
        int slot_n;
        const int best_n =
            ext_best(w + 1, off_r, pid, pok, poff, Hb, n_max, W, slot_n);
        const int sub = seq[off_r + w] == ch ? kMatch : kMismatch;
        const int diag = best_e + sub;
        const int horiz = best_n + kGap;
        const bool is_match = diag >= horiz;
        const int base = is_match ? diag : horiz;
        Hr[w] = base;
        Dr[w] = static_cast<uint8_t>(is_match ? (slot_e | kDirMatch) : slot_n);
        agg = max(agg, base + 8 * w);
        best_e = best_n;
        slot_e = slot_n;
      }
    }
    // pass 2: the damped running maximum; insertions where it beats base
    int run = block_excl_max(agg, s_warp);
    for (int w = w0; w < w1; ++w) {
      const int base = Hr[w];
      run = max(run, base + 8 * w);
      const int col = run - 8 * w;
      if (col > base) {
        Hr[w] = col;
        Dr[w] = static_cast<uint8_t>(kDirIns);
      }
    }
    __syncthreads();  // row r is complete before any later rank reads it
  }

  // the traceback registers start as -1 (None)
  int32_t* orow = out_r + static_cast<size_t>(b) * P;
  int32_t* irow = out_i + static_cast<size_t>(b) * P;
  for (int t = tid; t < P; t += blockDim.x) {
    orow[t] = -1;
    irow[t] = -1;
  }

  // sink choice at row seq_len: max score, ties to the smallest rank
  const int n = seq_len[b];
  int bs = INT_MIN;
  int br = INT_MAX;
  for (int r = tid; r < n_max; r += blockDim.x) {
    const int sidx = n - off_b[r];
    const int s = (r < r_used && sink[r] && sidx >= 0 && sidx < W)
                      ? Hb[static_cast<size_t>(r) * W + sidx]
                      : kNeg;
    keep_better(bs, br, s, r);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int os = __shfl_down_sync(kFull, bs, d);
    const int orank = __shfl_down_sync(kFull, br, d);
    keep_better(bs, br, os, orank);
  }
  if ((tid & 31) == 0) {
    s_warp[tid >> 5] = bs;
    s_rank[tid >> 5] = br;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int k = 1; k < static_cast<int>(blockDim.x >> 5); ++k) {
    keep_better(bs, br, s_warp[k], s_rank[k]);
  }

  // traceback: one thread walks from (best rank, seq_len) to the source
  int i = n;
  int r = br;
  bool at_src = false;
  int t = 0;
  while ((i > 0 || !at_src) && t < P) {
    const int c = min(max(i - off_b[r], 0), W - 1);
    const int d = Db[static_cast<size_t>(r) * W + c];
    const bool ins_bit = (d & kDirIns) != 0;
    const bool match_bit = (d & kDirMatch) != 0;
    const bool is_ins = !at_src && ins_bit;
    const bool is_match = !at_src && !ins_bit && match_bit;
    const bool is_del = !at_src && !ins_bit && !match_bit;
    const bool gap_seq = at_src || is_ins;
    orow[t] = gap_seq ? -1 : r;
    irow[t] = (gap_seq || is_match) ? i - 1 : -1;
    if (gap_seq || is_match) --i;
    const int p = pidx_b[static_cast<size_t>(r) * kMaxPreds + min(d & 0xF, 7)];
    if (is_match || is_del) {
      if (p == n_max) {
        at_src = true;
      } else {
        r = p;
      }
    }
    ++t;
  }
  tcount[b] = t;
  best_sc[b] = bs;
}

}  // namespace

// One thread block per POA block. Inputs and outputs as in
// sibeliaz_tpu_torch/align/kernels.py; H [B, n_max+1, W] int32 and dirs
// [B, n_max, W] uint8 are scratch. Returns cudaGetLastError().
extern "C" int sz_poa_dp_tb(const void* seq0p, const void* seq_len,
                            const void* node_char, const void* pred_idx,
                            const void* pred_ok, const void* sink_mask,
                            const void* off, int B, int n_max, int W, int P,
                            int seq_stride, void* H, void* dirs, void* out_r,
                            void* out_i, void* tcount, void* best_sc,
                            void* stream) {
  if (B <= 0) return 0;
  const int cols = (W + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((W + cols - 1) / cols + 31) / 32 * 32;
  poa_dp_tb_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq0p), static_cast<const int32_t*>(seq_len),
      static_cast<const uint8_t*>(node_char),
      static_cast<const int32_t*>(pred_idx),
      static_cast<const uint8_t*>(pred_ok),
      static_cast<const uint8_t*>(sink_mask), static_cast<const int32_t*>(off),
      n_max, W, P, seq_stride, cols, static_cast<int32_t*>(H),
      static_cast<uint8_t*>(dirs), static_cast<int32_t*>(out_r),
      static_cast<int32_t*>(out_i), static_cast<int32_t*>(tcount),
      static_cast<int32_t*>(best_sc));
  return static_cast<int>(cudaGetLastError());
}
