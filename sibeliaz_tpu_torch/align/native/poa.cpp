// The port's copy of sibeliaz_tpu/align/native/poa.cpp, byte-equal below this
// header; the CPU tests hold it to the original.
// Native partial-order alignment engine.
//
// Production twin of sibeliaz_tpu/align/poa_ref.py (the executable spec;
// differential-tested against it).  Replaces the reference pipeline's
// process-farm of spoa invocations (SibeliaZ-LCB/sibeliaz:65-98) with an
// in-process, OpenMP-batched engine: one POA graph per LCB, DP with rolling
// score rows + a uint8 direction matrix for traceback, linear -8 gaps
// (spoa's affine model with open==extend==-8), match +5 / mismatch -4.
//
// Overflow policy: a per-block memory budget bounds the DP direction
// matrix; blocks that exceed it are reported to the caller (width -1)
// instead of silently vanishing from the MAF the way the reference's
// spoa-OOM path does (sibeliaz:69-73).
//
// C ABI batch interface: all block copies arrive as one concatenated byte
// buffer with offsets; MSA rows return the same way.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace szpoa {

using i64 = int64_t;
using u8 = uint8_t;

static const i64 MATCH = 5;
static const i64 MISMATCH = -4;
static const i64 GAP = -8;
static const i64 NEG = -(i64(1) << 50);

// direction encoding: 0 = insertion; 1 = match from source; 2 = deletion
// from source; even 2k+4 = deletion via pred k; odd 2k+3 = match via pred k
static const u8 DIR_INS = 0, DIR_MATCH_SRC = 1, DIR_DEL_SRC = 2;
static inline u8 dir_match(int k) { return u8(2 * k + 3); }
static inline u8 dir_del(int k) { return u8(2 * k + 4); }

struct Graph {
  std::vector<u8> ch;
  std::vector<std::vector<int>> preds, succs;
  std::vector<int> group_of;
  std::vector<std::vector<int>> groups;
  std::vector<std::vector<int>> paths;
  bool overflow = false;
  i64 budget;

  explicit Graph(i64 budget_bytes) : budget(budget_bytes) {}

  int new_node(u8 c, int group) {
    int nid = int(ch.size());
    ch.push_back(c);
    preds.emplace_back();
    succs.emplace_back();
    if (group < 0) {
      group = int(groups.size());
      groups.emplace_back();
    }
    group_of.push_back(group);
    groups[group].push_back(nid);
    return nid;
  }

  void add_edge(int u, int v) {
    for (int p : preds[v])
      if (p == u) return;
    preds[v].push_back(u);
    succs[u].push_back(v);
    // the uint8 direction encoding caps pred fan-in; treat beyond as overflow
    if (preds[v].size() > 120) overflow = true;
  }

  // group ids in topological order; ties resolved smallest-id-first
  std::vector<int> topo_groups() const {
    int ng = int(groups.size());
    std::vector<int> remaining(ng, 0);
    for (int g = 0; g < ng; g++)
      for (int nid : groups[g]) remaining[g] += int(preds[nid].size());
    std::priority_queue<int, std::vector<int>, std::greater<int>> ready;
    for (int g = 0; g < ng; g++)
      if (remaining[g] == 0) ready.push(g);
    std::vector<int> order;
    order.reserve(ng);
    while (!ready.empty()) {
      int g = ready.top();
      ready.pop();
      order.push_back(g);
      for (int nid : groups[g])
        for (int v : succs[nid]) {
          int gv = group_of[v];
          if (--remaining[gv] == 0) ready.push(gv);
        }
    }
    return order;
  }

  void add_first(const u8* s, i64 n) {
    int prev = -1;
    std::vector<int> path;
    path.reserve(n);
    for (i64 i = 0; i < n; i++) {
      int nid = new_node(s[i], -1);
      if (prev >= 0) add_edge(prev, nid);
      path.push_back(nid);
      prev = nid;
    }
    paths.push_back(std::move(path));
  }

  void add_sequence(const u8* s, i64 n) {
    if (overflow) return;
    if (ch.empty()) {
      add_first(s, n);
      return;
    }
    // ---- topo node order ----
    std::vector<int> gorder = topo_groups();
    if (gorder.size() != groups.size()) {
      // cycle: the spec raises here (poa_ref.topo_groups); a silent
      // partial order would corrupt the DP, so surface as overflow (the
      // block lands in blocks/ instead of producing a wrong MSA)
      overflow = true;
      return;
    }
    std::vector<int> topo;
    topo.reserve(ch.size());
    for (int g : gorder)
      for (int nid : groups[g]) topo.push_back(nid);
    int N = int(topo.size());
    std::vector<int> rank(ch.size());
    for (int r = 0; r < N; r++) rank[topo[r]] = r;

    // ---- DP: rolling rows + direction matrix ----
    // Flatten predecessor lists into rank-space CSR once (the per-cell
    // vector-of-vectors walk was the hot path), and use int32 scores (they
    // are bounded by ~13*(n+N), far below 2^31 under the DP budget).
    using Score = int32_t;
    const Score NEGS = Score(-(i64(1) << 29));
    std::vector<int> pred_off(N + 1, 0), pred_rank;
    std::vector<u8> node_ch(N);
    pred_rank.reserve(ch.size() * 2);
    for (int r = 0; r < N; r++) {
      int nid = topo[r];
      node_ch[r] = ch[nid];
      for (int p : preds[nid]) pred_rank.push_back(rank[p]);
      pred_off[r + 1] = int(pred_rank.size());
    }
    // chain[r]: exactly one predecessor and it is rank r-1 — the common
    // case (linear backbone), which gets a branch-light fast path.
    std::vector<u8> chain(N, 0);
    for (int r = 0; r < N; r++)
      if (pred_off[r + 1] - pred_off[r] == 1 && pred_rank[pred_off[r]] == r - 1)
        chain[r] = 1;

    auto src = [&](i64 i) { return Score(GAP * i); };
    // Maximal chain runs [a, b): within a run every node's single pred is
    // its left neighbor, so the row recurrence is
    //   H[r] = max(diag[r], ins[r], H[r-1] + GAP)
    // and splits into (1) a vectorizable elementwise pass for
    // w = max(diag, ins), (2) a branch-free scalar prefix for the deletion
    // chain, (3) a vectorizable direction-resolve pass against the final
    // shifted H (skipped entirely for score-only rows in checkpoint mode).
    // This is the same damped-prefix-max restructure the device engine uses
    // (align/tpu_poa.py) and what makes spoa's SIMD layout fast.
    std::vector<int> run_start, run_end;  // maximal chain runs
    {
      int r = 0;
      while (r < N) {
        if (chain[r]) {
          int a = r;
          while (r < N && chain[r]) r++;
          run_start.push_back(a);
          run_end.push_back(r);
        } else {
          r++;
        }
      }
    }

    // ---- exact banding ----
    // bound(i, r) is a static upper bound on the total score of ANY
    // complete alignment whose DP path passes through cell (i, r): i prefix
    // chars against some source→r path depth d ∈ [mind, maxd], plus n−i
    // suffix chars against some r→sink remainder e ∈ [mins, maxs], each
    // side bounded by 5·min(chars, depth) − 8·|chars − depth|.  Given an
    // achieved alignment score S, restricting the DP to cells with
    // bound ≥ S reproduces the FULL DP's traceback byte-for-byte: every
    // cell on any co-optimal path — and every cell of such a cell's own
    // optimal prefix — has bound ≥ S_opt ≥ S, so all of them are computed
    // with their exact values; every tie the full DP resolves is seen here
    // with equal operands (same priority rules); and excluded or
    // underestimated cells can never win a comparison because banded
    // values never exceed true ones.  Two passes: pass 1 bands at a guess
    // S0 = sinkUB − slack; if its result S ≥ S0 it is already certified
    // (allowed(S_opt) ⊆ allowed(S0)); otherwise pass 2 re-runs over
    // allowed(S), certified unconditionally since S ≤ S_opt.
    i64 band_min = 256;
    if (const char* e = std::getenv("SZ_POA_BAND_MIN"))
      band_min = std::atoll(e);
    bool banding = n >= band_min && i64(N) >= band_min;
    // The certificate treats NEGS as a floor: a guarded out-of-band read
    // must never exceed the cell's true value.  True values are bounded
    // below by -8*(n+N), so disable banding in the degenerate regime where
    // that could reach NEGS (= -2^29; require < 2^28 for margin).
    if (8 * (n + i64(N)) >= (i64(1) << 28)) banding = false;
    if (const char* e = std::getenv("SZ_POA_BAND"))
      if (std::atoi(e) == 0) banding = false;

    std::vector<i64> mind, maxd, mins, maxs;
    if (banding) {
      mind.resize(N);
      maxd.resize(N);
      mins.assign(N, i64(1) << 50);
      maxs.assign(N, -1);
      for (int r = 0; r < N; r++) {
        int np = pred_off[r + 1] - pred_off[r];
        if (np == 0) {
          mind[r] = maxd[r] = 1;
          continue;
        }
        i64 mn = i64(1) << 50, mx = 0;
        for (int k = 0; k < np; k++) {
          int pr = pred_rank[pred_off[r] + k];
          mn = std::min(mn, mind[pr]);
          mx = std::max(mx, maxd[pr]);
        }
        mind[r] = mn + 1;
        maxd[r] = mx + 1;
      }
      for (int r = N - 1; r >= 0; r--) {
        if (maxs[r] < 0) {  // no successor recorded: sink
          mins[r] = 0;
          maxs[r] = 0;
        }
        for (int k = pred_off[r]; k < pred_off[r + 1]; k++) {
          int pr = pred_rank[k];
          mins[pr] = std::min(mins[pr], mins[r] + 1);
          maxs[pr] = std::max(maxs[pr], maxs[r] + 1);
        }
      }
    }
    auto side_bound = [](i64 chars, i64 dmin, i64 dmax) -> i64 {
      if (chars < dmin) return 5 * chars - 8 * (dmin - chars);
      if (chars > dmax) return 5 * dmax - 8 * (chars - dmax);
      return 5 * chars;
    };
    auto bound_at = [&](i64 i, int r) -> i64 {
      return side_bound(i, mind[r], maxd[r]) +
             side_bound(n - i, mins[r], maxs[r]);
    };

    std::vector<int> lo_m(n + 1, 0), hi_m(n + 1, N);
    std::vector<i64> doff(n + 2, 0);  // band-packed dir row offsets
    auto build_doff = [&]() {
      for (i64 i = 0; i <= n; i++)
        doff[i + 1] = doff[i] + (hi_m[i] - lo_m[i]);
    };
    // Monotone per-row hull of {(i, r) : bound(i, r) ≥ S}:
    //   lo_m[i] = min{r allowed at some row ≥ i}   (nondecreasing in i)
    //   hi_m[i] = max{r allowed at some row ≤ i}+1 (nondecreasing in i)
    // Both are supersets of the exact allowed rows; monotonicity is what
    // keeps stale cells strictly LEFT of the band (guarded reads) and
    // right-of-band cells untouched NEGS until the band reaches them.
    auto make_hull = [&](i64 S) -> bool {
      std::vector<int> bmin(n + 1, N), bmax(n + 1, -1);
      for (int r = 0; r < N; r++) {
        // the bound is concave piecewise-linear in i: its max is at a
        // breakpoint; the allowed-i set is one interval found by bisection
        i64 cand[6] = {0, n, mind[r], maxd[r], n - maxs[r], n - mins[r]};
        i64 ibest = 0, vbest = -(i64(1) << 60);
        for (i64 c : cand) {
          c = std::min(std::max<i64>(c, 0), n);
          i64 v = bound_at(c, r);
          if (v > vbest) {
            vbest = v;
            ibest = c;
          }
        }
        if (vbest < S) continue;  // node never allowed
        i64 a = 0, b = ibest;
        while (a < b) {
          i64 m = (a + b) / 2;
          if (bound_at(m, r) >= S)
            b = m;
          else
            a = m + 1;
        }
        i64 ia = a;
        a = ibest;
        b = n;
        while (a < b) {
          i64 m = (a + b + 1) / 2;
          if (bound_at(m, r) >= S)
            a = m;
          else
            b = m - 1;
        }
        i64 ib = a;
        bmin[ib] = std::min(bmin[ib], r);
        bmax[ia] = std::max(bmax[ia], r);
      }
      int run = N;
      for (i64 i = n; i >= 0; i--) {
        run = std::min(run, bmin[i]);
        lo_m[i] = run;
      }
      run = -1;
      for (i64 i = 0; i <= n; i++) {
        run = std::max(run, bmax[i]);
        hi_m[i] = run + 1;
      }
      for (i64 i = 0; i <= n; i++)
        if (lo_m[i] >= hi_m[i]) return false;  // empty row: S unreachable
      return true;
    };

    i64 S0 = -(i64(1) << 60);
    if (banding) {
      i64 sink_ub = -(i64(1) << 60);  // tight UB: paths must end at a sink
      for (int r = 0; r < N; r++)
        if (succs[topo[r]].empty())
          sink_ub = std::max(sink_ub, bound_at(n, r));
      bool have_band = false;
      i64 slack = 13 * (64 + n / 32);
      for (int e = 0; e < 3 && !have_band; e++, slack *= 4) {
        S0 = sink_ub - slack;
        have_band = make_hull(S0);
      }
      if (have_band) {
        build_doff();
        // band nearly full-width: the two-pass overhead isn't worth it
        if (doff[n + 1] * 4 >= 3 * (n + 1) * i64(N)) have_band = false;
      }
      if (!have_band) banding = false;
    }
    if (!banding) {
      std::fill(lo_m.begin(), lo_m.end(), 0);
      std::fill(hi_m.begin(), hi_m.end(), N);
      build_doff();
      S0 = -(i64(1) << 60);
    }

    auto fill_row0 = [&](Score* H, u8* drow) {
      int lo = lo_m[0], hi = hi_m[0];
      for (int r = lo; r < hi; r++) {
        int np = pred_off[r + 1] - pred_off[r];
        if (np == 0) {
          H[r] = src(0) + GAP;
          if (drow) drow[r] = DIR_DEL_SRC;
        } else {
          Score best = NEGS;
          int bk = 0;
          for (int k = 0; k < np; k++) {
            int pr = pred_rank[pred_off[r] + k];
            Score v = pr >= lo ? H[pr] : NEGS;
            if (v > best) {
              best = v;
              bk = k;
            }
          }
          H[r] = best + GAP;
          if (drow) drow[r] = dir_del(bk);
        }
      }
    };
    auto fill_chain_run = [&](int a, int b, u8 c, const Score* Hp, Score* Hc,
                              u8* drow) {
      // Fused w = max(diag, ins) + deletion-chain prefix
      // H[r] = max(w[r], H[r-1] + GAP), vectorized as a blocked log-shift
      // scan (8 int32 lanes): compute the block's w in registers,
      // max-combine progressively shifted copies with damped offsets, then
      // fold in the carry from the previous block.
      Score h = Hc[a - 1];
      {
        typedef int32_t v8 __attribute__((vector_size(32)));
        const v8 g1 = {GAP, GAP, GAP, GAP, GAP, GAP, GAP, GAP};
        const v8 g2 = g1 + g1;
        const v8 g4 = g2 + g2;
        const v8 damp = {1 * GAP, 2 * GAP, 3 * GAP, 4 * GAP,
                         5 * GAP, 6 * GAP, 7 * GAP, 8 * GAP};
        const v8 vmatch = {MATCH, MATCH, MATCH, MATCH,
                           MATCH, MATCH, MATCH, MATCH};
        const v8 vmis = {MISMATCH, MISMATCH, MISMATCH, MISMATCH,
                         MISMATCH, MISMATCH, MISMATCH, MISMATCH};
        const Score NB = NEGS;
        int r = a;
        for (; r + 8 <= b; r += 8) {
          v8 hp_prev, hp;
          __builtin_memcpy(&hp_prev, Hp + r - 1, sizeof(hp_prev));
          __builtin_memcpy(&hp, Hp + r, sizeof(hp));
          v8 eq;
          for (int l = 0; l < 8; l++) eq[l] = node_ch[r + l] == c ? -1 : 0;
          v8 diag = hp_prev + (eq ? vmatch : vmis);
          v8 ins = hp + g1;
          v8 v = diag > ins ? diag : ins;
          v8 s1 = {NB, v[0], v[1], v[2], v[3], v[4], v[5], v[6]};
          v = v > s1 + g1 ? v : s1 + g1;
          v8 s2 = {NB, NB, v[0], v[1], v[2], v[3], v[4], v[5]};
          v = v > s2 + g2 ? v : s2 + g2;
          v8 s4 = {NB, NB, NB, NB, v[0], v[1], v[2], v[3]};
          v = v > s4 + g4 ? v : s4 + g4;
          v8 carry = {h, h, h, h, h, h, h, h};
          carry += damp;
          v = v > carry ? v : carry;
          __builtin_memcpy(Hc + r, &v, sizeof(v));
          h = v[7];
        }
        for (; r < b; r++) {  // tail
          Score sc = node_ch[r] == c ? Score(MATCH) : Score(MISMATCH);
          Score diag = Hp[r - 1] + sc;
          Score ins = Hp[r] + GAP;
          Score wr = diag >= ins ? diag : ins;
          Score d = h + Score(GAP);
          h = wr >= d ? wr : d;
          Hc[r] = h;
        }
      }
      if (drow) {
        for (int r = a; r < b; r++) {  // vectorizable
          Score sc = node_ch[r] == c ? Score(MATCH) : Score(MISMATCH);
          Score diag = Hp[r - 1] + sc;
          Score ins = Hp[r] + GAP;
          Score dele = Hc[r - 1] + Score(GAP);
          drow[r] = (diag >= dele && diag >= ins)
                        ? dir_match(0)
                        : (dele >= ins ? dir_del(0) : DIR_INS);
        }
      }
    };

    auto fill_cell_general = [&](int r, i64 i, u8 c, const Score* Hp,
                                 Score* Hc, u8* drow, int plo, int lo) {
      Score sc = node_ch[r] == c ? Score(MATCH) : Score(MISMATCH);
      Score diag, dele;
      u8 dm, dd;
      {
          int np = pred_off[r + 1] - pred_off[r];
          if (np == 0) {
            diag = src(i - 1) + sc;
            dele = src(i) + GAP;
            dm = DIR_MATCH_SRC;
            dd = DIR_DEL_SRC;
          } else {
            Score bd = NEGS, be = NEGS;
            int kd = 0, ke = 0;
            for (int k = 0; k < np; k++) {
              int pr = pred_rank[pred_off[r] + k];
              // band guards: cells left of the (monotone) band hold stale
              // values from older rows; right-of-band cells are clean NEGS
              Score vH = pr >= plo ? Hp[pr] : NEGS;
              Score vC = pr >= lo ? Hc[pr] : NEGS;
              if (vH > bd) {
                bd = vH;
                kd = k;
              }
              if (vC > be) {
                be = vC;
                ke = k;
              }
            }
            diag = bd + sc;
            dele = be + GAP;
            dm = dir_match(kd);
            dd = dir_del(ke);
          }
        }
      Score ins = Hp[r] + GAP;
      // tie priority: match > deletion > insertion
      Score h;
      u8 d;
      if (diag >= dele && diag >= ins) {
        h = diag;
        d = dm;
      } else if (dele >= ins) {
        h = dele;
        d = dd;
      } else {
        h = ins;
        d = DIR_INS;
      }
      Hc[r] = h;
      if (drow) drow[r] = d;
    };

    auto fill_row = [&](i64 i, const Score* Hp, Score* Hc, u8* drow) {
      u8 c = s[i - 1];
      int lo = lo_m[i], hi = hi_m[i], plo = lo_m[i - 1];
      if (lo > 0) Hc[lo - 1] = NEGS;  // deletion-chain entry sentinel
      size_t ri = std::upper_bound(run_end.begin(), run_end.end(), lo) -
                  run_end.begin();
      int r = lo;
      while (r < hi) {
        if (ri < run_start.size() && run_start[ri] <= r) {
          int b = std::min(run_end[ri], hi);
          fill_chain_run(r, b, c, Hp, Hc, drow);
          r = b;
          if (r >= run_end[ri]) ri++;
        } else {
          int stop = hi;
          if (ri < run_start.size()) stop = std::min(stop, run_start[ri]);
          for (; r < stop; r++)
            fill_cell_general(r, i, c, Hp, Hc, drow, plo, lo);
        }
      }
    };

    // Memory plan (per pass): full band-packed direction matrix when it
    // fits; otherwise checkpointed traceback (save every C-th score row,
    // refill direction rows per segment during traceback — ~2x compute,
    // O(N*sqrt(n)) memory) so big blocks still get aligned instead of being
    // dropped the way the reference's spoa-OOM path drops them.
    std::vector<u8> dir;             // full_dir: band-packed rows 0..n
    std::vector<u8> dir0(N, 0);      // checkpoint mode: row 0, absolute
    std::vector<Score> checkpoints;  // rows 0, C, 2C, ... (checkpoint mode)
    std::vector<Score> Hprev(N, NEGS), Hcur(N, NEGS);
    bool full_dir = false;
    i64 C = 0, n_ckpt = 0;

    auto run_pass = [&](int& best_r, i64& best_sc) -> bool {
      // release both modes' buffers up front so an uncertified pass 1's
      // storage never coexists with pass 2's (peak stays within budget)
      std::vector<u8>().swap(dir);
      std::vector<Score>().swap(checkpoints);
      i64 wsum = doff[n + 1];
      full_dir = wsum <= budget;
      C = 0;
      if (!full_dir) {
        // C = 2*sqrt(n+1) minimizes N*C + 4*N*(n+1)/C, so a single
        // feasibility check suffices (growing C only costs more)
        C = std::max<i64>(64, i64(2 * std::sqrt(double(n + 1))));
        i64 maxw = 0;
        for (i64 i = 0; i <= n; i++)
          maxw = std::max(maxw, i64(hi_m[i] - lo_m[i]));
        if (maxw * C + 4 * i64(N) * ((n + 1) / C + 2) > budget)
          return false;  // graph alone exceeds the budget
      }
      std::fill(Hprev.begin(), Hprev.end(), NEGS);
      std::fill(Hcur.begin(), Hcur.end(), NEGS);
      if (full_dir) {
        dir.assign(wsum, 0);
        fill_row0(Hprev.data(), dir.data() + doff[0] - lo_m[0]);
        for (i64 i = 1; i <= n; i++) {
          fill_row(i, Hprev.data(), Hcur.data(),
                   dir.data() + doff[i] - lo_m[i]);
          std::swap(Hprev, Hcur);
        }
      } else {
        n_ckpt = n / C + 1;
        checkpoints.assign(n_ckpt * i64(N), NEGS);
        std::fill(dir0.begin(), dir0.end(), 0);
        fill_row0(Hprev.data(), dir0.data());
        std::copy(Hprev.begin(), Hprev.end(), checkpoints.begin());
        for (i64 i = 1; i <= n; i++) {
          fill_row(i, Hprev.data(), Hcur.data(), nullptr);
          std::swap(Hprev, Hcur);
          if (i % C == 0 && i / C < n_ckpt)
            std::copy(Hprev.begin(), Hprev.end(),
                      checkpoints.begin() + (i / C) * i64(N));
        }
      }
      // Hprev now holds row n.
      // ---- end node: sink with max score, smallest rank ----
      best_r = -1;
      best_sc = NEG;
      for (int r = lo_m[n]; r < hi_m[n]; r++)
        if (succs[topo[r]].empty() && Hprev[r] > best_sc) {
          best_sc = Hprev[r];
          best_r = r;
        }
      return true;
    };

    int best_r;
    i64 best_sc;
    if (!run_pass(best_r, best_sc)) {
      overflow = true;
      return;
    }
    if (banding && !(best_r >= 0 && best_sc >= S0)) {
      // pass 1 not certified: re-band at the achieved score (always
      // certified since best_sc <= S_opt), or run full if pass 1 found
      // no finite in-band score at all.
      if (!(best_r >= 0 && make_hull(best_sc))) {
        std::fill(lo_m.begin(), lo_m.end(), 0);
        std::fill(hi_m.begin(), hi_m.end(), N);
      }
      build_doff();
      if (!run_pass(best_r, best_sc)) {
        overflow = true;
        return;
      }
    }

    // ---- traceback from the (possibly segment-refilled) direction rows ---
    std::vector<u8> dirseg;
    i64 cur_seg = -1;
    std::vector<Score> Ha(N), Hb(N);
    auto get_dir = [&](i64 i, int r) -> u8 {
      if (full_dir) return dir[doff[i] + (r - lo_m[i])];
      if (i == 0) return dir0[r];
      i64 seg = (i - 1) / C;  // segment covers rows [seg*C+1, (seg+1)*C]
      if (seg != cur_seg) {
        cur_seg = seg;
        i64 lo = seg * C;  // checkpoint row
        i64 hi = std::min(lo + C, n);
        dirseg.assign(doff[hi + 1] - doff[lo + 1], 0);
        std::copy(checkpoints.begin() + seg * i64(N),
                  checkpoints.begin() + (seg + 1) * i64(N), Ha.begin());
        // segments are refilled in DESCENDING i order, so Hb may hold
        // values from later (wider-band) rows — clear before reuse
        std::fill(Hb.begin(), Hb.end(), NEGS);
        for (i64 j = lo + 1; j <= hi; j++) {
          fill_row(j, Ha.data(), Hb.data(),
                   dirseg.data() + (doff[j] - doff[lo + 1]) - lo_m[j]);
          std::swap(Ha, Hb);
        }
      }
      return dirseg[(doff[i] - doff[cur_seg * C + 1]) + (r - lo_m[i])];
    };

    std::vector<std::pair<int, i64>> aln;
    i64 i = n;
    int r = best_r;
    bool at_src = false;
    while (i > 0 || !at_src) {
      if (at_src) {
        aln.push_back({-1, i - 1});
        i--;
        continue;
      }
      u8 d = get_dir(i, r);
      int nid = topo[r];
      if (d == DIR_INS) {
        aln.push_back({-1, i - 1});
        i--;
      } else if (d == DIR_MATCH_SRC) {
        aln.push_back({nid, i - 1});
        i--;
        at_src = true;
      } else if (d == DIR_DEL_SRC) {
        aln.push_back({nid, -1});
        at_src = true;
      } else if (d & 1) {  // match via pred (d-3)/2
        aln.push_back({nid, i - 1});
        i--;
        r = rank[preds[nid][(d - 3) / 2]];
      } else {  // deletion via pred (d-4)/2
        aln.push_back({nid, -1});
        r = rank[preds[nid][(d - 4) / 2]];
      }
    }
    std::reverse(aln.begin(), aln.end());

    // ---- thread into graph ----
    int prev = -1;
    std::vector<int> path;
    for (auto& pr : aln) {
      int nid = pr.first;
      i64 pos = pr.second;
      if (pos < 0) continue;
      u8 c = s[pos];
      int node;
      if (nid >= 0) {
        if (ch[nid] == c) {
          node = nid;
        } else {
          node = -1;
          for (int cand : groups[group_of[nid]])
            if (ch[cand] == c) {
              node = cand;
              break;
            }
          if (node < 0) node = new_node(c, group_of[nid]);
        }
      } else {
        node = new_node(c, -1);
      }
      if (prev >= 0) add_edge(prev, node);
      path.push_back(node);
      prev = node;
    }
    paths.push_back(std::move(path));
  }

  std::vector<std::vector<u8>> msa() const {
    std::vector<int> order = topo_groups();
    std::vector<int> col(groups.size());
    for (size_t c = 0; c < order.size(); c++) col[order[c]] = int(c);
    size_t ncols = order.size();
    std::vector<std::vector<u8>> rows;
    rows.reserve(paths.size());
    for (auto& path : paths) {
      std::vector<u8> row(ncols, '-');
      for (int nid : path) row[col[group_of[nid]]] = ch[nid];
      rows.push_back(std::move(row));
    }
    return rows;
  }
};

}  // namespace szpoa

extern "C" {

// Batch MSA. Blocks are consecutive runs of sequences:
//   block b owns sequences [blk_off[b], blk_off[b+1])
//   sequence s spans bytes [seq_off[s], seq_off[s+1]) of `data`
// out_width[b]: MSA width, or -1 if the block overflowed its DP budget.
// Returns a handle; sz_poa_block_rows() yields the concatenated rows of one
// block (row-major, in input order); sz_poa_free releases.
void* sz_poa_run(const uint8_t* data, const int64_t* seq_off,
                 const int64_t* blk_off, int64_t n_blocks, int64_t threads,
                 int64_t budget_bytes, int64_t* out_width) {
  using namespace szpoa;
  auto* store = new std::vector<std::vector<u8>>(n_blocks);
  if (budget_bytes <= 0) budget_bytes = i64(2) << 30;
#ifdef _OPENMP
  int nt = int(threads > 0 ? threads : 1);
#pragma omp parallel for schedule(dynamic, 1) num_threads(nt)
#endif
  for (i64 b = 0; b < n_blocks; b++) {
    Graph g(budget_bytes);
    for (i64 s = blk_off[b]; s < blk_off[b + 1]; s++)
      g.add_sequence(data + seq_off[s], seq_off[s + 1] - seq_off[s]);
    if (g.overflow) {
      out_width[b] = -1;
      continue;
    }
    auto rows = g.msa();
    i64 w = rows.empty() ? 0 : i64(rows[0].size());
    out_width[b] = w;
    std::vector<u8>& flat = (*store)[b];
    flat.reserve(rows.size() * w);
    for (auto& r : rows) flat.insert(flat.end(), r.begin(), r.end());
  }
  return store;
}

int64_t sz_poa_block_bytes(void* h, int64_t b) {
  return int64_t(
      (*static_cast<std::vector<std::vector<uint8_t>>*>(h))[b].size());
}

const uint8_t* sz_poa_block_rows(void* h, int64_t b) {
  return (*static_cast<std::vector<std::vector<uint8_t>>*>(h))[b].data();
}

void sz_poa_free(void* h) {
  delete static_cast<std::vector<std::vector<uint8_t>>*>(h);
}

}  // extern "C"
