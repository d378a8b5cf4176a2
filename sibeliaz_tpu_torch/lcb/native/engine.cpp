// The port's copy of sibeliaz_tpu/lcb/native/engine.cpp, byte-equal below this
// header; the CPU tests hold it to the original.
// Native LCB construction engine.
//
// High-performance twin of sibeliaz_tpu/lcb/oracle.py (the executable
// specification, itself differential-tested byte-for-byte against the
// reference binary).  Flat-array design: chromosomes are slices of
// concatenated position/id/used arrays, vertex occurrences are a CSR, the
// per-path instance containers are sorted pointer vectors, and path scratch
// (distance map, vote counts) are dense arrays with touched-lists.
//
// Parallelism = the reference's speculative scheme re-expressed without
// shared mutable state during exploration: a phase of 256 bundles is
// explored concurrently against the previous phase's `used` snapshot
// (reads only), then commits run serially in bundle order with conflict
// re-runs (cf. blocksfinder.h:334-433).  Results are therefore identical
// for every thread count.
//
// Exposed via a C ABI consumed with ctypes (no pybind11 in this image).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <set>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace szt {

using i64 = int64_t;
using u8 = uint8_t;

static const i64 NEG_INF_SCORE = -((i64(1) << 31) - 1);  // -INT32_MAX
static const i64 DIST_UNSET = INT64_MAX;

static u8 COMP[256];
static bool comp_init = [] {
  memset(COMP, 'N', sizeof(COMP));
  COMP[u8('A')] = 'T';
  COMP[u8('T')] = 'A';
  COMP[u8('C')] = 'G';
  COMP[u8('G')] = 'C';
  return true;
}();

struct Graph {
  i64 k, V, n_chr;
  const i64 *chr_off, *jpos, *jid;
  u8* used;
  const i64* seq_off;
  const u8* seq;
  const i64* occ_off;
  const int32_t* occ_chr;
  const i64* occ_idx;
  const u8 *occ_ch, *occ_revch;

  inline i64 chr_size(i64 c) const { return chr_off[c + 1] - chr_off[c]; }
  inline i64 pos_at(i64 c, i64 i) const { return jpos[chr_off[c] + i]; }
  inline i64 id_at(i64 c, i64 i) const { return jid[chr_off[c] + i]; }
  inline i64 seq_len(i64 c) const { return seq_off[c + 1] - seq_off[c]; }
  inline u8 seq_at(i64 c, i64 p) const { return seq[seq_off[c] + p]; }
};

// A strand-aware walk position: chromosome c, record index i, strand s (+-1).
struct It {
  int32_t c;
  i64 i;
  int s;
  bool operator==(const It& o) const { return c == o.c && i == o.i && s == o.s; }
  bool operator!=(const It& o) const { return !(*this == o); }
};

struct Edge {
  i64 u, v;
  u8 ch, rev;
  i64 len;
};

struct Inst {
  int32_t c;
  int s;
  i64 fi, bi;       // front/back record indices
  i64 fdist, bdist; // path-frame distances
  i64 cmp;          // mutable ordering key (see path.h:53-181 analysis)
  bool ffin, bfin;
};

struct Bundle {
  i64 vid;
  u8 ch;
  uint64_t count, rank;
  uint64_t res_pos, res_chr;
  bool operator<(const Bundle& o) const {
    if (count != o.count) return count > o.count;
    if (rank != o.rank) return rank < o.rank;
    if (res_pos != o.res_pos) return res_pos < o.res_pos;
    return res_chr < o.res_chr;
  }
};

struct BlockRec {
  i64 id, c, start, end;
};

class Engine {
 public:
  const Graph& g;
  i64 m, b, flank, depth;

  Engine(const Graph& g_, i64 m_, i64 b_, i64 flank_, i64 depth_)
      : g(g_), m(m_), b(b_), flank(flank_), depth(depth_) {}

  inline bool valid(const It& it) const {
    return it.i >= 0 && it.i < g.chr_size(it.c);
  }
  inline i64 vid(const It& it) const { return it.s * g.id_at(it.c, it.i); }
  inline i64 pos(const It& it) const {
    i64 p = g.pos_at(it.c, it.i);
    return it.s > 0 ? p : p + g.k;
  }
  inline i64 abs_pos(const It& it) const { return g.pos_at(it.c, it.i); }
  inline It nxt(const It& it) const { return It{it.c, it.i + it.s, it.s}; }
  inline It prv(const It& it) const { return It{it.c, it.i - it.s, it.s}; }
  inline u8 it_char(const It& it) const {
    i64 p = g.pos_at(it.c, it.i);
    if (it.s > 0)
      return p + g.k < g.seq_len(it.c) ? g.seq_at(it.c, p + g.k) : 0;
    return p > 0 ? COMP[g.seq_at(it.c, p - 1)] : u8('N');
  }
  inline bool is_used(const It& it) const {
    i64 base = g.chr_off[it.c];
    if (it.s > 0) return g.used[base + it.i];
    return it.i > 0 ? g.used[base + it.i - 1] : false;
  }
  inline void mark_used(const It& it) const {
    i64 base = g.chr_off[it.c];
    if (it.s > 0)
      g.used[base + it.i] = 1;
    else if (it.i > 0)
      g.used[base + it.i - 1] = 1;
  }
  inline bool it_lt(const It& a, const It& bb) const {
    bool pa = a.s > 0, pb = bb.s > 0;
    if (pa != pb) return pa < pb;
    if (a.c != bb.c) return a.c < bb.c;
    return a.i < bb.i;
  }
  Edge out_edge(const It& it) const {
    i64 c = it.c;
    if (it.s > 0) {
      i64 p0 = g.pos_at(c, it.i), p1 = g.pos_at(c, it.i + 1);
      return Edge{g.id_at(c, it.i), g.id_at(c, it.i + 1),
                  g.seq_at(c, p0 + g.k), COMP[g.seq_at(c, p1 - 1)], p1 - p0};
    }
    i64 p0 = g.pos_at(c, it.i), p1 = g.pos_at(c, it.i - 1);
    u8 rev = p0 + g.k < g.seq_len(c) ? g.seq_at(c, p0 + g.k) : 0;
    return Edge{-g.id_at(c, it.i), -g.id_at(c, it.i - 1),
                COMP[g.seq_at(c, p0 - 1)], rev, p0 - p1};
  }
  Edge in_edge(const It& it) const {
    i64 c = it.c;
    if (it.s > 0) {
      i64 p0 = g.pos_at(c, it.i), pp = g.pos_at(c, it.i - 1);
      return Edge{g.id_at(c, it.i - 1), g.id_at(c, it.i),
                  g.seq_at(c, pp + g.k), COMP[g.seq_at(c, p0 - 1)], p0 - pp};
    }
    i64 p0 = g.pos_at(c, it.i), pp = g.pos_at(c, it.i + 1);
    u8 rev = p0 + g.k < g.seq_len(c) ? g.seq_at(c, p0 + g.k) : 0;
    return Edge{-g.id_at(c, it.i + 1), -g.id_at(c, it.i),
                COMP[g.seq_at(c, pp - 1)], rev, pp - p0};
  }
  // occurrence j of |vid|: strand is + iff stored id equals the signed query
  inline It occ_it(i64 vid_, i64 j) const {
    int32_t c = g.occ_chr[j];
    i64 i = g.occ_idx[j];
    int s = g.id_at(c, i) == vid_ ? 1 : -1;
    return It{c, i, s};
  }
};

// ------------------------- Path -------------------------

struct Path {
  const Engine& e;
  std::vector<std::vector<Inst*>> isets;  // per chr, sorted by cmp
  std::vector<Inst*> all, good;
  std::vector<Inst> arena;
  std::vector<i64> dist;        // dense, index vid + V
  std::vector<i64> dist_touch;  // vertices with dist set
  std::vector<std::pair<Edge, i64>> left_body, right_body;
  i64 left_flank = 0, right_flank = 0;
  i64 origin = 0;
  std::vector<int32_t> touched_chr;

  explicit Path(const Engine& e_) : e(e_) {
    isets.resize(e.g.n_chr);
    dist.assign(2 * e.g.V, DIST_UNSET);
    arena.reserve(1024);
  }

  inline bool dist_set(i64 v) const { return dist[v + e.g.V] != DIST_UNSET; }
  inline i64 dist_get(i64 v) const { return dist[v + e.g.V]; }
  inline void dist_put(i64 v, i64 d) {
    dist[v + e.g.V] = d;
    dist_touch.push_back(v);
  }

  inline i64 real_length(const Inst* x) const {
    const i64* jp = e.g.jpos + e.g.chr_off[x->c];
    i64 d = jp[x->fi] - jp[x->bi];
    return d < 0 ? -d : d;
  }
  inline bool is_good(const Inst* x) const { return real_length(x) >= e.m; }
  inline It front_it(const Inst* x) const { return It{x->c, x->fi, x->s}; }
  inline It back_it(const Inst* x) const { return It{x->c, x->bi, x->s}; }

  void init(i64 vid, u8 ch) {
    origin = vid;
    dist_put(vid, 0);
    left_flank = right_flank = 0;
    i64 v = vid < 0 ? -vid : vid;
    for (i64 j = e.g.occ_off[v]; j < e.g.occ_off[v + 1]; j++) {
      It it = e.occ_it(vid, j);
      if (!e.is_used(it) && ch == e.it_char(it)) insert_inst(it, 0);
    }
  }

  Inst* insert_inst(const It& it, i64 d) {
    // NOTE: arena must not reallocate (pointers are stored); grow chunked.
    if (arena.size() == arena.capacity()) {
      // migrate to a node-stable scheme: allocate on heap instead
      heap_insts.push_back(new Inst());
      Inst* x = heap_insts.back();
      *x = Inst{it.c, it.s, it.i, it.i, d, d, it.i, false, false};
      place(x);
      return x;
    }
    arena.push_back(Inst{it.c, it.s, it.i, it.i, d, d, it.i, false, false});
    Inst* x = &arena.back();
    place(x);
    return x;
  }
  std::vector<Inst*> heap_insts;

  void place(Inst* x) {
    auto& v = isets[x->c];
    auto p = std::upper_bound(
        v.begin(), v.end(), x->cmp,
        [](i64 key, const Inst* a) { return key < a->cmp; });
    v.insert(p, x);
    all.push_back(x);
    touched_chr.push_back(x->c);
  }

  void clear() {
    for (i64 v : dist_touch) dist[v + e.g.V] = DIST_UNSET;
    dist_touch.clear();
    left_body.clear();
    right_body.clear();
    for (int32_t c : touched_chr) isets[c].clear();
    touched_chr.clear();
    all.clear();
    good.clear();
    arena.clear();
    for (Inst* p : heap_insts) delete p;
    heap_insts.clear();
  }

  inline i64 left_distance() const { return -left_flank; }
  inline i64 right_distance() const { return right_flank; }
  inline i64 middle_length() const { return left_distance() + right_distance(); }
  inline i64 right_vertex() const {
    return right_body.empty() ? origin : right_body.back().first.v;
  }
  inline i64 left_vertex() const {
    return left_body.empty() ? origin : left_body.back().first.u;
  }

  // During a phase's parallel exploration `used` is frozen (writes happen
  // only at serial commit), so the used-between scan degenerates to a range
  // query over a per-phase exclusive prefix sum; serial re-runs (mutating
  // `used`) fall back to the literal walk.
  const i64* used_pfx = nullptr;

  inline bool used_between(const It& start, const It& end) const {
    if (used_pfx && start.c == end.c) {
      i64 base = e.g.chr_off[start.c];
      i64 lo, hi;  // strand-aware used-slot range [lo, hi)
      if (start.s > 0) {
        lo = start.i;
        hi = end.i;  // slots idx for idx in [start.i, end.i)
      } else {
        lo = end.i;
        hi = start.i;  // slots idx-1 for idx in (end.i, start.i]
      }
      if (hi <= lo) return false;
      return used_pfx[base + hi] - used_pfx[base + lo] != 0;
    }
    for (It it = start; it != end; it = e.nxt(it))
      if (e.is_used(it)) return true;
    return false;
  }

  bool compatible(const It& start, const It& end, const Edge& ed) const {
    if ((start.s > 0) != (end.s > 0)) return false;
    if (used_between(start, end)) return false;
    i64 real_diff = e.pos(end) - e.pos(start);
    i64 anc_diff = dist_get(e.vid(end)) - dist_get(e.vid(start));
    if (start.s > 0) {
      if (real_diff < 0) return false;
    } else {
      if (-real_diff < 0) return false;
    }
    i64 ad = real_diff < 0 ? -real_diff : real_diff;
    if (ad > e.b || anc_diff > e.b) {
      It s1 = e.nxt(start);
      if (!e.valid(s1) || e.it_char(start) != ed.ch || end != s1 ||
          e.vid(s1) != ed.v)
        return false;
    }
    return true;
  }

  bool push_back(const Edge& ed) {
    i64 vertex = ed.v;
    if (dist_set(vertex)) return false;
    i64 start_d = right_flank, end_d = start_d + ed.len;
    dist_put(vertex, end_d);
    i64 av = vertex < 0 ? -vertex : vertex;
    for (i64 j = e.g.occ_off[av]; j < e.g.occ_off[av + 1]; j++) {
      It seq_it = e.occ_it(vertex, j);
      auto& iset = isets[seq_it.c];
      auto p = std::upper_bound(
          iset.begin(), iset.end(), seq_it.i,
          [](i64 key, const Inst* a) { return key < a->cmp; });
      size_t pi = p - iset.begin();
      if (pi < iset.size()) {
        Inst* x = iset[pi];
        i64 lo = x->fi < x->bi ? x->fi : x->bi;
        i64 hi = x->fi < x->bi ? x->bi : x->fi;
        if (seq_it.i >= lo && seq_it.i <= hi) continue;
      }
      Inst* cand = nullptr;
      if (seq_it.s > 0) {
        if (pi > 0 && compatible(back_it(iset[pi - 1]), seq_it, ed))
          cand = iset[pi - 1];
      } else {
        if (pi < iset.size() && compatible(back_it(iset[pi]), seq_it, ed))
          cand = iset[pi];
      }
      if (cand && e.vid(back_it(cand)) != vertex) {
        if (!cand->bfin) {
          bool was_good = is_good(cand);
          cand->bi = seq_it.i;
          cand->bdist = end_d;
          if (cand->s > 0) cand->cmp = cand->bi;
          if (!was_good && is_good(cand)) good.push_back(cand);
          if (e.is_used(seq_it)) cand->bfin = true;
        }
      } else if (!e.is_used(seq_it)) {
        insert_inst(seq_it, end_d);
      }
    }
    right_body.push_back({ed, start_d});
    right_flank = end_d;
    return true;
  }

  bool push_front(const Edge& ed) {
    i64 vertex = ed.u;
    if (dist_set(vertex)) return false;
    i64 end_d = left_flank, start_d = end_d - ed.len;
    dist_put(vertex, start_d);
    i64 av = vertex < 0 ? -vertex : vertex;
    for (i64 j = e.g.occ_off[av]; j < e.g.occ_off[av + 1]; j++) {
      It seq_it = e.occ_it(vertex, j);
      auto& iset = isets[seq_it.c];
      auto p = std::upper_bound(
          iset.begin(), iset.end(), seq_it.i,
          [](i64 key, const Inst* a) { return key < a->cmp; });
      size_t pi = p - iset.begin();
      if (pi < iset.size()) {
        Inst* x = iset[pi];
        i64 lo = x->fi < x->bi ? x->fi : x->bi;
        i64 hi = x->fi < x->bi ? x->bi : x->fi;
        if (seq_it.i >= lo && seq_it.i <= hi) continue;
      }
      Inst* cand = nullptr;
      if (seq_it.s > 0) {
        if (pi < iset.size() && compatible(seq_it, front_it(iset[pi]), ed))
          cand = iset[pi];
      } else {
        if (pi > 0 && compatible(seq_it, front_it(iset[pi - 1]), ed))
          cand = iset[pi - 1];
      }
      if (cand && e.vid(front_it(cand)) != vertex) {
        if (!cand->ffin) {
          bool was_good = is_good(cand);
          cand->fi = seq_it.i;
          cand->fdist = start_d;
          if (cand->s < 0) cand->cmp = cand->fi;
          if (!was_good && is_good(cand)) good.push_back(cand);
          if (e.is_used(seq_it)) cand->ffin = true;
        }
      } else if (!e.is_used(seq_it)) {
        insert_inst(seq_it, start_d);
      }
    }
    left_body.push_back({ed, start_d});
    left_flank = start_d;
    return true;
  }

  i64 score() const {
    i64 ret = 0;
    for (const Inst* x : good) {
      i64 sc = real_length(x);
      i64 rp = right_distance() - x->bdist;
      i64 lp = left_distance() + x->fdist;
      if (lp >= e.flank || rp >= e.flank) return NEG_INF_SCORE;
      sc -= (rp + lp) * (rp + lp);
      ret += sc;
    }
    return ret;
  }
};

// ------------------------- per-bundle processing -------------------------

struct Scratch {
  Path path;
  // uint32 on purpose: the reference wraps votes at 2^32
  // (blocksfinder.h:341,733) — well-defined and load-bearing for parity
  std::vector<uint32_t> count;  // dense votes, index vid + V
  std::vector<i64> touched;     // vote entries to reset
  explicit Scratch(const Engine& e)
      : path(e), count(2 * e.g.V + 1, 0) {}
};

struct NextPick {
  i64 vid = 0;
  It origin{0, 0, 0};
  uint64_t cnt = 0;
  bool has_origin = false;
};

static NextPick most_popular(const Engine& e, Path& path, bool forward,
                             Scratch& sc, bool try_used) {
  NextPick ret;
  i64 start_vid = forward ? path.right_vertex() : path.left_vertex();
  auto& lst = path.good.size() >= 2 ? path.good : path.all;
  for (Inst* inst : lst) {
    It now = forward ? path.back_it(inst) : path.front_it(inst);
    if (e.vid(now) != start_vid) continue;
    uint64_t weight = uint64_t(path.real_length(inst)) + 1;
    It origin = now;
    It it = forward ? e.nxt(origin) : e.prv(origin);
    for (i64 d = 1;
         e.valid(it) && (d < e.depth ||
                         std::abs(e.pos(it) - e.pos(origin)) <= e.b);
         d++) {
      i64 v = e.vid(it);
      if (!path.dist_set(v) && (!e.is_used(it) || try_used)) {
        i64 adj = v + e.g.V;
        if (sc.count[adj] == 0) sc.touched.push_back(adj);
        sc.count[adj] += uint32_t(weight);
        if (sc.count[adj] > ret.cnt ||
            (sc.count[adj] == ret.cnt && ret.has_origin &&
             e.it_lt(origin, ret.origin))) {
          ret.cnt = sc.count[adj];
          ret.origin = origin;
          ret.has_origin = true;
          ret.vid = v;
        }
      } else {
        break;
      }
      it = forward ? e.nxt(it) : e.prv(it);
    }
  }
  for (i64 a : sc.touched) sc.count[a] = 0;
  sc.touched.clear();
  return ret;
}

struct ProcState {
  i64 score = 0, best_score = 0;
  size_t best_right = 1, best_left = 1;
  std::vector<Inst> best;
};

static bool extend_forward(const Engine& e, Path& path, Scratch& sc,
                           ProcState& st) {
  bool success = false;
  NextPick pick = most_popular(e, path, true, sc, false);
  if (pick.vid == 0) pick = most_popular(e, path, true, sc, true);
  if (pick.vid != 0) {
    for (It it = pick.origin; e.vid(it) != pick.vid; it = e.nxt(it)) {
      success = path.push_back(e.out_edge(it));
      if (success) {
        st.score = path.score();
        if (st.score > st.best_score) {
          st.best_score = st.score;
          st.best_right = path.right_body.size() + 1;
          if (st.score > 0) {
            st.best.clear();
            for (Inst* x : path.good) st.best.push_back(*x);
          }
        }
      }
    }
  }
  return success;
}

static bool extend_backward(const Engine& e, Path& path, Scratch& sc,
                            ProcState& st) {
  bool success = false;
  NextPick pick = most_popular(e, path, false, sc, false);
  // backward has no used-retry (cf. blocksfinder.h:846-848, commented out)
  if (pick.vid != 0) {
    for (It it = pick.origin; e.vid(it) != pick.vid; it = e.prv(it)) {
      success = path.push_front(e.in_edge(it));
      if (success) {
        st.score = path.score();
        if (st.score > st.best_score) {
          st.best_score = st.score;
          st.best_left = path.left_body.size() + 1;
          if (st.score > 0) {
            st.best.clear();
            for (Inst* x : path.good) st.best.push_back(*x);
          }
        }
      }
    }
  }
  return success;
}

static void process(const Engine& e, const Bundle& bu, Scratch& sc,
                    std::vector<Inst>& out_best,
                    const i64* used_pfx = nullptr) {
  Path& path = sc.path;
  path.used_pfx = used_pfx;
  path.clear();
  path.init(bu.vid, bu.ch);
  ProcState st;
  i64 min_run = e.b * 2;
  bool ret;
  // forward sweep with minRun continuation
  while (true) {
    bool positive = false;
    i64 prev_len = path.middle_length();
    while (true) {
      ret = extend_forward(e, path, sc, st);
      if (!(ret && path.middle_length() - prev_len <= min_run)) break;
      positive = positive || (st.score > 0);
    }
    if (!ret || !positive) break;
  }
  // rewind to best prefix
  std::vector<Edge> best_edges;
  for (size_t i = 0; i + 1 < st.best_right; i++)
    best_edges.push_back(path.right_body[i].first);
  path.clear();
  path.init(bu.vid, bu.ch);
  for (auto& ed : best_edges) path.push_back(ed);
  // backward sweep; `positive` is read ONCE from the final score per outer
  // iteration (the reference's stray ';', blocksfinder.h:297-299)
  while (true) {
    i64 prev_len = path.middle_length();
    while (true) {
      ret = extend_backward(e, path, sc, st);
      if (!(ret && path.middle_length() - prev_len <= min_run)) break;
    }
    bool positive = st.score > 0;
    if (!ret || !positive) break;
  }
  path.clear();
  out_best = std::move(st.best);
}

// ------------------------- bundles + phases -------------------------

static std::vector<Bundle> make_bundles(const Engine& e) {
  std::vector<Bundle> bundles;
  i64 V = e.g.V;
  for (i64 v = -V + 1; v < V; v++) {
    i64 av = v < 0 ? -v : v;
    i64 lo = e.g.occ_off[av], hi = e.g.occ_off[av + 1];
    if (lo == hi) continue;
    std::set<u8> goodch;
    std::map<u8, uint64_t> cnt;
    for (i64 j = lo; j < hi; j++) {
      It it = e.occ_it(v, j);
      u8 ch = it.s > 0 ? e.g.occ_ch[j] : e.g.occ_revch[j];
      if (it.s > 0) goodch.insert(ch);
      cnt[ch] += 1;
    }
    for (auto& p : cnt) {
      if (p.second > 1 && goodch.count(p.first)) {
        uint64_t rank = 0, base = 1;
        uint64_t res_pos = UINT64_MAX, res_chr = UINT64_MAX;
        for (i64 j = lo; j < hi; j++) {
          It it = e.occ_it(v, j);
          u8 ch = it.s > 0 ? e.g.occ_ch[j] : e.g.occ_revch[j];
          if (ch == p.first) {
            rank += uint64_t(it.c) * base;
            base *= 31;
            if (it.s > 0) {
              uint64_t pp = uint64_t(e.g.pos_at(it.c, it.i));
              if (pp < res_pos || (pp == res_pos && uint64_t(it.c) < res_chr)) {
                res_pos = pp;
                res_chr = uint64_t(it.c);
              }
            }
          }
        }
        bundles.push_back(Bundle{v, p.first, p.second, rank, res_pos, res_chr});
      }
    }
  }
  std::sort(bundles.begin(), bundles.end());
  return bundles;
}

struct Result {
  std::vector<i64> blocks;  // id, chr, start, end quadruples
  i64 blocks_found = 0;
  i64 failures = 0;
};

static void finalize(const Engine& e, Result& res,
                     const std::vector<Inst>& best, std::set<int32_t>& invalid) {
  i64 bid = ++res.blocks_found;
  for (const Inst& x : best) {
    invalid.insert(x.c);
    It front{x.c, x.fi, x.s}, back{x.c, x.bi, x.s};
    if (x.s > 0) {
      res.blocks.insert(res.blocks.end(),
                        {bid, i64(x.c), e.pos(front), e.pos(back) + e.g.k});
    } else {
      res.blocks.insert(res.blocks.end(),
                        {-bid, i64(x.c), e.pos(back) - e.g.k, e.pos(front)});
    }
    for (It it = front; it != back; it = e.nxt(it)) e.mark_used(it);
  }
}

static Result run(const Engine& e, i64 threads) {
  Result res;
  const bool timing = std::getenv("SZ_LCB_TIMING") != nullptr;
  auto t0 = std::chrono::steady_clock::now();
  std::vector<Bundle> bundles = make_bundles(e);
  auto t1 = std::chrono::steady_clock::now();
  if (timing)
    fprintf(stderr, "[szlcb] bundles: %zu in %.3fs\n", bundles.size(),
            std::chrono::duration<double>(t1 - t0).count());
  const size_t phase_size = 256;
  size_t phase = 0;
  int nt = int(threads > 0 ? threads : 1);
#ifdef _OPENMP
  nt = std::min<int>(nt, omp_get_max_threads());
#endif
  std::vector<Scratch*> scratch(nt, nullptr);
  for (int t = 0; t < nt; t++) scratch[t] = new Scratch(e);
  std::vector<std::vector<Inst>> results(phase_size);
  // exclusive prefix of used flags over flat record slots; rebuilt whenever
  // a commit marked junctions, valid for the next phase's frozen state
  i64 total_slots = e.g.chr_off[e.g.n_chr];
  std::vector<i64> used_pfx(total_slots + 1, 0);
  bool pfx_dirty = true;
  while (phase < bundles.size()) {
    size_t limit = std::min(phase + phase_size, bundles.size());
    if (pfx_dirty) {
      for (i64 t = 0; t < total_slots; t++)
        used_pfx[t + 1] = used_pfx[t] + (e.g.used[t] ? 1 : 0);
      pfx_dirty = false;
    }
    size_t blocks_before = size_t(res.blocks_found);
    // exploration: read-only w.r.t. `used`, deterministic per bundle
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1) num_threads(nt)
#endif
    for (size_t idx = phase; idx < limit; idx++) {
#ifdef _OPENMP
      int t = omp_get_thread_num();
#else
      int t = 0;
#endif
      process(e, bundles[idx], *scratch[t], results[idx - phase],
              used_pfx.data());
    }
    // serial ordered commit with conflict re-run
    std::set<int32_t> invalid;
    for (size_t idx = phase; idx < limit; idx++) {
      std::vector<Inst>& best = results[idx - phase];
      if (best.size() > 1) {
        bool is_good = true;
        for (const Inst& x : best) {
          if (!invalid.count(x.c)) continue;
          It it{x.c, x.fi, x.s}, back{x.c, x.bi, x.s};
          for (; it != back; it = e.nxt(it)) {
            if (e.is_used(it)) {
              is_good = false;
              break;
            }
          }
          if (!is_good) break;
        }
        if (is_good) {
          finalize(e, res, best, invalid);
        } else {
          res.failures++;
          process(e, bundles[idx], *scratch[0], best);
          if (best.size() > 1) finalize(e, res, best, invalid);
        }
      }
    }
    if (size_t(res.blocks_found) != blocks_before) pfx_dirty = true;
    phase = limit;
  }
  for (int t = 0; t < nt; t++) delete scratch[t];
  if (timing) {
    auto t2 = std::chrono::steady_clock::now();
    fprintf(stderr, "[szlcb] phases: %.3fs, blocks %lld, failures %lld\n",
            std::chrono::duration<double>(t2 - t1).count(),
            (long long)res.blocks_found, (long long)res.failures);
  }
  return res;
}

}  // namespace szt

// ------------------------- C ABI -------------------------

extern "C" {

void* sz_lcb_run(int64_t k, int64_t n_vertices, int64_t n_chr,
                 const int64_t* chr_off, const int64_t* jpos,
                 const int64_t* jid, uint8_t* used, const int64_t* seq_off,
                 const uint8_t* seq, const int64_t* occ_off,
                 const int32_t* occ_chr, const int64_t* occ_idx,
                 const uint8_t* occ_ch, const uint8_t* occ_revch,
                 int64_t min_block, int64_t max_branch, int64_t max_flank,
                 int64_t depth, int64_t threads, int64_t* out_nblocks,
                 int64_t* out_found, int64_t* out_failures) {
  szt::Graph g{k,      n_vertices, n_chr,   chr_off, jpos,
               jid,    used,       seq_off, seq,     occ_off,
               occ_chr, occ_idx,   occ_ch,  occ_revch};
  szt::Engine e(g, min_block, max_branch, max_flank, depth);
  auto* res = new szt::Result(szt::run(e, threads));
  *out_nblocks = int64_t(res->blocks.size() / 4);
  *out_found = res->blocks_found;
  *out_failures = res->failures;
  return res;
}

const int64_t* sz_lcb_blocks(void* h) {
  return static_cast<szt::Result*>(h)->blocks.data();
}

void sz_lcb_free(void* h) { delete static_cast<szt::Result*>(h); }

}  // extern "C"
