// Native FST operations: composition and DAG shortest path.
//
// The reference links OpenFst for its decode path (CRF_LatticeBuilder /
// CRFFstDecode -- SURVEY.md §2.1 L0/L6); this is the from-scratch native
// equivalent for the host-side lexicon/LM work, exposed through a plain C
// ABI consumed via ctypes (asr_craft/decode/fst_native.py).  Semantics
// mirror the Python reference implementation in asr_craft/decode/fst.py
// exactly (tropical weights, label 0 = epsilon, B must be input-eps-free,
// A output-epsilon arcs advance A alone); equivalence is enforced by
// randomized tests (tests/unit/test_native.py).
//
// Built on first use by asr_craft/utils/native_build.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <deque>
#include <functional>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

struct Fst {
  int32_t num_states = 0;
  int32_t start = 0;
  std::vector<int32_t> src, dst, il, ol;
  std::vector<float> w;
  std::vector<float> final_w;  // inf = non-final
};

const float kInf = std::numeric_limits<float>::infinity();

}  // namespace

extern "C" {

// Opaque result handle ----------------------------------------------------

void* craft_fst_new() { return new Fst(); }
void craft_fst_free(void* h) { delete static_cast<Fst*>(h); }
int32_t craft_fst_num_states(void* h) { return static_cast<Fst*>(h)->num_states; }
int32_t craft_fst_num_arcs(void* h) { return (int32_t)static_cast<Fst*>(h)->src.size(); }
int32_t craft_fst_start(void* h) { return static_cast<Fst*>(h)->start; }

void craft_fst_export(void* h, int32_t* src, int32_t* dst, int32_t* il,
                      int32_t* ol, float* w, float* final_w) {
  Fst* f = static_cast<Fst*>(h);
  size_t n = f->src.size();
  std::memcpy(src, f->src.data(), n * 4);
  std::memcpy(dst, f->dst.data(), n * 4);
  std::memcpy(il, f->il.data(), n * 4);
  std::memcpy(ol, f->ol.data(), n * 4);
  std::memcpy(w, f->w.data(), n * 4);
  std::memcpy(final_w, f->final_w.data(), f->num_states * 4);
}

// Composition A o B (match a.olabel == b.ilabel); returns handle or null on
// error (B has an input epsilon).
void* craft_compose(
    int32_t a_ns, int32_t a_start, int32_t a_na, const int32_t* a_src,
    const int32_t* a_dst, const int32_t* a_il, const int32_t* a_ol,
    const float* a_w, const float* a_final,
    int32_t b_ns, int32_t b_start, int32_t b_na, const int32_t* b_src,
    const int32_t* b_dst, const int32_t* b_il, const int32_t* b_ol,
    const float* b_w, const float* b_final) {
  // index arcs by source state (CSR-ish)
  std::vector<std::vector<int32_t>> a_adj(a_ns), b_adj(b_ns);
  for (int32_t i = 0; i < a_na; ++i) a_adj[a_src[i]].push_back(i);
  for (int32_t j = 0; j < b_na; ++j) {
    if (b_il[j] == 0) return nullptr;  // B must be input-eps-free
    b_adj[b_src[j]].push_back(j);
  }
  // index B arcs by (state, ilabel)
  std::unordered_map<int64_t, std::vector<int32_t>> b_index;
  b_index.reserve(b_na * 2);
  for (int32_t j = 0; j < b_na; ++j)
    b_index[(int64_t)b_src[j] << 32 | (uint32_t)b_il[j]].push_back(j);

  std::unordered_map<int64_t, int32_t> pair_id;
  pair_id.reserve(1024);
  auto get_id = [&](int32_t sa, int32_t sb) {
    int64_t key = (int64_t)sa * b_ns + sb;
    auto it = pair_id.find(key);
    if (it != pair_id.end()) return it->second;
    int32_t id = (int32_t)pair_id.size();
    pair_id.emplace(key, id);
    return id;
  };

  Fst* out = new Fst();
  std::deque<std::pair<int32_t, int32_t>> queue;
  std::vector<std::pair<int32_t, float>> finals;  // (state, weight)
  out->start = get_id(a_start, b_start);
  queue.emplace_back(a_start, b_start);
  // `seen` is implied by pair_id insertion order vs queue pushes
  std::unordered_map<int64_t, bool> seen;
  seen[(int64_t)a_start * b_ns + b_start] = true;

  while (!queue.empty()) {
    auto [sa, sb] = queue.front();
    queue.pop_front();
    int32_t s = get_id(sa, sb);
    if (std::isfinite(a_final[sa]) && std::isfinite(b_final[sb]))
      finals.emplace_back(s, a_final[sa] + b_final[sb]);
    for (int32_t i : a_adj[sa]) {
      if (a_ol[i] == 0) {  // output-epsilon: advance A alone
        int64_t key = (int64_t)a_dst[i] * b_ns + sb;
        out->src.push_back(s);
        out->dst.push_back(get_id(a_dst[i], sb));
        out->il.push_back(a_il[i]);
        out->ol.push_back(0);
        out->w.push_back(a_w[i]);
        if (!seen[key]) { seen[key] = true; queue.emplace_back(a_dst[i], sb); }
      } else {
        auto it = b_index.find((int64_t)sb << 32 | (uint32_t)a_ol[i]);
        if (it == b_index.end()) continue;
        for (int32_t j : it->second) {
          int64_t key = (int64_t)a_dst[i] * b_ns + b_dst[j];
          out->src.push_back(s);
          out->dst.push_back(get_id(a_dst[i], b_dst[j]));
          out->il.push_back(a_il[i]);
          out->ol.push_back(b_ol[j]);
          out->w.push_back(a_w[i] + b_w[j]);
          if (!seen[key]) {
            seen[key] = true;
            queue.emplace_back(a_dst[i], b_dst[j]);
          }
        }
      }
    }
  }
  out->num_states = (int32_t)pair_id.size();
  if (out->num_states == 0) out->num_states = 1;
  out->final_w.assign(out->num_states, kInf);
  for (auto& [s, fw] : finals) out->final_w[s] = fw;
  return out;
}

// DAG shortest path.  Returns 0 ok, 1 cycle, 2 no accepting path,
// 3 output buffer too small.  Path labels written with epsilons removed.
int32_t craft_shortest_path(
    int32_t ns, int32_t start, int32_t na, const int32_t* src,
    const int32_t* dst, const int32_t* il, const int32_t* ol,
    const float* w, const float* final_w,
    int32_t max_out, int32_t* out_il, int32_t* out_ol,
    int32_t* out_ni, int32_t* out_no, float* out_weight) {
  std::vector<std::vector<int32_t>> adj(ns);
  std::vector<int32_t> indeg(ns, 0);
  for (int32_t i = 0; i < na; ++i) {
    adj[src[i]].push_back(i);
    indeg[dst[i]]++;
  }
  // Kahn topological order
  std::vector<int32_t> order;
  order.reserve(ns);
  std::deque<int32_t> q;
  for (int32_t s = 0; s < ns; ++s)
    if (indeg[s] == 0) q.push_back(s);
  while (!q.empty()) {
    int32_t s = q.front();
    q.pop_front();
    order.push_back(s);
    for (int32_t i : adj[s])
      if (--indeg[dst[i]] == 0) q.push_back(dst[i]);
  }
  if ((int32_t)order.size() != ns) return 1;  // cycle

  std::vector<double> dist(ns, kInf);
  std::vector<int32_t> back(ns, -1);
  dist[start] = 0.0;
  for (int32_t s : order) {
    if (!std::isfinite(dist[s])) continue;
    for (int32_t i : adj[s]) {
      double nd = dist[s] + w[i];
      if (nd < dist[dst[i]]) {
        dist[dst[i]] = nd;
        back[dst[i]] = i;
      }
    }
  }
  double best = kInf;
  int32_t end = -1;
  for (int32_t s = 0; s < ns; ++s) {
    double tot = dist[s] + final_w[s];
    if (tot < best) { best = tot; end = s; }
  }
  if (end < 0) return 2;

  std::vector<int32_t> ri, ro;
  for (int32_t s = end; back[s] >= 0; s = src[back[s]]) {
    int32_t i = back[s];
    if (il[i]) ri.push_back(il[i]);
    if (ol[i]) ro.push_back(ol[i]);
  }
  if ((int32_t)ri.size() > max_out || (int32_t)ro.size() > max_out) return 3;
  *out_ni = (int32_t)ri.size();
  *out_no = (int32_t)ro.size();
  for (size_t k = 0; k < ri.size(); ++k) out_il[k] = ri[ri.size() - 1 - k];
  for (size_t k = 0; k < ro.size(); ++k) out_ol[k] = ro[ro.size() - 1 - k];
  *out_weight = (float)best;
  return 0;
}

// On-the-fly FST-composed beam Viterbi (CRF_ViterbiDecoder parity --
// SURVEY.md §3.3): time-synchronous tokens (expanded label, grammar state)
// through the phone-input search graph G = lexicon [o LM], Viterbi
// recombination per token, threshold/max-active pruning per frame.  The
// frame-run collapser is implicit (G advances only on phone change).
// Twin of asr_craft/decode/otf.py (the correctness oracle).
//
// state: (T, L) float64 row-major; trans: (L, L) or (T, L, L) when
// trans_frame_dep != 0.  beam_threshold < 0 / max_active <= 0 disable.
// Returns 0 ok, 2 no accepting hypothesis, 3 word buffer too small.
int32_t craft_otf_decode(
    int32_t T, int32_t L, const double* state, const double* trans,
    int32_t trans_frame_dep, int32_t num_states,
    int32_t g_ns, int32_t g_start, int32_t g_na, const int32_t* g_src,
    const int32_t* g_dst, const int32_t* g_il, const int32_t* g_ol,
    const float* g_w, const float* g_final,
    double beam_threshold, int32_t max_active,
    int32_t max_words, int32_t* out_words, int32_t* out_nw,
    int32_t* out_path, double* out_weight) {
  const double kFinite = -1e29;  // potentials below = semiring zero
  struct Token { int32_t l, g; double sc; int32_t parent, word; };

  // G arc index by (state, phone ilabel)
  std::unordered_map<int64_t, std::vector<int32_t>> gi;
  gi.reserve(g_na * 2);
  for (int32_t j = 0; j < g_na; ++j)
    gi[(int64_t)g_src[j] << 32 | (uint32_t)g_il[j]].push_back(j);

  std::vector<std::vector<Token>> frames(T);
  std::unordered_map<int64_t, int32_t> slot;  // (l, g) -> index in cur
  auto key_of = [&](int32_t l, int32_t g) {
    return (int64_t)l * g_ns + g;
  };
  auto phone_of = [&](int32_t l) { return l / num_states + 1; };

  auto relax = [&](std::vector<Token>& cur, int32_t l, int32_t g, double sc,
                   int32_t parent, int32_t word) {
    int64_t k = key_of(l, g);
    auto it = slot.find(k);
    if (it == slot.end()) {
      slot.emplace(k, (int32_t)cur.size());
      cur.push_back({l, g, sc, parent, word});
    } else if (sc < cur[it->second].sc) {
      cur[it->second] = {l, g, sc, parent, word};
    }
  };

  auto prune = [&](std::vector<Token>& cur) {
    if (cur.empty()) return;
    if (beam_threshold >= 0) {
      double best = cur[0].sc;
      for (const Token& t : cur) best = std::min(best, t.sc);
      std::vector<Token> kept;
      kept.reserve(cur.size());
      for (const Token& t : cur)
        if (t.sc <= best + beam_threshold) kept.push_back(t);
      cur.swap(kept);
    }
    if (max_active > 0 && (int32_t)cur.size() > max_active) {
      std::nth_element(cur.begin(), cur.begin() + max_active - 1, cur.end(),
                       [](const Token& a, const Token& b) {
                         return a.sc < b.sc;
                       });
      cur.resize(max_active);
    }
  };

  // frame 0: enter G with each label's phone
  slot.clear();
  for (int32_t l = 0; l < L; ++l) {
    double s0 = state[l];
    if (s0 < kFinite) continue;
    auto it = gi.find((int64_t)g_start << 32 | (uint32_t)phone_of(l));
    if (it == gi.end()) continue;
    for (int32_t j : it->second)
      relax(frames[0], l, g_dst[j], -s0 + g_w[j], -1, g_ol[j]);
  }
  prune(frames[0]);

  for (int32_t t = 1; t < T; ++t) {
    const double* st = state + (int64_t)t * L;
    const double* tr = trans_frame_dep ? trans + (int64_t)t * L * L : trans;
    slot.clear();
    std::vector<Token>& prev = frames[t - 1];
    for (int32_t eid = 0; eid < (int32_t)prev.size(); ++eid) {
      const Token tok = prev[eid];
      const double* trow = tr + (int64_t)tok.l * L;
      int32_t ph = phone_of(tok.l);
      for (int32_t lp = 0; lp < L; ++lp) {
        double w = trow[lp] + st[lp];
        if (w < kFinite) continue;
        double ns = tok.sc - w;
        int32_t php = phone_of(lp);
        if (php == ph) {
          relax(frames[t], lp, tok.g, ns, eid, 0);
        } else {
          auto it = gi.find((int64_t)tok.g << 32 | (uint32_t)php);
          if (it == gi.end()) continue;
          for (int32_t j : it->second)
            relax(frames[t], lp, g_dst[j], ns + g_w[j], eid, g_ol[j]);
        }
      }
    }
    prune(frames[t]);
  }

  double best = kInf;
  int32_t best_eid = -1;
  for (int32_t eid = 0; eid < (int32_t)frames[T - 1].size(); ++eid) {
    const Token& t = frames[T - 1][eid];
    if (!std::isfinite(g_final[t.g])) continue;
    double tot = t.sc + g_final[t.g];
    if (tot < best) { best = tot; best_eid = eid; }
  }
  if (best_eid < 0) return 2;

  std::vector<int32_t> words_rev;
  int32_t eid = best_eid;
  for (int32_t t = T - 1; t >= 0; --t) {
    const Token& tok = frames[t][eid];
    out_path[t] = tok.l;
    if (tok.word) words_rev.push_back(tok.word);
    eid = tok.parent;
  }
  if ((int32_t)words_rev.size() > max_words) return 3;
  *out_nw = (int32_t)words_rev.size();
  for (size_t k = 0; k < words_rev.size(); ++k)
    out_words[k] = words_rev[words_rev.size() - 1 - k];
  *out_weight = best;
  return 0;
}

// Fully dynamic composition (WSJ-scale lexicons): tokens carry
// (expanded label, LEXICON state, LM state) and the LM advances only when
// the lexicon emits a word, through its input-epsilon closure (backoff
// bigram LMs).  No composed search graph is ever built -- the trie x
// history product (~1e8 pairs at 5k words x bigram) never exists; memory
// is bounded by the live beam.  Twin of
// asr_craft/decode/otf.py:otf_decode_words_dynamic (the oracle).
// lm_ns == 0 disables the LM.  Returns 0 ok, 2 no hypothesis, 3 word
// buffer too small.
int32_t craft_otf_decode_dynamic(
    int32_t T, int32_t L, const double* state, const double* trans,
    int32_t trans_frame_dep, int32_t num_states,
    int32_t lx_ns, int32_t lx_start, int32_t lx_na, const int32_t* lx_src,
    const int32_t* lx_dst, const int32_t* lx_il, const int32_t* lx_ol,
    const float* lx_w, const float* lx_final,
    int32_t lm_ns, int32_t lm_start, int32_t lm_na, const int32_t* lm_src,
    const int32_t* lm_dst, const int32_t* lm_il, const int32_t* lm_ol,
    const float* lm_w, const float* lm_final, double lm_weight,
    double beam_threshold, int32_t max_active, const double* lex_la,
    int32_t la_exact,
    int32_t max_words, int32_t* out_words, int32_t* out_nw,
    int32_t* out_path, double* out_weight) {
  // LM lookahead — PRUNING key only (stored scores untouched, so the
  // decoded path/weight are unchanged; tight beams keep the tokens a
  // wide beam would).  Two modes:
  //   lex_la:  static per-trie-state potentials (may be null) —
  //            decode/otf.py lm_lookahead_potentials;
  //   la_exact: EXACT per-history lookahead — lazy per-LM-state tables
  //            la_u[s] = min over completions of the pending word of
  //            (remaining lexicon weights + actual advance(u, w)); the
  //            pruning key becomes the true best next-word-completed
  //            score (decode/otf.py _exact_lookahead twin).
  const double kFinite = -1e29;
  struct Token { int32_t l, lex, lm; double sc; int32_t parent, word; };

  // lexicon arcs CSR by SOURCE state: token expansion is ARC-driven
  // (iterate the trie state's few out-arcs, not all phones — a deep
  // trie state has 1-3 continuations vs 42 phones)
  std::vector<int32_t> lsrc_off(lx_ns + 1, 0);
  std::vector<int32_t> lsrc_arc(lx_na);
  for (int32_t j = 0; j < lx_na; ++j) ++lsrc_off[lx_src[j] + 1];
  for (size_t i = 1; i < lsrc_off.size(); ++i)
    lsrc_off[i] += lsrc_off[i - 1];
  {
    std::vector<int32_t> fill(lx_ns, 0);
    for (int32_t j = 0; j < lx_na; ++j)
      lsrc_arc[lsrc_off[lx_src[j]] + fill[lx_src[j]]++] = j;
  }

  // LM: word-arc index, epsilon adjacency, per-state epsilon closure and
  // closed finals; (state, word) advance memo
  const bool has_lm = lm_ns > 0;
  std::unordered_map<int64_t, std::vector<int32_t>> mi;
  std::vector<std::vector<std::pair<int32_t, float>>> eps_adj, closure;
  std::vector<double> lm_fin;
  if (has_lm) {
    mi.reserve(lm_na * 2);
    eps_adj.resize(lm_ns);
    for (int32_t j = 0; j < lm_na; ++j) {
      if (lm_il[j] == 0)
        eps_adj[lm_src[j]].push_back({lm_dst[j], lm_w[j]});
      else
        mi[(int64_t)lm_src[j] << 32 | (uint32_t)lm_il[j]].push_back(j);
    }
    closure.resize(lm_ns);
    lm_fin.assign(lm_ns, (double)kInf);
    std::vector<double> best(lm_ns);
    for (int32_t s = 0; s < lm_ns; ++s) {
      // Dijkstra-lite over the (tiny) epsilon subgraph
      std::vector<std::pair<int32_t, float>>& cl = closure[s];
      std::unordered_map<int32_t, double> b;
      std::deque<int32_t> q;
      b[s] = 0.0; q.push_back(s);
      while (!q.empty()) {
        int32_t u = q.front(); q.pop_front();
        double wu = b[u];
        for (auto& e : eps_adj[u]) {
          double nw = wu + e.second;
          auto it = b.find(e.first);
          if (it == b.end() || nw < it->second) {
            b[e.first] = nw; q.push_back(e.first);
          }
        }
      }
      for (auto& kv : b) {
        cl.push_back({kv.first, (float)kv.second});
        if (std::isfinite(lm_final[kv.first]))
          lm_fin[s] = std::min(lm_fin[s],
                               (kv.second + lm_final[kv.first]) * lm_weight);
      }
    }
  }
  std::unordered_map<int64_t, std::pair<int32_t, float>> adv_memo;
  auto lm_advance = [&](int32_t u, int32_t word,
                        int32_t* v, double* w) -> bool {
    int64_t key = (int64_t)u << 32 | (uint32_t)word;
    auto it = adv_memo.find(key);
    if (it == adv_memo.end()) {
      int32_t bv = -1; double bw = 0.0;
      for (auto& c : closure[u]) {
        auto jt = mi.find((int64_t)c.first << 32 | (uint32_t)word);
        if (jt == mi.end()) continue;
        for (int32_t j : jt->second) {
          double cw = c.second + lm_w[j];
          if (bv < 0 || cw < bw) { bv = lm_dst[j]; bw = cw; }
        }
      }
      it = adv_memo.emplace(key,
                            std::make_pair(bv, (float)bw)).first;
    }
    if (it->second.first < 0) return false;
    *v = it->second.first;
    *w = lm_weight * it->second.second;
    return true;
  };

  const int64_t lm_mod = has_lm ? lm_ns : 1;
  std::vector<std::vector<Token>> frames(T);
  // epoch-stamped flat recombination table: per-frame clear is a bump
  // of `slot_epoch`, lookups are linear probing on a power-of-2 array
  // (an unordered_map find+emplace per arc relaxation measured hot)
  struct SlotTab {
    std::vector<int64_t> keys;
    std::vector<int32_t> vals, epochs;
    size_t mask = 0; int32_t epoch = 0; size_t count = 0;
    void reset(size_t cap) {
      keys.assign(cap, 0); vals.assign(cap, 0); epochs.assign(cap, -1);
      mask = cap - 1; epoch = 0; count = 0;
    }
    void clear() { ++epoch; count = 0; }
    // returns slot index for key; *fresh = true when newly claimed
    size_t probe(int64_t k, bool* fresh) {
      if ((count + 1) * 2 >= keys.size()) grow();
      size_t i = (size_t)((uint64_t)k * 0x9E3779B97F4A7C15ull >> 17)
                 & mask;
      while (epochs[i] == epoch && keys[i] != k) i = (i + 1) & mask;
      *fresh = epochs[i] != epoch;
      if (*fresh) { epochs[i] = epoch; keys[i] = k; ++count; }
      return i;
    }
    void grow() {
      std::vector<int64_t> ok; std::vector<int32_t> ov, oe;
      ok.swap(keys); ov.swap(vals); oe.swap(epochs);
      keys.assign(ok.size() * 2, 0); vals.assign(ok.size() * 2, 0);
      epochs.assign(ok.size() * 2, -1);
      mask = keys.size() - 1;
      size_t n = count; count = 0;
      (void)n;
      for (size_t i = 0; i < ok.size(); ++i)
        if (oe[i] == epoch) {
          bool fresh;
          size_t ni = probe(ok[i], &fresh);
          vals[ni] = ov[i];
        }
    }
  };
  SlotTab slot;
  slot.reset(1 << 15);
  auto key_of = [&](int32_t l, int32_t lex, int32_t lm) {
    return ((int64_t)l * lx_ns + lex) * lm_mod + lm;
  };
  auto phone_of = [&](int32_t l) { return l / num_states + 1; };

  auto relax = [&](std::vector<Token>& cur, int32_t l, int32_t lex,
                   int32_t lm, double sc, int32_t parent, int32_t word) {
    int64_t k = key_of(l, lex, lm);
    bool fresh;
    size_t i = slot.probe(k, &fresh);
    if (fresh) {
      slot.vals[i] = (int32_t)cur.size();
      cur.push_back({l, lex, lm, sc, parent, word});
    } else if (sc < cur[slot.vals[i]].sc) {
      cur[slot.vals[i]] = {l, lex, lm, sc, parent, word};
    }
  };

  // ARC-driven expansion: for a token at trie state `lex`, take each
  // out-arc whose phone q differs from the token's current phone ph
  // (the frame-run collapser: q == ph continues the run instead), and
  // relax every expanded state of phone q.  Identical relaxation set
  // to the per-destination-label formulation, at out-degree(lex) * ns
  // iterations instead of L.
  auto expand_arcs = [&](std::vector<Token>& cur, int32_t lex,
                         int32_t lm, int32_t ph, const double* trow,
                         const double* st, double sc, int32_t parent) {
    for (int32_t ai = lsrc_off[lex]; ai < lsrc_off[lex + 1]; ++ai) {
      int32_t j = lsrc_arc[ai];
      int32_t q = lx_il[j];
      if (q == ph || q < 1 || q * num_states > L) continue;
      int32_t word = lx_ol[j];
      double s2 = sc + lx_w[j];
      int32_t lm2 = lm;
      if (word && has_lm) {
        double lw;
        if (!lm_advance(lm, word, &lm2, &lw)) continue;
        s2 += lw;
      }
      int32_t qp0 = (q - 1) * num_states;
      for (int32_t lp = qp0; lp < qp0 + num_states; ++lp) {
        double w = trow ? trow[lp] + st[lp] : st[lp];
        if (w < kFinite) continue;
        relax(cur, lp, lx_dst[j], lm2, s2 - w, parent, word);
      }
    }
  };

  // exact per-history lookahead machinery (la_exact mode), r5 redesign:
  // interval range-min queries instead of per-history table builds.
  //  - a DFS over the lexicon's NON-emitting arcs orders the
  //    word-emitting ("leaf") arcs so every trie state's reachable
  //    words form one contiguous leaf interval [la_lo[s], la_hi[s])
  //    (lexicon_fst emits a pure trie);
  //  - per LM state v, the explicit word arcs — expanded per
  //    pronunciation leaf, sorted by leaf index, value = lexicon
  //    root->leaf path cost + lm_weight * arc weight — carry a
  //    sparse-table RMQ (lev[k][i] = min over val[i .. i + 2^k));
  //  - la(u, s) = min over (v, cw) in eps-closure(u) of
  //    (lm_weight * cw + rangemin_v(lo[s], hi[s])) - pref[s].
  // Min commutes over closure paths, so this equals the recursive
  // definition exactly, at O(|closure| * log) per query with NO
  // per-history precompute (the lazy per-pair memo it replaces walked
  // a whole subtree on a root-adjacent miss — 0.24 utts/s vs 4.5
  // without lookahead at 5k words).  Falls back to the recursion when
  // the non-emitting arcs are not a tree.
  std::vector<std::vector<int32_t>> lex_out;
  std::unordered_map<int64_t, float> la_pair;
  const float kInfF = std::numeric_limits<float>::infinity();
  const bool use_exact = la_exact && has_lm;
  std::vector<float> la_pref;
  std::vector<int32_t> la_lo, la_hi, leaf_word;
  std::vector<float> leaf_cost;
  std::vector<std::vector<int32_t>> wleaf, lm_out;
  struct LaTable {
    std::vector<int32_t> pos;
    std::vector<std::vector<float>> lev;
    // for LARGE tables (the shared backoff/unigram state), the
    // range-min over a trie state's leaf interval is
    // history-independent — cache it per trie state (NaN = unset) so
    // the 15-iteration binary search over ~25k entries runs once per
    // (table, trie state) instead of once per (history, trie state)
    std::vector<float> smemo;
    bool built = false;
  };
  std::vector<LaTable> la_tab;
  bool la_tree_ok = false;
  if (use_exact) {
    lex_out.resize(lx_ns);
    for (int32_t j = 0; j < lx_na; ++j) lex_out[lx_src[j]].push_back(j);
    la_pair.reserve(1 << 16);
    // DFS over non-emitting arcs: pref, leaf order, [lo, hi) intervals
    la_pref.assign(lx_ns, 0.f);
    la_lo.assign(lx_ns, 0);
    la_hi.assign(lx_ns, 0);
    std::vector<char> seen(lx_ns, 0);
    seen[lx_start] = 1;
    la_tree_ok = true;
    int32_t max_word = 0;
    auto la_enter = [&](int32_t s) {
      la_lo[s] = (int32_t)leaf_word.size();
      for (int32_t j : lex_out[s])
        if (lx_ol[j]) {
          leaf_word.push_back(lx_ol[j]);
          leaf_cost.push_back(la_pref[s] + (float)lx_w[j]);
          max_word = std::max(max_word, lx_ol[j]);
        }
    };
    la_enter(lx_start);
    std::vector<std::pair<int32_t, size_t>> st{{lx_start, 0}};
    while (!st.empty() && la_tree_ok) {
      int32_t s = st.back().first;
      size_t& ci = st.back().second;
      const std::vector<int32_t>& out = lex_out[s];
      while (ci < out.size() && lx_ol[out[ci]]) ++ci;   // skip leaf arcs
      if (ci >= out.size()) {
        la_hi[s] = (int32_t)leaf_word.size();
        st.pop_back();
        continue;
      }
      int32_t j = out[ci++];
      int32_t d = lx_dst[j];
      if (seen[d]) { la_tree_ok = false; break; }
      seen[d] = 1;
      la_pref[d] = la_pref[s] + (float)lx_w[j];
      la_enter(d);
      st.push_back({d, 0});
    }
    if (la_tree_ok) {
      wleaf.resize(max_word + 1);
      for (int32_t e = 0; e < (int32_t)leaf_word.size(); ++e)
        wleaf[leaf_word[e]].push_back(e);
      lm_out.resize(lm_ns);
      for (int32_t j = 0; j < lm_na; ++j)
        if (lm_il[j]) lm_out[lm_src[j]].push_back(j);
      la_tab.resize(lm_ns);
    }
  }
  // global lower bound on la: key >= sc + la_floor lets prune skip the
  // RMQ for tokens provably outside the beam on raw score
  double la_floor = -kInf;
  if (use_exact && la_tree_ok && lm_weight >= 0) {
    double min_aw = 0.0, min_cw = 0.0, min_leafc = 0.0, max_pref = 0.0;
    bool any = false;
    for (int32_t j = 0; j < lm_na; ++j)
      if (lm_il[j]) {
        min_aw = any ? std::min(min_aw, (double)lm_w[j]) : (double)lm_w[j];
        any = true;
      }
    for (auto& cl : closure)
      for (auto& c : cl) min_cw = std::min(min_cw, (double)c.second);
    for (float c : leaf_cost) min_leafc = std::min(min_leafc, (double)c);
    for (float p : la_pref) max_pref = std::max(max_pref, (double)p);
    la_floor = std::min(0.0, lm_weight * (min_aw + min_cw)
                             + min_leafc - max_pref);
  }
  auto la_table_of = [&](int32_t v) -> LaTable& {
    LaTable& tb = la_tab[v];
    if (!tb.built) {
      std::vector<std::pair<int32_t, float>> ent;
      for (int32_t j : lm_out[v]) {
        int32_t wd = lm_il[j];
        if (wd < (int32_t)wleaf.size())
          for (int32_t e : wleaf[wd])
            ent.push_back({e, leaf_cost[e]
                              + (float)(lm_weight * lm_w[j])});
      }
      std::sort(ent.begin(), ent.end());
      size_t n = ent.size();
      tb.pos.resize(n);
      tb.lev.assign(1, std::vector<float>(n));
      for (size_t i = 0; i < n; ++i) {
        tb.pos[i] = ent[i].first;
        tb.lev[0][i] = ent[i].second;
      }
      for (size_t half = 1; half * 2 <= n; half <<= 1) {
        const std::vector<float>& p = tb.lev.back();
        std::vector<float> nx(p.size() - half);
        for (size_t i = 0; i < nx.size(); ++i)
          nx[i] = std::min(p[i], p[i + half]);
        tb.lev.push_back(std::move(nx));
      }
      if (n > 1024)
        tb.smemo.assign(lx_ns, std::numeric_limits<float>::quiet_NaN());
      tb.built = true;
    }
    return tb;
  };
  auto la_rangemin = [&](LaTable& tb, int32_t l, int32_t h) -> float {
    size_t a = std::lower_bound(tb.pos.begin(), tb.pos.end(), l)
               - tb.pos.begin();
    size_t b = std::lower_bound(tb.pos.begin(), tb.pos.end(), h)
               - tb.pos.begin();
    if (b <= a) return kInfF;
    int k = 31 - __builtin_clz((uint32_t)(b - a));
    return std::min(tb.lev[k][a], tb.lev[k][b - ((size_t)1 << k)]);
  };
  // recursive fallback (non-trie lexicons only)
  std::function<float(int32_t, int32_t)> la_rec =
      [&](int32_t u, int32_t s) -> float {
    if (s == lx_start) return 0.f;
    int64_t key = (int64_t)u << 32 | (uint32_t)s;
    auto it = la_pair.find(key);
    if (it != la_pair.end()) return it->second;
    double best = (double)kInfF;
    for (int32_t j : lex_out[s]) {
      int32_t d = lx_dst[j];
      double w = lx_w[j];
      int32_t ol = lx_ol[j];
      if (ol) {
        int32_t v; double aw;
        if (!lm_advance(u, ol, &v, &aw)) continue;
        w += aw;
      } else if (d != lx_start) {
        w += la_rec(u, d);
      }
      best = std::min(best, w);
    }
    la_pair.emplace(key, (float)best);
    return (float)best;
  };
  // flat open-addressing (u, s) -> la memo: the prune loop's hot path
  // is a memo HIT, and unordered_map::find measured ~5x the cost of a
  // linear-probed power-of-2 table on 64-bit keys
  struct FlatMemo {
    std::vector<int64_t> keys;   // -1 = empty ((u, s) keys are >= 0)
    std::vector<float> vals;
    size_t mask = 0, count = 0;
    void reset(size_t cap) {
      keys.assign(cap, -1); vals.assign(cap, 0.f);
      mask = cap - 1; count = 0;
    }
    static size_t hash(int64_t k) {
      return (size_t)((uint64_t)k * 0x9E3779B97F4A7C15ull >> 17);
    }
    bool get(int64_t k, float* out) const {
      size_t i = hash(k) & mask;
      while (keys[i] != -1) {
        if (keys[i] == k) { *out = vals[i]; return true; }
        i = (i + 1) & mask;
      }
      return false;
    }
    void put(int64_t k, float v) {
      if ((count + 1) * 2 >= keys.size()) grow();
      size_t i = hash(k) & mask;
      while (keys[i] != -1) {
        if (keys[i] == k) { vals[i] = v; return; }
        i = (i + 1) & mask;
      }
      keys[i] = k; vals[i] = v; ++count;
    }
    void grow() {
      std::vector<int64_t> ok; std::vector<float> ov;
      ok.swap(keys); ov.swap(vals);
      keys.assign(ok.size() * 2, -1); vals.assign(ok.size() * 2, 0.f);
      mask = keys.size() - 1; count = 0;
      for (size_t i = 0; i < ok.size(); ++i)
        if (ok[i] != -1) put(ok[i], ov[i]);
    }
  };
  FlatMemo la_memo;
  if (use_exact && la_tree_ok) la_memo.reset(1 << 16);
  auto la_of = [&](int32_t u, int32_t s) -> float {
    if (s == lx_start) return 0.f;
    if (!la_tree_ok) return la_rec(u, s);
    int64_t key = (int64_t)u << 32 | (uint32_t)s;
    float v;
    if (la_memo.get(key, &v)) return v;
    int32_t l = la_lo[s], h = la_hi[s];
    float best = kInfF;
    for (auto& c : closure[u]) {
      LaTable& tb = la_table_of(c.first);
      float m;
      if (!tb.smemo.empty()) {
        m = tb.smemo[s];
        if (std::isnan(m)) { m = la_rangemin(tb, l, h); tb.smemo[s] = m; }
      } else {
        m = la_rangemin(tb, l, h);
      }
      float cand = (float)(lm_weight * c.second) + m;
      if (cand < best) best = cand;
    }
    best -= la_pref[s];
    la_memo.put(key, best);
    return best;
  };
  auto prune_key = [&](const Token& t) -> double {
    if (use_exact) return t.sc + la_of(t.lm, t.lex);
    return lex_la ? t.sc + lex_la[t.lex] : t.sc;
  };
  auto prune = [&](std::vector<Token>& cur) {
    if (cur.empty()) return;
    // keys computed ONCE per token (prune_key may carry an RMQ)
    std::vector<std::pair<double, Token>> kt;
    kt.reserve(cur.size());
    if (use_exact && beam_threshold >= 0 && std::isfinite(la_floor)
        && cur.size() > 8) {
      // lazy two-pass: la >= la_floor, so key >= sc + la_floor.  Seed
      // the bound with the key of the min-sc token (k0 >= the true
      // best key), then skip the lookahead entirely for tokens
      // provably outside the beam on raw score — exact.
      size_t i0 = 0;
      for (size_t i = 1; i < cur.size(); ++i)
        if (cur[i].sc < cur[i0].sc) i0 = i;
      double k0 = prune_key(cur[i0]);
      double lim = k0 + beam_threshold;
      double best = k0;
      for (const Token& t : cur) {
        if (t.sc + la_floor > lim) continue;
        double k = prune_key(t);
        if (k < best) best = k;
        kt.push_back({k, t});
      }
      double cut = best + beam_threshold;
      std::vector<std::pair<double, Token>> kept;
      kept.reserve(kt.size());
      for (auto& p : kt)
        if (p.first <= cut) kept.push_back(p);
      kt.swap(kept);
    } else {
      for (const Token& t : cur) kt.push_back({prune_key(t), t});
      if (beam_threshold >= 0) {
        double best = kt[0].first;
        for (auto& p : kt) best = std::min(best, p.first);
        std::vector<std::pair<double, Token>> kept;
        kept.reserve(kt.size());
        for (auto& p : kt)
          if (p.first <= best + beam_threshold) kept.push_back(p);
        kt.swap(kept);
      }
    }
    if (max_active > 0 && (int32_t)kt.size() > max_active) {
      std::nth_element(kt.begin(), kt.begin() + max_active - 1, kt.end(),
                       [](const std::pair<double, Token>& a,
                          const std::pair<double, Token>& b) {
                         return a.first < b.first;
                       });
      kt.resize(max_active);
    }
    cur.clear();
    for (auto& p : kt) cur.push_back(p.second);
  };

  slot.clear();
  const int32_t lm0 = has_lm ? lm_start : 0;
  // frame 0: every arc out of the trie root (ph sentinel 0 = nothing
  // is "same phone"), scored by the frame-0 state potentials
  expand_arcs(frames[0], lx_start, lm0, 0, nullptr, state, 0.0, -1);
  prune(frames[0]);

  for (int32_t t = 1; t < T; ++t) {
    const double* st = state + (int64_t)t * L;
    const double* tr = trans_frame_dep ? trans + (int64_t)t * L * L : trans;
    slot.clear();
    std::vector<Token>& prev = frames[t - 1];
    for (int32_t eid = 0; eid < (int32_t)prev.size(); ++eid) {
      const Token tok = prev[eid];
      const double* trow = tr + (int64_t)tok.l * L;
      int32_t ph = phone_of(tok.l);
      int32_t lp0 = (ph - 1) * num_states;
      for (int32_t lp = lp0; lp < lp0 + num_states; ++lp) {
        double w = trow[lp] + st[lp];              // run continues
        if (w < kFinite) continue;
        relax(frames[t], lp, tok.lex, tok.lm, tok.sc - w, eid, 0);
      }
      expand_arcs(frames[t], tok.lex, tok.lm, ph, trow, st, tok.sc, eid);
    }
    prune(frames[t]);
  }

  double best = kInf;
  int32_t best_eid = -1;
  for (int32_t eid = 0; eid < (int32_t)frames[T - 1].size(); ++eid) {
    const Token& t = frames[T - 1][eid];
    if (!std::isfinite(lx_final[t.lex])) continue;
    double tot = t.sc + lx_final[t.lex];
    if (has_lm) {
      if (!std::isfinite(lm_fin[t.lm])) continue;
      tot += lm_fin[t.lm];
    }
    if (tot < best) { best = tot; best_eid = eid; }
  }
  if (best_eid < 0) return 2;

  std::vector<int32_t> words_rev;
  int32_t eid = best_eid;
  for (int32_t t = T - 1; t >= 0; --t) {
    const Token& tok = frames[t][eid];
    out_path[t] = tok.l;
    if (tok.word) words_rev.push_back(tok.word);
    eid = tok.parent;
  }
  if ((int32_t)words_rev.size() > max_words) return 3;
  *out_nw = (int32_t)words_rev.size();
  for (size_t k = 0; k < words_rev.size(); ++k)
    out_words[k] = words_rev[words_rev.size() - 1 - k];
  *out_weight = best;
  return 0;
}

}  // extern "C"

