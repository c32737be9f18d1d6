"""On-the-fly FST-composed beam Viterbi (decode.otf) vs the offline
composed-lattice decoder (decode.fst.decode_words): exact with no beam,
sane under pruning, identical across py/native backends."""
import numpy as np
import pytest

from asr_craft.decode import fst as F
from asr_craft.decode.otf import build_search_graph, otf_decode_words

LEX = {"ab": [0, 1], "ba": [1, 0], "cc": [2, 2], "abc": [0, 1, 2]}
WORDS = list(LEX)


def _problem(rng, T=12, L=3, num_states=1, scale=2.0):
    Lx = L * num_states
    state = rng.normal(size=(T, Lx)).astype(np.float64) * scale
    trans = rng.normal(size=(Lx, Lx)).astype(np.float64) * 0.3
    if num_states > 1:
        from asr_craft.models.topology import Topology
        trans = trans + np.asarray(
            Topology(L, num_states).transition_penalty())
    return state, trans


@pytest.mark.parametrize("num_states", [1, 2])
def test_otf_exact_matches_offline(rng, num_states):
    state, trans = _problem(rng, num_states=num_states)
    g = build_search_graph(LEX, WORDS)
    for trial in range(3):
        st = state + rng.normal(size=state.shape)
        w_ref, path_ref, wt_ref = F.decode_words(
            st, trans, len(st), LEX, WORDS, num_states=num_states,
            backend="py")
        w_otf, path_otf, wt_otf = otf_decode_words(
            st, trans, len(st), g, WORDS, num_states=num_states,
            backend="py")
        assert w_otf == w_ref
        assert path_otf == path_ref
        np.testing.assert_allclose(wt_otf, wt_ref, rtol=1e-5)


def test_otf_with_lm(rng):
    state, trans = _problem(rng)
    n = len(WORDS)
    logp = np.log(np.full((n, n), 1.0 / n))
    logp[0] = np.log(np.asarray([0.7, 0.1, 0.1, 0.1]))
    lm = F.bigram_lm_fst(n, logp, np.full(n, np.log(1 / n)),
                         np.full(n, -0.1))
    g = build_search_graph(LEX, WORDS, lm=lm, lm_weight=2.0)
    w_ref, _, wt_ref = F.decode_words(state, trans, len(state), LEX, WORDS,
                                      lm=lm, lm_weight=2.0, backend="py")
    w_otf, _, wt_otf = otf_decode_words(state, trans, len(state), g, WORDS,
                                        backend="py")
    assert w_otf == w_ref
    np.testing.assert_allclose(wt_otf, wt_ref, rtol=1e-5)


def test_otf_beam_pruning(rng):
    state, trans = _problem(rng)
    g = build_search_graph(LEX, WORDS)
    _, _, wt_exact = otf_decode_words(state, trans, len(state), g, WORDS,
                                      backend="py")
    prev = np.inf
    for thr in (0.5, 2.0, 20.0):
        try:
            _, _, wt = otf_decode_words(state, trans, len(state), g, WORDS,
                                        beam_threshold=thr, backend="py")
        except ValueError:
            # over-narrow beam may prune every accepting hypothesis —
            # the reference's failed-utterance case
            assert thr < 20.0
            continue
        assert wt >= wt_exact - 1e-6           # beam can only lose paths
        assert wt <= prev + 1e-6               # wider beam only improves
        prev = wt
    _, _, wt_wide = otf_decode_words(state, trans, len(state), g, WORDS,
                                     beam_threshold=1e9, backend="py")
    np.testing.assert_allclose(wt_wide, wt_exact, rtol=1e-6)
    # max-active pruning: a moderate active set still decodes end-to-end
    w1, path1, _ = otf_decode_words(state, trans, len(state), g, WORDS,
                                    max_active=8, backend="py")
    assert len(path1) == len(state)


def test_otf_no_hypothesis_raises(rng):
    state, trans = _problem(rng, T=1)   # single frame: no 2-phone word fits
    g = build_search_graph({"ab": [0, 1]}, ["ab"])
    with pytest.raises(ValueError):
        otf_decode_words(state, trans, 1, g, ["ab"], backend="py")


def test_otf_native_matches_py(rng):
    from asr_craft.decode import fst_native
    if not (fst_native.available() and hasattr(fst_native, "otf_decode")):
        pytest.skip("native backend not built")
    state, trans = _problem(rng, T=15)
    g = build_search_graph(LEX, WORDS)
    for kw in ({}, {"beam_threshold": 3.0}, {"max_active": 4},
               {"beam_threshold": 5.0, "max_active": 8}):
        w_py, p_py, wt_py = otf_decode_words(state, trans, len(state), g,
                                             WORDS, backend="py", **kw)
        w_nat, p_nat, wt_nat = otf_decode_words(state, trans, len(state), g,
                                                WORDS, backend="native",
                                                **kw)
        assert w_nat == w_py, kw
        assert p_nat == p_py, kw
        np.testing.assert_allclose(wt_nat, wt_py, rtol=1e-5)


# ---------------------------------------------------------------------------
# dynamic composition (r4: WSJ-scale path)
# ---------------------------------------------------------------------------

def _lex_fst():
    return F.lexicon_fst(LEX, WORDS)


def test_otf_dynamic_exact_matches_static(rng):
    """No LM, no beam: the dynamic-composition decoder equals the static
    pre-composed search graph (and hence the offline composed path)."""
    from asr_craft.decode.otf import otf_decode_words_dynamic

    state, trans = _problem(rng)
    g = build_search_graph(LEX, WORDS)
    lex = _lex_fst()
    for trial in range(3):
        st = state + rng.normal(size=state.shape)
        w_ref, p_ref, wt_ref = otf_decode_words(st, trans, len(st), g,
                                                WORDS, backend="py")
        w_dyn, p_dyn, wt_dyn = otf_decode_words_dynamic(
            st, trans, len(st), lex, WORDS, backend="py")
        assert w_dyn == w_ref
        assert p_dyn == p_ref
        np.testing.assert_allclose(wt_dyn, wt_ref, rtol=1e-5)


def test_otf_dynamic_with_dense_lm(rng):
    """Dense bigram LM: dynamic == static composed graph."""
    from asr_craft.decode.otf import otf_decode_words_dynamic

    state, trans = _problem(rng)
    n = len(WORDS)
    logp = np.log(np.full((n, n), 1.0 / n))
    logp[0] = np.log(np.asarray([0.7, 0.1, 0.1, 0.1]))
    lm = F.bigram_lm_fst(n, logp, np.full(n, np.log(1 / n)),
                         np.full(n, -0.1))
    g = build_search_graph(LEX, WORDS, lm=lm, lm_weight=2.0)
    w_ref, _, wt_ref = otf_decode_words(state, trans, len(state), g,
                                        WORDS, backend="py")
    w_dyn, _, wt_dyn = otf_decode_words_dynamic(
        state, trans, len(state), _lex_fst(), WORDS, lm=lm, lm_weight=2.0,
        backend="py")
    assert w_dyn == w_ref
    np.testing.assert_allclose(wt_dyn, wt_ref, rtol=1e-5)


def _backoff_lm():
    """Tiny pruned backoff bigram: only some bigrams seen."""
    n = len(WORDS)
    bigrams = {(-1, 0): np.log(0.6), (0, 1): np.log(0.5),
               (1, 2): np.log(0.4), (2, 0): np.log(0.5)}
    alpha = {-1: np.log(0.4), 0: np.log(0.5), 1: np.log(0.6),
             2: np.log(0.5), 3: np.log(1.0)}
    logp_uni = np.log(np.full(n, 1.0 / n))
    logp_final = {u: np.log(0.2) for u in range(-1, n)}
    return F.backoff_bigram_lm_fst(n, bigrams, logp_uni, alpha, logp_final)


def test_backoff_lm_eps_closure_and_removal(rng):
    """remove_input_epsilons(backoff LM) is input-eps-free and tropically
    equivalent on word sequences (checked by scoring strings)."""
    lm = _backoff_lm()
    dense = F.remove_input_epsilons(lm)
    assert not any(int(i) == 0 for i in dense.ilabel)
    # score a few word strings through both (tropical: min path weight)
    for seq in ([1, 2, 3], [2, 2], [4, 1], [3]):
        acc = F.linear_acceptor(seq)
        w1 = F.shortest_path(F.compose(acc, dense))[2]
        # brute force through the eps-ful original via closure math
        clos = F.eps_closure(lm)
        cur = {lm.start: 0.0}
        for lab in seq:
            nxt = {}
            for s, w in cur.items():
                for s2, w2 in clos[s]:
                    for j in range(lm.num_arcs):
                        if int(lm.src[j]) == s2 and int(lm.ilabel[j]) == lab:
                            d = int(lm.dst[j])
                            nw = w + w2 + float(lm.weight[j])
                            if nw < nxt.get(d, np.inf):
                                nxt[d] = nw
            cur = nxt
        best = np.inf
        for s, w in cur.items():
            for s2, w2 in F.eps_closure(lm)[s]:
                f = float(lm.final[s2])
                if np.isfinite(f):
                    best = min(best, w + w2 + f)
        np.testing.assert_allclose(w1, best, rtol=1e-6)


def test_otf_dynamic_backoff_lm_matches_densified(rng):
    """Pruned backoff LM through the dynamic decoder == the static path on
    the epsilon-removed (densified) equivalent."""
    from asr_craft.decode.otf import otf_decode_words_dynamic

    state, trans = _problem(rng, T=14)
    lm = _backoff_lm()
    dense = F.remove_input_epsilons(lm)
    g = build_search_graph(LEX, WORDS, lm=dense, lm_weight=1.5)
    w_ref, _, wt_ref = otf_decode_words(state, trans, len(state), g,
                                        WORDS, backend="py")
    w_dyn, _, wt_dyn = otf_decode_words_dynamic(
        state, trans, len(state), _lex_fst(), WORDS, lm=lm, lm_weight=1.5,
        backend="py")
    assert w_dyn == w_ref
    np.testing.assert_allclose(wt_dyn, wt_ref, rtol=1e-5)


def test_otf_dynamic_native_matches_py(rng):
    from asr_craft.decode import fst_native
    from asr_craft.decode.otf import otf_decode_words_dynamic

    if not fst_native.available():
        pytest.skip("native backend not built")
    state, trans = _problem(rng, T=16)
    lm = _backoff_lm()
    lex = _lex_fst()
    for kw in (dict(), dict(lm=lm, lm_weight=1.5),
               dict(lm=lm, beam_threshold=6.0, max_active=8)):
        w_py, p_py, wt_py = otf_decode_words_dynamic(
            state, trans, len(state), lex, WORDS, backend="py", **kw)
        w_nat, p_nat, wt_nat = fst_native.otf_decode_dynamic(
            state, trans, len(state), lex, WORDS, **kw)
        assert w_nat == w_py, kw
        assert p_nat == p_py, kw
        np.testing.assert_allclose(wt_nat, wt_py, rtol=1e-5)

def test_lm_lookahead_exactness_and_potentials(rng):
    """LM lookahead (VERDICT r4 next #2): phi[root] = 0; with NO beam the
    decode is exact (identical words/path/weight, lookahead on or off);
    and with lookahead the pruned-native and pruned-py paths agree."""
    from asr_craft.decode import fst_native
    from asr_craft.decode.otf import (lm_lookahead_potentials,
                                      otf_decode_words_dynamic)

    state, trans = _problem(rng, T=16)
    lm = _backoff_lm()
    lex = _lex_fst()
    phi = lm_lookahead_potentials(lex, lm, 1.5)
    assert phi[lex.start] == 0.0
    assert np.isfinite(phi[np.arange(lex.num_states) != lex.start]).all()

    w_on, p_on, wt_on = otf_decode_words_dynamic(
        state, trans, len(state), lex, WORDS, lm=lm, lm_weight=1.5,
        backend="py", lookahead=True)
    w_off, p_off, wt_off = otf_decode_words_dynamic(
        state, trans, len(state), lex, WORDS, lm=lm, lm_weight=1.5,
        backend="py", lookahead=False)
    assert w_on == w_off and p_on == p_off
    np.testing.assert_allclose(wt_on, wt_off, rtol=1e-9)

    if fst_native.available():
        # exact per-history mode (lookahead=True) AND static-potentials
        # mode (ndarray): py == native under pruning in both
        for la in (True, lm_lookahead_potentials(lex, lm, 1.5)):
            for kw in (dict(beam_threshold=6.0, max_active=8),
                       dict(max_active=4)):
                w_py, p_py, wt_py = otf_decode_words_dynamic(
                    state, trans, len(state), lex, WORDS, lm=lm,
                    lm_weight=1.5, backend="py", lookahead=la, **kw)
                w_nat, p_nat, wt_nat = fst_native.otf_decode_dynamic(
                    state, trans, len(state), lex, WORDS, lm=lm,
                    lm_weight=1.5, lookahead=la, **kw)
                assert w_nat == w_py, kw
                assert p_nat == p_py, kw
                np.testing.assert_allclose(wt_nat, wt_py, rtol=1e-5)


def test_lm_lookahead_rescues_tight_beam():
    """A constructed case where the acoustically-attractive word is
    LM-forbidden: with max_active=1 the plain beam commits to it and
    dies (or errs); the lookahead charges the LM cost inside the trie
    and keeps the survivable token."""
    from asr_craft.decode.otf import otf_decode_words_dynamic

    words = ["ax", "by"]
    lexicon = {"ax": [0, 2], "by": [1, 3]}
    lex = F.lexicon_fst(lexicon, words)
    n = 2
    # LM: "ax" (word 1) is near-impossible everywhere, "by" likely
    logp = np.log(np.asarray([[1e-12, 1 - 1e-12]] * 2))
    lm = F.bigram_lm_fst(n, logp,
                         np.log(np.asarray([1e-12, 1.0 - 1e-12])),
                         np.zeros(n))
    # acoustics slightly prefer the "ax" branch at every frame
    state = np.asarray([[0.5, 0.4, -9.0, -9.0],
                        [0.5, 0.4, -9.0, -9.0],
                        [-9.0, -9.0, 0.3, 0.2]], np.float64)
    trans = np.zeros((4, 4))
    kw = dict(lm=lm, lm_weight=1.0, max_active=1, backend="py")
    w_la, _, _ = otf_decode_words_dynamic(
        state, trans, 3, lex, words, lookahead=True, **kw)
    assert w_la == ["by"]
    # the exact decode also picks "by" (the LM dominates), so keeping
    # the acoustically-best token is a pure search error
    w_exact, _, _ = otf_decode_words_dynamic(
        state, trans, 3, lex, words, lm=lm, lm_weight=1.0, backend="py")
    assert w_exact == ["by"]
    try:
        w_no, _, _ = otf_decode_words_dynamic(
            state, trans, 3, lex, words, lookahead=False, **kw)
    except ValueError:
        w_no = None                    # beam died: also a search error
    assert w_no != ["by"]


def test_exact_lookahead_rmq_equals_recursion(rng):
    """The r5 interval/RMQ exact lookahead (leaf-interval DFS +
    per-LM-state sparse-table range-min, decode/otf._exact_lookahead)
    equals the recursive per-(history, state) definition
    (_exact_lookahead_lazy) on every (LM state, trie state) pair — on a
    WEIGHTED trie (random arc weights exercise the pref/path-cost
    bookkeeping that lexicon_fst's zero weights would hide) with a
    pruned backoff LM whose epsilon closure has multi-state paths."""
    import dataclasses

    from asr_craft.decode.otf import (_exact_lookahead,
                                      _exact_lookahead_lazy,
                                      _lm_closed)

    lexicon = {"ab": [0, 1], "ba": [1, 0], "cc": [2, 2],
               "abc": [0, 1, 2], "abca": [0, 1, 2, 0], "c": [2]}
    words = list(lexicon)
    lex0 = F.lexicon_fst(lexicon, words)
    lm = _backoff_lm_n(len(words))
    for lm_weight in (1.0, 1.7):
        for trial in range(3):
            w = rng.uniform(0.0, 2.0, size=lex0.num_arcs)
            lex = dataclasses.replace(lex0, weight=w)
            fast = _exact_lookahead(lex, lm, lm_weight)
            lm_adv, _ = _lm_closed(lm, lm_weight)
            slow = _exact_lookahead_lazy(lex, lm_adv)
            for u in range(lm.num_states):
                for s in range(lex.num_states):
                    a = fast((0, s, u))
                    b = slow((0, s, u))
                    if np.isinf(b):
                        assert np.isinf(a), (u, s)
                    else:
                        np.testing.assert_allclose(a, b, rtol=1e-9,
                                                   err_msg=f"{(u, s)}")


def _backoff_lm_n(n):
    """Pruned backoff bigram over n words (some bigrams seen)."""
    bigrams = {(-1, 0): np.log(0.6), (0, 1): np.log(0.5),
               (1, 2): np.log(0.4), (2, 0): np.log(0.5),
               (3, 1): np.log(0.3)}
    alpha = {u: np.log(0.5) for u in range(-1, n)}
    logp_uni = np.log(np.full(n, 1.0 / n))
    logp_final = {u: np.log(0.2) for u in range(-1, n)}
    return F.backoff_bigram_lm_fst(n, bigrams, logp_uni, alpha, logp_final)


def test_exact_lookahead_native_parity_under_pruning(rng):
    """py RMQ lookahead == native RMQ lookahead: pruned decodes agree on
    a 6-word lexicon with a pruned backoff LM across beams (the native
    twin builds its tables in C++ — same interval/RMQ design)."""
    from asr_craft.decode import fst_native
    from asr_craft.decode.otf import otf_decode_words_dynamic

    if not fst_native.available():
        pytest.skip("native fst backend not built")
    lexicon = {"ab": [0, 1], "ba": [1, 0], "cc": [2, 2],
               "abc": [0, 1, 2], "abca": [0, 1, 2, 0], "c": [2]}
    words = list(lexicon)
    lex = F.lexicon_fst(lexicon, words)
    lm = _backoff_lm_n(len(words))
    state, trans = _problem(rng, T=16)
    for kw in (dict(beam_threshold=6.0, max_active=8),
               dict(max_active=3), dict(beam_threshold=4.0)):
        w_py, p_py, wt_py = otf_decode_words_dynamic(
            state, trans, len(state), lex, words, lm=lm, lm_weight=1.5,
            backend="py", lookahead=True, **kw)
        w_nat, p_nat, wt_nat = fst_native.otf_decode_dynamic(
            state, trans, len(state), lex, words, lm=lm, lm_weight=1.5,
            lookahead=True, **kw)
        assert w_nat == w_py, kw
        assert p_nat == p_py, kw
        np.testing.assert_allclose(wt_nat, wt_py, rtol=1e-5)
