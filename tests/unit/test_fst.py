"""FST lattice building, composition, shortest path, word decode."""
import numpy as np
import pytest

from asr_craft.decode import fst as F
from asr_craft.ops import oracle


def test_linear_acceptor_shortest_path():
    f = F.linear_acceptor([3, 1, 2], [0.5, 0.25, 0.25])
    ilabs, olabs, w = F.shortest_path(f)
    assert ilabs == [3, 1, 2] and olabs == [3, 1, 2]
    np.testing.assert_allclose(w, 1.0)


def test_lattice_shortest_path_equals_viterbi(rng):
    """Lattice-FST best path == dense Viterbi (the reference's
    LatticeBuilder + ShortestPath must agree with the decoder)."""
    T, L = 9, 4
    state = rng.normal(size=(T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    lat = F.lattice_fst(state, trans, T)
    ilabs, _, w = F.shortest_path(lat)
    ref_path, ref_score = oracle.viterbi_np(state, trans, T)
    assert [x - 1 for x in ilabs] == ref_path
    np.testing.assert_allclose(-w, ref_score, rtol=1e-5)


def test_lattice_pruning_keeps_best(rng):
    T, L = 8, 5
    state = rng.normal(size=(T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    lat_full = F.lattice_fst(state, trans, T)
    lat_pruned = F.lattice_fst(state, trans, T, prune_margin=50.0)
    _, _, w1 = F.shortest_path(lat_full)
    _, _, w2 = F.shortest_path(lat_pruned)
    np.testing.assert_allclose(w1, w2, rtol=1e-6)
    assert lat_pruned.num_arcs <= lat_full.num_arcs


def test_lexicon_compose_decodes_words(rng):
    # phones: 0=a 1=b 2=c; words: "ab" = [0,1], "c" = [2], "ba" = [1,0]
    words = ["ab", "c", "ba"]
    lexicon = {"ab": [0, 1], "c": [2], "ba": [1, 0]}
    # an utterance whose best phone path is a b c b a
    T, L = 5, 3
    state = np.full((T, L), -5.0, np.float32)
    for t, p in enumerate([0, 1, 2, 1, 0]):
        state[t, p] = 0.0
    trans = np.zeros((L, L), np.float32)
    wseq, phones, wgt = F.decode_words(state, trans, T, lexicon, words)
    assert wseq == ["ab", "c", "ba"]
    assert phones == [0, 1, 2, 1, 0]


def test_collapser_multiframe_phones():
    """Phones spanning several frames must still match the loop-free
    lexicon trie (frame lattice o collapser o lexicon)."""
    words = ["ab", "c"]
    lexicon = {"ab": [0, 1], "c": [2]}
    frames = [0, 0, 0, 1, 1, 2, 2, 2]
    T, L = len(frames), 3
    state = np.full((T, L), -5.0, np.float32)
    for t, p in enumerate(frames):
        state[t, p] = 0.0
    trans = np.zeros((L, L), np.float32)
    wseq, path, _ = F.decode_words(state, trans, T, lexicon, words)
    assert wseq == ["ab", "c"]
    assert path == frames


def test_word_decode_nstate():
    """Word decode over an expanded n-state topology: lattice input labels
    are expanded states, output labels are phones."""
    from asr_craft.models.topology import Topology
    topo = Topology(3, 2)  # 3 phones x 2 states
    trans = topo.transition_penalty().astype(np.float32)
    # expanded-state path 0 1 1 2 3 4 5 5 = phones a a a b b c c c
    path = [0, 1, 1, 2, 3, 4, 5, 5]
    T, Lx = len(path), topo.num_expanded
    state = np.full((T, Lx), -5.0, np.float32)
    for t, s in enumerate(path):
        state[t, s] = 0.0
    words = ["ab", "c"]
    lexicon = {"ab": [0, 1], "c": [2]}
    wseq, spath, _ = F.decode_words(state, trans, T, lexicon, words,
                                    num_states=2)
    assert wseq == ["ab", "c"]
    assert spath == path


def test_read_lexicon(tmp_path):
    p = tmp_path / "lex.txt"
    p.write_text("# comment\nfoo 0 2\nbar 1\n")
    lex, words = F.read_lexicon(p)
    assert words == ["foo", "bar"]
    assert lex == {"foo": [0, 2], "bar": [1]}
    p2 = tmp_path / "named.txt"
    p2.write_text("foo a c\n")
    lex2, _ = F.read_lexicon(p2, {"a": 0, "b": 1, "c": 2})
    assert lex2 == {"foo": [0, 2]}
    p3 = tmp_path / "dup.txt"
    p3.write_text("foo 0\nfoo 1\n")
    with pytest.raises(ValueError):
        F.read_lexicon(p3)


def test_lattice_frame_dependent_trans(rng):
    """(T, L, L) per-frame transition potentials in the lattice."""
    T, L = 7, 4
    state = rng.normal(size=(T, L)).astype(np.float32)
    trans = rng.normal(size=(T, L, L)).astype(np.float32)
    lat = F.lattice_fst(state, trans, T)
    ilabs, _, w = F.shortest_path(lat)
    best = -np.inf
    import itertools
    for p in itertools.product(range(L), repeat=T):
        s = state[0, p[0]] + sum(
            state[t, p[t]] + trans[t, p[t - 1], p[t]] for t in range(1, T))
        best = max(best, s)
    np.testing.assert_allclose(-w, best, rtol=1e-5)


def test_lm_changes_word_choice():
    """Homophone-style ambiguity resolved by the LM."""
    words = ["x", "y"]
    lexicon = {"x": [0], "y": [0]}  # same pronunciation
    state = np.zeros((1, 1), np.float32)
    trans = np.zeros((1, 1), np.float32)
    # LM strongly prefers y
    logp = np.log(np.full((2, 2), 0.5))
    lm = F.bigram_lm_fst(2, logp, np.log([0.01, 0.99]), np.log([0.5, 0.5]))
    wseq, _, _ = F.decode_words(state, trans, 1, lexicon, words, lm=lm)
    assert wseq == ["y"]
    lm2 = F.bigram_lm_fst(2, logp, np.log([0.99, 0.01]), np.log([0.5, 0.5]))
    wseq2, _, _ = F.decode_words(state, trans, 1, lexicon, words, lm=lm2)
    assert wseq2 == ["x"]


def test_compose_rejects_input_epsilon_right():
    a = F.linear_acceptor([1])
    b = F.Fst.from_arcs(2, 0, [(0, 1, 0, 1, 0.0)], {1: 0.0})
    with pytest.raises(ValueError):
        F.compose(a, b)


def test_shortest_path_no_accepting_path():
    f = F.Fst.from_arcs(2, 0, [(0, 1, 1, 1, 0.0)], {})
    with pytest.raises(ValueError):
        F.shortest_path(f)


def test_cycle_detection():
    f = F.Fst.from_arcs(2, 0, [(0, 1, 1, 1, 0.0), (1, 0, 1, 1, 0.0)],
                        {1: 0.0})
    with pytest.raises(ValueError):
        F.shortest_path(f)


def test_nbest_paths(rng):
    T, L = 6, 3
    state = rng.normal(size=(T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    lat = F.lattice_fst(state, trans, T)
    nbest = F.shortest_paths_n(lat, 5)
    assert len(nbest) == 5
    # best of n-best == 1-best
    i1, o1, w1 = F.shortest_path(lat)
    assert nbest[0][0] == i1
    np.testing.assert_allclose(nbest[0][2], w1, rtol=1e-6)
    # weights non-decreasing, paths distinct
    ws = [w for _, _, w in nbest]
    assert ws == sorted(ws)
    assert len({tuple(p) for p, _, _ in nbest}) == 5
    # exhaustive check against enumerating all L**T paths
    from asr_craft.ops import oracle
    import itertools
    scores = sorted(
        -oracle.path_score_np(state, trans, list(p), T)
        for p in itertools.product(range(L), repeat=T))
    np.testing.assert_allclose(ws, scores[:5], rtol=1e-5)


def test_nbest_fewer_paths_than_n():
    f = F.linear_acceptor([1, 2])
    nbest = F.shortest_paths_n(f, 10)
    assert len(nbest) == 1


def test_fst_text_roundtrip(tmp_path, rng):
    T, L = 5, 3
    state = rng.normal(size=(T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    lat = F.lattice_fst(state, trans, T)
    p = tmp_path / "lat.fst.txt"
    F.write_fst_text(lat, p)
    back = F.read_fst_text(p)
    i1, o1, w1 = F.shortest_path(lat)
    i2, o2, w2 = F.shortest_path(back)
    assert i1 == i2 and o1 == o2
    np.testing.assert_allclose(w1, w2, rtol=1e-5)
