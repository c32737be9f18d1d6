"""Native C++ backends vs the Python reference implementations."""
import numpy as np
import pytest

from asr_craft import data
from asr_craft.decode import fst as F

def _native_fst():
    from asr_craft.decode import fst_native
    if not fst_native.available():
        pytest.skip("native fst backend unavailable (no toolchain)")
    return fst_native


def _random_fst(rng, ns, na, nlabels, acyclic=True):
    src = rng.integers(0, ns - 1, size=na)
    if acyclic:
        dst = (src + 1 + rng.integers(0, np.maximum(ns - src - 1, 1))).clip(
            0, ns - 1)
        dst = np.maximum(dst, src + 1)
    else:
        dst = rng.integers(0, ns, size=na)
    il = rng.integers(1, nlabels + 1, size=na)
    ol = rng.integers(0, nlabels + 1, size=na)   # may contain output eps
    w = rng.normal(size=na)
    finals = {ns - 1: 0.0}
    return F.Fst.from_arcs(ns, 0, list(zip(src, dst, il, ol, w)), finals)


def test_native_compose_matches_python(rng):
    native = _native_fst()
    for trial in range(5):
        a = _random_fst(rng, 12, 40, 4)
        # B: input-eps-free transducer
        b = _random_fst(rng, 8, 30, 4)
        b.ilabel = np.maximum(b.ilabel, 1)
        got = native.compose(a, b)
        ref = F.compose(a, b)
        # same state count / arc multiset (order may differ)
        assert got.num_states == ref.num_states
        assert got.num_arcs == ref.num_arcs

        def key(f):
            return sorted(zip(f.src.tolist(), f.dst.tolist(),
                              f.ilabel.tolist(), f.olabel.tolist(),
                              np.round(f.weight, 5).tolist()))
        assert key(got) == key(ref)
        np.testing.assert_allclose(np.sort(got.final[np.isfinite(got.final)]),
                                   np.sort(ref.final[np.isfinite(ref.final)]),
                                   rtol=1e-6)


def test_native_shortest_path_matches_python(rng):
    native = _native_fst()
    for trial in range(5):
        f = _random_fst(rng, 15, 60, 5)
        try:
            ref = F.shortest_path(f)
        except ValueError:
            with pytest.raises(ValueError):
                native.shortest_path(f)
            continue
        got = native.shortest_path(f)
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-5)
        assert got[0] == ref[0] and got[1] == ref[1]


def test_native_word_decode_end_to_end(rng):
    native = _native_fst()
    words = ["ab", "c", "ba"]
    lexicon = {"ab": [0, 1], "c": [2], "ba": [1, 0]}
    T, L = 5, 3
    state = np.full((T, L), -5.0, np.float32)
    for t, p in enumerate([0, 1, 2, 1, 0]):
        state[t, p] = 0.0
    trans = np.zeros((L, L), np.float32)
    wseq, phones, wgt = F.decode_words(state, trans, T, lexicon, words,
                                       backend="native")
    assert wseq == ["ab", "c", "ba"]
    ref = F.decode_words(state, trans, T, lexicon, words, backend="py")
    np.testing.assert_allclose(wgt, ref[2], rtol=1e-5)


def test_native_pfile_matches_python(tmp_path, rng):
    from asr_craft.data import pfile_native
    if not pfile_native.available():
        pytest.skip("native pfile reader unavailable")
    feats = [rng.normal(size=(int(rng.integers(2, 20)), 7)).astype(np.float32)
             for _ in range(5)]
    labels = [rng.integers(0, 9, size=len(f)).astype(np.uint32)
              for f in feats]
    p = str(tmp_path / "t.pfile")
    data.write_pfile(p, data.PFile(feats, labels))
    ref = data.read_pfile(p)
    got = pfile_native.read_pfile_fast(p)
    assert got.num_sentences == ref.num_sentences
    for (f0, l0), (f1, l1) in zip(ref, got):
        np.testing.assert_array_equal(f0, f1)
        np.testing.assert_array_equal(l0, l1)
