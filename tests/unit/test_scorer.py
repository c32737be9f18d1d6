"""Edit distance / PER scoring / TIMIT folding."""
import numpy as np

from asr_craft.decode import scorer as S


def test_edit_distance_basic():
    d, parts = S.edit_distance([1, 2, 3], [1, 2, 3])
    assert d == 0 and parts == {"sub": 0, "ins": 0, "del": 0}
    d, parts = S.edit_distance([1, 2, 3], [1, 3])
    assert d == 1 and parts["del"] == 1
    d, parts = S.edit_distance([1, 3], [1, 2, 3])
    assert d == 1 and parts["ins"] == 1
    d, parts = S.edit_distance([1, 2, 3], [1, 9, 3])
    assert d == 1 and parts["sub"] == 1
    d, _ = S.edit_distance([], [1, 2])
    assert d == 2


def test_collapse_frames():
    assert S.collapse_frames([1, 1, 2, 2, 2, 1, 3, 3]) == [1, 2, 1, 3]
    assert S.collapse_frames([1, 1, 2, 2], length=2) == [1]
    assert S.collapse_frames([0, 0, 1, 0, 2], drop=[0]) == [1, 2]


def test_timit_sets():
    assert len(S.TIMIT_48) == 48 and len(S.TIMIT_39) == 39
    fold = S.timit_fold_indices()
    assert fold.shape == (48,)
    i48 = {p: i for i, p in enumerate(S.TIMIT_48)}
    i39 = {p: i for i, p in enumerate(S.TIMIT_39)}
    # ao folds to aa; zh to sh; iy stays iy
    assert fold[i48["ao"]] == i39["aa"]
    assert fold[i48["zh"]] == i39["sh"]
    assert fold[i48["iy"]] == i39["iy"]
    # cl/vcl/epi all fold to sil
    assert fold[i48["cl"]] == fold[i48["vcl"]] == fold[i48["epi"]] == i39["sil"]


def test_scorer_accumulation():
    sc = S.ErrorRateScorer()
    sc.add([1, 2, 3], [1, 2, 3])
    sc.add([1, 2], [2, 2])
    assert sc.errors == 1 and sc.tokens == 5
    assert abs(sc.error_rate - 0.2) < 1e-9
    s = sc.summary()
    assert s["sentence_error_rate"] == 0.5


def test_score_batch_with_fold():
    sc = S.ErrorRateScorer()
    fold = np.asarray([0, 0, 1], np.int32)  # labels 0,1 -> 0; 2 -> 1
    refs = [[0, 2, 1]]                       # folds to [0, 1, 0]
    hyp = np.asarray([[1, 1, 2, 2, 0, 0]])   # folds+collapses to [0, 1, 0]
    S.score_batch(sc, refs, hyp, np.asarray([6]), fold=fold)
    assert sc.errors == 0 and sc.tokens == 3
