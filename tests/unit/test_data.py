"""Data layer: pfile/HTK/MLF round-trips, transforms, loader semantics."""
import numpy as np
import pytest

from asr_craft import data


def _corpus(rng, n=7, D=5):
    feats = [rng.normal(size=(int(rng.integers(3, 30)), D)).astype(np.float32)
             for _ in range(n)]
    labels = [rng.integers(0, 10, size=len(f)).astype(np.uint32) for f in feats]
    return feats, labels


def test_pfile_roundtrip(tmp_path, rng):
    feats, labels = _corpus(rng)
    pf = data.PFile(feats, labels)
    p = tmp_path / "t.pfile"
    data.write_pfile(p, pf)
    back = data.read_pfile(p)
    assert back.num_sentences == len(feats)
    for (f0, l0), (f1, l1) in zip(pf, back):
        np.testing.assert_array_equal(f0, f1)
        np.testing.assert_array_equal(l0, l1)


def test_pfile_no_labels(tmp_path, rng):
    feats, _ = _corpus(rng, n=3)
    p = tmp_path / "t.pfile"
    data.write_pfile(p, data.PFile(feats))
    back = data.read_pfile(p)
    assert back.labels is None
    np.testing.assert_array_equal(back.features[2], feats[2])


def test_htk_roundtrip(tmp_path, rng):
    f = rng.normal(size=(20, 13)).astype(np.float32)
    p = tmp_path / "t.htk"
    data.write_htk(p, f, samp_period=100000, parm_kind=6)
    back, period, kind = data.read_htk(p)
    np.testing.assert_array_equal(back, f)
    assert period == 100000 and kind == 6


def test_htk_labels_roundtrip(tmp_path):
    segs = [(0, 10, "sil"), (10, 25, "aa"), (25, 30, "k")]
    p = tmp_path / "t.lab"
    data.write_htk_labels(p, segs)
    assert data.read_htk_labels(p) == segs


def test_mlf_roundtrip(tmp_path):
    utts = {"utt1": [(0, 5, "sil"), (5, 9, "aa")],
            "utt2": [(-1, -1, "b"), (-1, -1, "iy")]}
    p = tmp_path / "t.mlf"
    data.write_mlf(p, utts)
    back = data.read_mlf(p)
    assert back == utts
    seqs = data.mlf_to_label_seqs(back, {"sil": 0, "aa": 1, "b": 2, "iy": 3})
    assert seqs == {"utt1": [0, 1], "utt2": [2, 3]}


def test_context_window():
    f = np.arange(8, dtype=np.float32).reshape(4, 2)
    w = data.context_window(f, 1)
    assert w.shape == (4, 6)
    np.testing.assert_array_equal(w[0], [0, 1, 0, 1, 2, 3])   # edge replicated
    np.testing.assert_array_equal(w[2], [2, 3, 4, 5, 6, 7])
    np.testing.assert_array_equal(w[3], [4, 5, 6, 7, 6, 7])


def test_deltas_linear_ramp():
    # a linear ramp has constant delta equal to the slope
    f = np.outer(np.arange(10, dtype=np.float32), np.ones(3, np.float32))
    d = data.deltas(f, window=2)
    np.testing.assert_allclose(d[3:7], 1.0, atol=1e-6)
    dd = data.add_deltas(f, order=2)
    assert dd.shape == (10, 9)


def test_normalizer(rng):
    utts = [rng.normal(loc=3.0, scale=2.0, size=(50, 4)).astype(np.float32)
            for _ in range(10)]
    norm = data.Normalizer.fit(utts)
    z = np.concatenate([norm(u) for u in utts])
    np.testing.assert_allclose(z.mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(z.std(axis=0), 1.0, atol=1e-3)


def test_concat_streams(rng):
    a = rng.normal(size=(6, 3)).astype(np.float32)
    b = rng.normal(size=(6, 2)).astype(np.float32)
    c = data.concat_streams(a, b)
    assert c.shape == (6, 5)
    with pytest.raises(ValueError):
        data.concat_streams(a, b[:4])


def test_loader_batches_and_padding(rng):
    feats, labels = _corpus(rng, n=20)
    cfg = data.LoaderConfig(batch_size=4, buckets=(16, 32), seed=1)
    loader = data.UtteranceLoader(feats, labels, cfg)
    seen = set()
    for batch in loader.epoch_batches():
        B, T, D = batch["feats"].shape
        assert B == 4 and T in (16, 32) and D == 5
        for r in range(B):
            uid, n = int(batch["uids"][r]), int(batch["lengths"][r])
            if uid < 0:
                assert n == 0
                continue
            seen.add(uid)
            np.testing.assert_array_equal(batch["feats"][r, :n], feats[uid][:n])
            np.testing.assert_array_equal(batch["labels"][r, :n],
                                          labels[uid][:n].astype(np.int32))
            # padding is zero
            assert not batch["feats"][r, n:].any()
    assert seen == set(range(20))


def test_loader_sharding(rng):
    feats, labels = _corpus(rng, n=10)
    cfg0 = data.LoaderConfig(batch_size=2, shard_id=0, num_shards=2)
    cfg1 = data.LoaderConfig(batch_size=2, shard_id=1, num_shards=2)
    l0 = data.UtteranceLoader(feats, labels, cfg0)
    l1 = data.UtteranceLoader(feats, labels, cfg1)
    u0 = {int(u) for b in l0.epoch_batches() for u in b["uids"] if u >= 0}
    u1 = {int(u) for b in l1.epoch_batches() for u in b["uids"] if u >= 0}
    assert u0 | u1 == set(range(10)) and not (u0 & u1)


def test_loader_deterministic_order(rng):
    feats, labels = _corpus(rng, n=12)
    cfg = data.LoaderConfig(batch_size=3, seed=7)
    a = data.UtteranceLoader(feats, labels, cfg)
    b = data.UtteranceLoader(feats, labels, cfg)
    ua = [list(bt["uids"]) for bt in a.epoch_batches(0)]
    ub = [list(bt["uids"]) for bt in b.epoch_batches(0)]
    assert ua == ub
    # different epoch => different order (with overwhelming probability)
    uc = [list(bt["uids"]) for bt in b.epoch_batches(1)]
    assert ua != uc


def test_train_cv_split():
    tr, cv = data.train_cv_split(20, 0.25, seed=3)
    assert len(tr) == 15 and len(cv) == 5
    assert set(tr) | set(cv) == set(range(20))


def test_synthetic_corpus():
    cfg = data.SyntheticConfig(num_labels=6, feat_dim=6, seed=3,
                               min_len=10, max_len=40)
    feats, labels, phones = data.generate_corpus(cfg, 5)
    assert len(feats) == 5
    for f, l, p in zip(feats, labels, phones):
        assert f.shape == (len(l), 6)
        assert l.max() < 6
        # phone sequence matches collapsed frame labels
        collapsed = [int(l[0])]
        for x in l[1:]:
            if int(x) != collapsed[-1]:
                collapsed.append(int(x))
        assert collapsed == p
        # adjacent phones distinct
        assert all(a != b for a, b in zip(p, p[1:]))


def test_nstate_frame_labels():
    fl = np.array([2, 2, 2, 2, 5, 5], np.int32)
    st = data.nstate_frame_labels(fl, 2)
    np.testing.assert_array_equal(st, [4, 4, 5, 5, 10, 11])
