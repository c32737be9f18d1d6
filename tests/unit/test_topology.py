"""N-state topology masks (the ``CRF_StdNStateNode`` replacement)."""
import numpy as np

from asr_craft.models.topology import Topology


def test_monophone_mask_all_true():
    topo = Topology(num_labels=5, num_states=1)
    assert topo.num_expanded == 5
    assert topo.transition_mask().all()


def test_three_state_mask_structure():
    topo = Topology(num_labels=2, num_states=3)
    m = topo.transition_mask()
    assert m.shape == (6, 6)
    # within phone 0 (states 0,1,2): self loops + advance
    assert m[0, 0] and m[0, 1] and not m[0, 2]
    assert m[1, 1] and m[1, 2] and not m[1, 0]
    # exit only from last state (2) into entry states (0 and 3)
    assert m[2, 2] and m[2, 0] and m[2, 3]
    assert not m[2, 1] and not m[2, 4] and not m[2, 5]
    # no entry into a mid state from another phone
    assert not m[5, 1] and not m[5, 4]
    # phone 1 exit state
    assert m[5, 5] and m[5, 0] and m[5, 3]


def test_phone_of_roundtrip():
    topo = Topology(num_labels=4, num_states=3)
    states = np.arange(topo.num_expanded)
    phones = topo.phone_of(states)
    assert list(phones) == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3]
    assert list(topo.expand(np.arange(4))) == [0, 3, 6, 9]


def test_clamp_mask():
    import jax.numpy as jnp
    topo = Topology(num_labels=3, num_states=2)
    labels = jnp.asarray([0, 2, 1])
    pen = np.asarray(topo.clamp_mask(labels))
    assert pen.shape == (3, 6)
    assert (pen[0, :2] == 0).all() and (pen[0, 2:] < -1e20).all()
    assert (pen[1, 4:] == 0).all() and (pen[1, :4] < -1e20).all()
    assert (pen[2, 2:4] == 0).all()
