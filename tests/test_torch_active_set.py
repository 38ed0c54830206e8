"""repro_torch's fixed-capacity active set against repro's: seeded ADD/DEL
sequences must leave identical slots (idx, mask, order, count, in_active,
overflowed) — slot arithmetic is integer-exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import active_set as ja
from repro_torch.core import active_set as ta


def _same(jset, tset):
    np.testing.assert_array_equal(tset.idx.numpy(), np.asarray(jset.idx))
    np.testing.assert_array_equal(tset.mask.numpy(), np.asarray(jset.mask))
    np.testing.assert_array_equal(tset.order.numpy(), np.asarray(jset.order))
    np.testing.assert_array_equal(tset.in_active.numpy(),
                                  np.asarray(jset.in_active))
    np.testing.assert_array_equal(tset.beta.numpy(), np.asarray(jset.beta))
    assert tset.count == int(jset.count)
    assert tset.overflowed == bool(jset.overflowed)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("slots_mode", [False, True])
def test_add_delete_sequence_matches(seed, slots_mode):
    r = np.random.default_rng(seed)
    p, k_max, h = 200, 24 if seed % 2 else 64, 8
    if slots_mode:
        live = r.random(k_max) < 0.4
        ids = r.choice(p, k_max, replace=False)
        beta0 = np.where(live, r.normal(size=k_max), 0.0)
        jset = ja.init_active_set(p, k_max, jnp.asarray(ids, jnp.int32),
                                  jnp.float64, jnp.asarray(beta0),
                                  live_mask=jnp.asarray(live))
        tset = ta.init_active_set(p, k_max, torch.from_numpy(ids),
                                  torch.float64, torch.from_numpy(beta0),
                                  live_mask=torch.from_numpy(live))
    else:
        ids = r.choice(p, 10, replace=False)
        jset = ja.init_active_set(p, k_max, jnp.asarray(ids, jnp.int32),
                                  jnp.float64)
        tset = ta.init_active_set(p, k_max, torch.from_numpy(ids),
                                  torch.float64)
    _same(jset, tset)
    for step in range(12):
        # coefficients move, as an inner burst would move them
        b = np.where(np.asarray(jset.mask), r.normal(size=k_max), 0.0)
        jset = jset._replace(beta=jnp.asarray(b))
        tset = tset._replace(beta=torch.from_numpy(b))
        if step % 2:
            drop = r.random(k_max) < 0.3
            jset = ja.delete_features(jset, jnp.asarray(drop))
            tset = ta.delete_features(tset, torch.from_numpy(drop))
        else:
            free = np.where(~np.asarray(jset.in_active))[0]
            cand = r.choice(free, h, replace=False)
            keep = r.random(h) < 0.8
            jset = ja.add_features(jset, jnp.asarray(cand, jnp.int32),
                                   jnp.asarray(keep))
            tset = ta.add_features(tset, torch.from_numpy(cand),
                                   torch.from_numpy(keep))
        _same(jset, tset)
    np.testing.assert_array_equal(ta.scatter_beta(tset, p).numpy(),
                                  np.asarray(ja.scatter_beta(jset, p)))
    X = r.normal(size=(7, p))
    np.testing.assert_array_equal(
        ta.gather_columns(torch.from_numpy(X), tset).numpy(),
        np.asarray(ja.gather_columns(jnp.asarray(X), jset)))


def test_overflow_flag_and_partial_add():
    """An ADD that wants more slots than are free places what fits, in
    candidate order, and raises the sticky overflow flag."""
    p, k_max = 50, 6
    ids = np.array([3, 9, 11, 20])
    jset = ja.init_active_set(p, k_max, jnp.asarray(ids, jnp.int32),
                              jnp.float64)
    tset = ta.init_active_set(p, k_max, torch.from_numpy(ids), torch.float64)
    cand = np.array([40, 41, 42, 43, 44])
    keep = np.array([True, False, True, True, True])
    jset = ja.add_features(jset, jnp.asarray(cand, jnp.int32),
                           jnp.asarray(keep))
    tset = ta.add_features(tset, torch.from_numpy(cand),
                           torch.from_numpy(keep))
    _same(jset, tset)
    assert tset.overflowed and tset.count == k_max
    drop = np.zeros(k_max, bool)
    drop[1] = True
    jset = ja.delete_features(jset, jnp.asarray(drop))
    tset = ta.delete_features(tset, torch.from_numpy(drop))
    _same(jset, tset)
    assert tset.overflowed


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_order_matches(seed):
    r = np.random.default_rng(seed)
    order = r.permutation(32)
    mask = r.random(32) < 0.5
    np.testing.assert_array_equal(
        ta.compact_order(torch.from_numpy(order),
                         torch.from_numpy(mask)).numpy(),
        np.asarray(ja.compact_order(jnp.asarray(order, jnp.int32),
                                    jnp.asarray(mask))))
