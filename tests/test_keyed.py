"""keyed_sum_xla: the coarse pass's keyed sums vs a numpy model.

Exactness contract: for integer-valued f32 values the sums equal
``np.add.at`` bitwise (integer f32 addition is associative below 2^24);
keys outside [0, n_out) are dropped.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from piet_tpu.ops.keyed import keyed_sum_xla


def _check(values, keys, lo, hi, n_out):
    """lo/hi: the call sites' monotone key bounds (every key lies in
    [lo, hi) or is out of range); the sum does not depend on them."""
    live = (keys >= 0) & (keys < n_out)
    assert ((keys >= lo) & (keys < hi) | ~live).all()
    got = np.asarray(keyed_sum_xla(jnp.asarray(values), jnp.asarray(keys),
                                   n_out))
    want = np.zeros((n_out, values.shape[1]), np.float32)
    np.add.at(want, keys[live], values[live])
    np.testing.assert_array_equal(got, want)


def test_monotone_keys_histogram():
    rng = np.random.default_rng(0)
    E, n_out = 3000, 2048
    keys = np.sort(rng.integers(0, n_out, E)).astype(np.int32)
    values = rng.integers(0, 3, (E, 2)).astype(np.float32)
    _check(values, keys, keys, keys + 1, n_out)


def test_banded_keys_with_bounds():
    """Keys jump within monotone [lo, hi) bands (the hit->candidate
    shape): entries of item i target keys in the item's range."""
    rng = np.random.default_rng(1)
    n_items, n_out = 40, 4096
    sizes = rng.integers(1, 300, n_items).astype(np.int32)
    excl = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    per_item = rng.integers(1, 60, n_items)
    keys, lo, hi, vals = [], [], [], []
    for i in range(n_items):
        k = rng.integers(excl[i], excl[i] + sizes[i], per_item[i])
        keys.append(k)
        lo.append(np.full(per_item[i], excl[i]))
        hi.append(np.full(per_item[i], excl[i] + sizes[i]))
        vals.append(rng.integers(-1, 3, (per_item[i], 1)))
    keys = np.concatenate(keys).astype(np.int32)
    lo = np.concatenate(lo).astype(np.int32)
    hi = np.concatenate(hi).astype(np.int32)
    vals = np.concatenate(vals).astype(np.float32)
    _check(vals, keys, lo, hi, n_out)


def test_dead_entries_and_out_of_range_keys():
    rng = np.random.default_rng(2)
    E, n_out = 1200, 1024
    keys = np.sort(rng.integers(0, n_out, E)).astype(np.int32)
    values = rng.integers(1, 3, (E, 1)).astype(np.float32)
    dead = rng.random(E) < 0.3
    values[dead] = 0.0
    keys2 = keys.copy()
    keys2[dead] = n_out + 17          # out of range, value already 0
    lo = np.maximum.accumulate(np.where(dead, 0, keys)).astype(np.int32)
    hi = (np.maximum.accumulate(np.where(dead, 0, keys)) + 1 + n_out
          * dead).astype(np.int32)
    _check(values, keys2, lo, hi, n_out)


@pytest.mark.parametrize("seed", [3, 4])
def test_fuzz_sorted(seed):
    rng = np.random.default_rng(seed)
    E = int(rng.integers(10, 5000))
    n_out = int(rng.integers(100, 3000))
    keys = np.sort(rng.integers(0, n_out, E)).astype(np.int32)
    V = int(rng.integers(1, 4))
    values = rng.integers(0, 5, (E, V)).astype(np.float32)
    _check(values, keys, keys, keys + 1, n_out)
