"""stable_sort_multi vs a stable numpy lexsort (the stability contract).

The coarse pass's painter's order rides on stable_sort_multi keeping equal
keys in payload order; ``np.lexsort`` is stable, so it is the model.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from piet_tpu.ops.sort import stable_sort_multi


def _check(keys, val):
    """keys: tuple of (n,) numpy arrays, most significant first."""
    order = np.lexsort(tuple(reversed(keys)))
    ks, vs = stable_sort_multi(tuple(jnp.asarray(k) for k in keys),
                               jnp.asarray(val))
    for got, k in zip(ks, keys):
        np.testing.assert_array_equal(np.asarray(got), k[order])
    np.testing.assert_array_equal(np.asarray(vs), val[order])


@pytest.mark.parametrize("n", [256, 300, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_single_key_matches_stable_sort(n, seed):
    rng = np.random.default_rng(seed)
    # Heavy duplication to exercise the stability tie-break.
    key = rng.integers(0, 17, n).astype(np.float32)
    _check((key,), np.arange(n, dtype=np.int32))


def test_two_key_matches_stable_sort():
    rng = np.random.default_rng(2)
    n = 512
    k1 = rng.integers(0, 7, n).astype(np.float32)
    k2 = rng.integers(0, 5, n).astype(np.float32)
    _check((k1, k2), np.arange(n, dtype=np.int32))


def test_inf_padding_keeps_dead_records_ordered():
    # Dead records carry +inf keys; stable order among them (by index).
    key = np.array([np.inf, 3.0, np.inf, 1.0, np.inf], np.float32)
    val = np.arange(5, dtype=np.int32)
    (ks,), vs = stable_sort_multi((jnp.asarray(key),), jnp.asarray(val))
    np.testing.assert_array_equal(np.asarray(vs), [3, 1, 0, 2, 4])
    assert np.asarray(ks)[2:].tolist() == [np.inf] * 3


def test_pairs_wrapper_int_keys():
    """Integer keys, a payload that is not the identity permutation."""
    rng = np.random.default_rng(3)
    key = rng.integers(0, 1000, 300).astype(np.int32)
    val = rng.permutation(300).astype(np.int32)
    _check((key,), val)
