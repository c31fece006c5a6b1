"""gather_monotone_xla: row gathers at monotone indices vs numpy.

Bit-exactness contract: for ANY 32-bit payload (f32 including -0.0, Inf,
NaN bit patterns, or bitcast int32), the gather must equal numpy fancy
indexing word-for-word.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from piet_tpu.ops.gatherm import gather_monotone_xla


def _check(rows, idxs):
    got = gather_monotone_xla(jnp.asarray(rows),
                              tuple(jnp.asarray(i) for i in idxs))
    assert len(got) == len(idxs)
    for g, i in zip(got, idxs):
        np.testing.assert_array_equal(
            np.asarray(g).view(np.uint32), rows[i].view(np.uint32))


def _monotone_idx(rng, P, N):
    return np.sort(rng.integers(0, N, P)).astype(np.int32)


def test_basic_single_stream():
    rows = np.arange(40, dtype=np.float32).reshape(20, 2) * 1.5
    idx = np.array([0, 0, 1, 3, 3, 3, 7, 19], np.int32)
    _check(rows, (idx,))


def test_two_streams_shared_window():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((300, 2)).astype(np.float32)
    i0 = _monotone_idx(rng, 900, 300)
    i1 = np.minimum(i0 + 1, 299).astype(np.int32)
    _check(rows, (i0, i1))


def test_special_bit_patterns_roundtrip():
    rows = np.zeros((64, 3), np.float32)
    rows[0, 0] = -0.0
    rows[1, 1] = np.inf
    rows[2, 2] = -np.inf
    rows[3, 0] = np.nan
    rows[4, 1] = np.float32.__call__(1e-42)      # subnormal
    rows[5, 2] = np.frombuffer(np.uint32(0xDEADBEEF).tobytes(),
                               np.float32)[0]
    idx = np.repeat(np.arange(8, dtype=np.int32), 10)
    _check(rows, (idx,))


def test_int32_payload():
    rng = np.random.default_rng(1)
    rows = rng.integers(-2**31, 2**31 - 1, (128, 4), dtype=np.int64
                        ).astype(np.int32)
    idx = _monotone_idx(rng, 1024, 128)
    got = gather_monotone_xla(jnp.asarray(rows), (jnp.asarray(idx),))[0]
    np.testing.assert_array_equal(np.asarray(got), rows[idx])


def test_wide_span_multiblock():
    """Indices sweeping the whole of a large source range."""
    rng = np.random.default_rng(2)
    N = 5000
    rows = rng.standard_normal((N, 5)).astype(np.float32)
    # One block's indices span nearly the whole source array.
    idx = np.linspace(0, N - 1, 2048).astype(np.int32)
    _check(rows, (idx,))


def test_constant_and_jumpy_streams():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((2000, 1)).astype(np.float32)
    const = np.full(700, 1234, np.int32)
    jumpy = np.sort(np.concatenate(
        [np.zeros(350, np.int32), np.full(350, 1999, np.int32)]))
    _check(rows, (const, jumpy))


def test_p_not_multiple_of_block():
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((100, 2)).astype(np.float32)
    _check(rows, (_monotone_idx(rng, 1300, 100),))


@pytest.mark.parametrize("seed", [5, 6])
def test_fuzz_random(seed):
    rng = np.random.default_rng(seed)
    N = int(rng.integers(2, 4000))
    P = int(rng.integers(1, 5000))
    W = int(rng.integers(1, 9))
    K = int(rng.integers(1, 4))
    rows = rng.standard_normal((N, W)).astype(np.float32)
    idxs = tuple(_monotone_idx(rng, P, N) for _ in range(K))
    _check(rows, idxs)
