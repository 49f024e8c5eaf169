"""The port's threefry streams against ``jax.random`` (JAX 0.9, threefry2x32,
partitionable bits).

``prng_key``, ``fold_in``, ``random_bits``, ``uniform`` (any bounds) and
``bernoulli`` (scalar and tensor ``p``) are bit-equal for seeds 0, 1, 42
and 2**31 - 1, ``fold_in`` data up to 2**32 - 1 and shapes (), (1,), (7,),
(3, 5) and (2135,); ``fold_in_static`` is flax's path fold-in.
``normal`` and ``truncated_normal`` are not bit-equal: XLA's float32
``log`` differs from torch's in the last ulp above sqrt(2) - 1 (the
Cephes branch of ``log1p`` below it is bit-equal), so the draws are held
within 4 ulp (3 measured).
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu_torch.utils import threefry

SEEDS = [0, 1, 42, 2**31 - 1]
SHAPES = [(), (1,), (7,), (3, 5), (2135,)]
DATA = [0, 1, 7, 2**31, 2**32 - 1]
ULP_BOUND = 4


def _key(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert threefry.prng_key(seed) == _key(key)
    for d in DATA:
        assert threefry.fold_in(threefry.prng_key(seed), d) == _key(jax.random.fold_in(key, d))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_equal_jax(seed, shape):
    for d in (3, 2**32 - 1):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        ours = threefry.fold_in(threefry.prng_key(seed), d)
        bits = threefry.random_bits(ours, shape)
        assert bits.shape == shape
        np.testing.assert_array_equal(bits.numpy(),
                                      np.asarray(jax.random.bits(key, shape)).astype(np.int64))
        for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (-0.7, 2.3)):
            want = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
            got = threefry.uniform(ours, shape, lo, hi).numpy()
            assert got.dtype == np.float32 and got.tobytes() == want.tobytes(), (lo, hi)
        for p in (0.7, 0.5, 0.01):
            np.testing.assert_array_equal(threefry.bernoulli(ours, p, shape).numpy(),
                                          np.asarray(jax.random.bernoulli(key, p, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_with_tensor_p_equals_jax(seed):
    p = np.random.RandomState(seed % 1000).rand(6, 9).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    ours = threefry.fold_in(threefry.prng_key(seed), 5)
    want = np.asarray(jax.random.bernoulli(key, p))
    np.testing.assert_array_equal(threefry.bernoulli(ours, torch.from_numpy(p)).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_truncated_normal_within_the_ulp_bound(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
    ours = threefry.fold_in(threefry.prng_key(seed), 9)
    n = np.asarray(jax.random.normal(key, shape))
    got = threefry.normal(ours, shape).numpy()
    assert got.shape == shape and _ulps(got, n).max(initial=0) <= ULP_BOUND
    t = np.asarray(jax.random.truncated_normal(key, -2.0, 2.0, shape))
    got = threefry.truncated_normal(ours, -2.0, 2.0, shape).numpy()
    assert _ulps(got, t).max(initial=0) <= ULP_BOUND
    assert np.all(np.abs(got) < 2.0)


def test_erf_inv_within_the_ulp_bound():
    x = np.random.RandomState(0).uniform(-1, 1, 50_000).astype(np.float32)
    x[:3] = (-1.0, 1.0, 0.0)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    got = threefry.erf_inv(torch.from_numpy(x)).numpy()
    assert _ulps(got[3:], want[3:]).max() <= 2
    np.testing.assert_array_equal(got[:3], want[:3])


def test_fold_in_static_is_flax_path_fold_in():
    from flax.core import scope

    key = jax.random.PRNGKey(3)
    for data in (("layer1", 1), ("layer3", "ii", 1), ("Dropout_0", 1), ("x", 0), ()):
        want = _key(scope._fold_in_static(key, data))
        assert threefry.fold_in_static(threefry.prng_key(3), *data) == want
    # the hash is of the concatenation, with no separator
    digest = hashlib.sha1(b"layer1" + b"\x01").digest()
    assert threefry.fold_in_static((0, 3), "layer1", 1) == threefry.fold_in(
        (0, 3), int.from_bytes(digest[:4], "big"))
    with pytest.raises(ValueError, match="Expected int or string"):
        threefry.fold_in_static((0, 3), 1.5)
