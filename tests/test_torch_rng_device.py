"""Device keys: the port's key derivation on int64 word tensors.

A captured iteration (``renderer.CapturedStep``) takes the iteration and
the root key as device tensors, so every key it derives is a device key.
The device ``fold_in``, ``fold_in_range`` and ``iteration_key`` must give
the host versions' words and ``jax.random.fold_in``'s, and ``uniform`` and
``LaneSampler`` must draw the same bits from a device key as from a host
key. Every check is exact equality.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from oppositerenderer_tpu.core import rng as jrng
from oppositerenderer_tpu_torch.core import rng as trng

torch.set_num_threads(2)

SEEDS = [0, 7, 12345, 2**31 - 1, 2**31 + 5, 2**32 - 1, -3, -2**31]
DATA = [0, 5, 2**31 - 1, 2**31, 2**31 + 7, 2**32 - 1]


def words(key) -> tuple[int, int]:
    return tuple(int(w) for w in key)


def jax_words(key) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(key, np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_device_fold_in_equals_host_and_jax(seed):
    host = trng.make_root_key(seed)
    dev = trng.device_key(host, "cpu")
    assert all(torch.is_tensor(w) and w.dim() == 0 and w.dtype == torch.int64
               for w in dev)
    assert words(dev) == host
    jroot = jrng.make_root_key(seed)
    for data in DATA:
        want = jax_words(jax.random.fold_in(jroot, data))
        assert trng.fold_in(host, data) == want
        got = trng.fold_in(dev, data)
        assert torch.is_tensor(got[0]) and words(got) == want
        # a tensor datum folds into a host key as well
        got = trng.fold_in(host, torch.tensor(data, dtype=torch.int64))
        assert words(got) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_device_iteration_key_equals_host_and_jax(seed):
    host = trng.make_root_key(seed)
    dev = trng.device_key(host, "cpu")
    jroot = jrng.make_root_key(seed)
    for iteration, pass_id in ((0, 0), (1, 1), (17, 3), (2**31 - 1, 5),
                               (2**31 + 3, 2)):
        want = jax_words(jrng.iteration_key(jroot, iteration, pass_id))
        it = torch.tensor(iteration, dtype=torch.int64)
        assert trng.iteration_key(host, iteration, pass_id) == want
        for key, i in ((dev, iteration), (dev, it), (host, it)):
            got = trng.iteration_key(key, i, pass_id)
            assert torch.is_tensor(got[0]) and words(got) == want


@pytest.mark.parametrize("start,count", [(1, 5), (1000, 8), (3001, 9),
                                         (4001, 10)])
def test_fold_in_range_equals_one_fold_in_a_datum(start, count):
    host = trng.iteration_key(trng.make_root_key(3), 11, 2)
    dev = trng.device_key(host, "cpu")
    want = [trng.fold_in(host, start + i) for i in range(count)]
    assert trng.fold_in_range(host, start, count) == want
    got = trng.fold_in_range(dev, start, count)
    assert [words(k) for k in got] == want
    assert all(k[0].dim() == 0 for k in got)


@settings(max_examples=60, deadline=None)
@given(k0=st.integers(0, 2**32 - 1), k1=st.integers(0, 2**32 - 1),
       data=st.integers(0, 2**32 - 1), iteration=st.integers(0, 2**32 - 1),
       pass_id=st.integers(0, 7))
def test_device_keys_on_drawn_words(k0, k1, data, iteration, pass_id):
    host = (k0, k1)
    dev = trng.device_key(host, "cpu")
    want = jax_words(jax.random.fold_in(
        jax.numpy.asarray(host, jax.numpy.uint32), data))
    assert trng.fold_in(host, data) == want
    assert words(trng.fold_in(dev, data)) == want
    assert words(trng.iteration_key(
        dev, torch.tensor(iteration), pass_id)) == trng.iteration_key(
            host, iteration, pass_id)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (4097,)])
def test_uniform_draws_the_same_bits_from_a_device_key(shape):
    host = trng.iteration_key(trng.make_root_key(-3), 6, 2)
    want = trng.uniform(host, shape, "cpu")
    got = trng.uniform(trng.device_key(host, "cpu"), shape, "cpu")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    jwant = np.asarray(jax.random.uniform(
        jrng.iteration_key(jrng.make_root_key(-3), 6, 2), shape))
    np.testing.assert_array_equal(got.numpy(), jwant)


@pytest.mark.parametrize("cheap", [False, True], ids=["threefry", "cheap"])
@pytest.mark.parametrize("per_lane_keys", [False, True],
                         ids=["one_key", "per_lane_keys"])
def test_lane_sampler_draws_the_same_bits_from_a_device_key(cheap,
                                                            per_lane_keys):
    lanes = torch.as_tensor(np.concatenate([
        np.arange(1000), [2**31 - 1, 2**31 - 2]]).astype(np.int64))
    host = trng.iteration_key(trng.make_root_key(7), 2, 0)
    dev = trng.iteration_key(trng.device_key(trng.make_root_key(7), "cpu"),
                             torch.tensor(2), 0)
    if per_lane_keys:   # two stacked groups of lanes, as render_lanes does
        host = trng.lane_key_words([host, trng.fold_in(host, 1)], 501,
                                   "cpu")
        dev = trng.lane_key_words([dev, trng.fold_in(dev, 1)], 501, "cpu")
        assert all(torch.equal(h, d) for h, d in zip(host, dev))
    hs = trng.LaneSampler(host, lanes, cheap=cheap)
    ds = trng.LaneSampler(dev, lanes, cheap=cheap)
    for draw in ("next2", "next1", "next3", "next2", "next1"):
        want = getattr(hs, draw)()
        got = getattr(ds, draw)()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            draw
