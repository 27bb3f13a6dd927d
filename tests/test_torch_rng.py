"""Port RNG vs the JAX package: keys and per-lane streams bit for bit.

The port's counter-based sampler must draw exactly the JAX package's bits,
so that port and JAX images can be compared pixel by pixel. Every check
here is exact equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oppositerenderer_tpu.core import rng as jrng
from oppositerenderer_tpu_torch.core import rng as trng

torch.set_num_threads(2)

SEEDS = [0, 7, 12345, 2**31 - 1, 2**31 + 5, 2**32 - 1, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_root_and_iteration_keys_match_jax(seed):
    jroot = jrng.make_root_key(seed)
    troot = trng.make_root_key(seed)
    np.testing.assert_array_equal(trng.key_data(troot),
                                  np.asarray(jroot, np.uint32))
    for iteration, pass_id in ((0, 0), (1, 0), (17, 3), (2**31 - 1, 1)):
        want = np.asarray(jrng.iteration_key(jroot, iteration, pass_id),
                          np.uint32)
        got = trng.key_data(trng.iteration_key(troot, iteration, pass_id))
        np.testing.assert_array_equal(got, want)
    for data in (0, 5, 2**31 + 7, 2**32 - 1):
        want = np.asarray(jax.random.fold_in(jroot, data), np.uint32)
        np.testing.assert_array_equal(
            trng.key_data(trng.fold_in(troot, data)), want)


def test_threefry_matches_jax_on_random_words():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (4, 4096), dtype=np.uint64)
    words[:, :4] = [[0], [2**31], [2**32 - 1], [2**31 - 1]]  # edges
    jw = [jnp.asarray(w.astype(np.uint32)) for w in words]
    tw = [torch.as_tensor(w.astype(np.int64)) for w in words]
    want = jrng.threefry2x32(*jw)
    got = trng.threefry2x32(*tw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))
    # the same function on Python ints (the host-side key derivation)
    for i in range(8):
        k = [int(w[i]) for w in words]
        got_int = trng.threefry2x32(*k)
        assert got_int == (int(want[0][i]), int(want[1][i]))


def test_lowbias32_and_bits_to_uniform_match_jax():
    x = np.random.default_rng(1).integers(0, 2**32, 4096, dtype=np.uint64)
    want = np.asarray(jrng._lowbias32(jnp.asarray(x.astype(np.uint32))))
    got = trng._lowbias32(torch.as_tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(
        trng._bits_to_uniform(got).numpy(),
        np.asarray(jrng._bits_to_uniform(jnp.asarray(want))))


def test_lane_key_words_match_jax():
    root = jrng.make_root_key(9)
    its = [0, 3, 11]
    jkeys = jax.vmap(lambda it: jrng.iteration_key(root, it, 0))(
        jnp.asarray(its))
    want = jrng.lane_key_words(jkeys, 5)
    tkeys = [trng.iteration_key(trng.make_root_key(9), it, 0) for it in its]
    got = trng.lane_key_words(tkeys, 5, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))


@pytest.mark.parametrize("cheap", [False, True], ids=["threefry", "cheap"])
@pytest.mark.parametrize("per_lane_keys", [False, True],
                         ids=["scalar_key", "per_lane_keys"])
def test_lane_sampler_streams_match_jax(cheap, per_lane_keys):
    lanes = np.concatenate([np.arange(1000),
                            [2**31 - 1, 2**31 - 2, 123456789]]).astype(
        np.int32)
    jkey = jrng.iteration_key(jrng.make_root_key(7), 2, 0)
    tkey = trng.iteration_key(trng.make_root_key(7), 2, 0)
    if per_lane_keys:   # two stacked groups of lanes, as render_lanes does
        lanes = lanes[:1002]
        jkey = jrng.lane_key_words(jnp.stack([jkey, jax.random.fold_in(
            jkey, 1)]), 501)
        tkey = trng.lane_key_words([tkey, trng.fold_in(tkey, 1)], 501,
                                   "cpu")
    js = jrng.LaneSampler(jkey, jnp.asarray(lanes), cheap=cheap)
    ts = trng.LaneSampler(tkey, torch.as_tensor(lanes), cheap=cheap)
    for draw in ("next2", "next2", "next1", "next2", "next3", "next1",
                 "next3"):
        want = np.asarray(getattr(js, draw)())
        got = getattr(ts, draw)().numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=draw)
