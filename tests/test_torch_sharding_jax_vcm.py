"""The port's sharded PT and VCM (with uniform vertex sampling too) at D = 2
and 4 gloo ranks against the JAX package's sharded render on as many
virtual devices (``test_sharding.py``'s cases; bars in
``_sharding_jax.py``)."""
import pytest

from _sharding_jax import assert_agrees, case, jax_sharded, port_and_jax

RANKS = (2, 4)
NAMES = ("pt", "vcm", "vcm_uniform")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return port_and_jax(
        tmp_path_factory.mktemp("jax_vcm"),
        {d: [case(n) for n in NAMES] for d in RANKS},
        {(n, d): (lambda n=n, d=d: jax_sharded(case(n), d))
         for n in NAMES for d in RANKS})


@pytest.mark.parametrize("d", RANKS)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_matches_jax_sharded(images, name, d):
    port, jax_images = images
    assert_agrees(port[name, d], jax_images[name, d], name[:3])
