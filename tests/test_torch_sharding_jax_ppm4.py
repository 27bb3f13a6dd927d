"""The port's sharded PPM with ``ALL_TO_ALL`` at D = 4 gloo ranks against
the JAX package's on 4 virtual devices, both gathering over each rank's
partial grid with the tile gather (``use_pallas_gather=True`` for JAX:
the port's estimator rule; ``test_torch_sharding_jax_ppm2.py`` has
D = 2). Bars in ``_sharding_jax.py``."""
import pytest

from _sharding_jax import assert_agrees, case, jax_sharded, port_and_jax

D = 4
A2A = ("ppm_all_to_all", "ppm_all_to_all_2k")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return port_and_jax(
        tmp_path_factory.mktemp("jax_ppm4"), {D: [case(n) for n in A2A]},
        {n: (lambda n=n: jax_sharded(case(n), D, use_pallas_gather=True))
         for n in A2A})


@pytest.mark.parametrize("name", A2A)
def test_sharded_ppm_matches_jax_sharded(images, name):
    port, jax_images = images
    assert_agrees(port[name, D], jax_images[name], "ppm")
