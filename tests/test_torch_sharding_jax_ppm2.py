"""The port's sharded PPM with ``ALL_TO_ALL`` at D = 2 gloo ranks against
the JAX package's on 2 virtual devices, both gathering over each rank's
partial grid with the tile gather. The port takes the tile gather
whenever the image splits into 16x16 blocks, so JAX's step runs with
``use_pallas_gather=True`` (its own rule would take the budgeted gather
off a TPU). ``test_torch_sharding_jax_ppm4.py`` has D = 4,
``test_torch_sharding_jax_unsharded.py`` ``ALL_GATHER``. Bars in
``_sharding_jax.py``."""
import pytest

from _sharding_jax import assert_agrees, case, jax_sharded, port_and_jax

D = 2
A2A = ("ppm_all_to_all", "ppm_all_to_all_2k")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return port_and_jax(
        tmp_path_factory.mktemp("jax_ppm2"), {D: [case(n) for n in A2A]},
        {n: (lambda n=n: jax_sharded(case(n), D, use_pallas_gather=True))
         for n in A2A})


@pytest.mark.parametrize("name", A2A)
def test_sharded_ppm_matches_jax_sharded(images, name):
    port, jax_images = images
    assert_agrees(port[name, D], jax_images[name], "ppm")
