"""The port's sharded cases whose JAX reference is JAX's unsharded render,
at D = 2 and 4 gloo ranks. Bars in ``_sharding_jax.py``.

* PPM with ``ALL_GATHER``: JAX's sharded step always takes the budgeted
  gather there, while the port's, which takes the tile gather whenever
  the image splits into 16x16 blocks, equals its unsharded render
  (``test_torch_sharding.py``): JAX's unsharded tile gather
  (``use_pallas_gather=True``).
* VCM with vertex merging (``test_sharding.py``'s case): the port's
  sharded tile merge tiles the whole image's camera vertices (each rank
  merges its share of the tiles), so its image is the unsharded
  estimator: JAX's unsharded tile merge. JAX's sharded tile merge tiles
  each device's own vertices, another subsample;
  ``test_torch_sharding_jax_vm2.py`` and ``vm4.py`` hold the two against each
  other where no slot is subsampled.
"""
import pytest

from _sharding_jax import assert_agrees, case, jax_unsharded, port_and_jax

NAMES = {"ppm_all_gather": ("ppm", dict(use_pallas_gather=True)),
         "vcm_vm": ("vcm", dict(vcm_vm_use_pallas=True))}


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return port_and_jax(
        tmp_path_factory.mktemp("jax_unsharded"),
        {d: [case(n) for n in NAMES] for d in (2, 4)},
        {n: (lambda n=n: jax_unsharded(case(n), **NAMES[n][1]))
         for n in NAMES})


@pytest.mark.parametrize("d", (2, 4))
@pytest.mark.parametrize("name", list(NAMES))
def test_sharded_matches_jax_unsharded(images, name, d):
    port, jax_images = images
    assert_agrees(port[name, d], jax_images[name], NAMES[name][0])
