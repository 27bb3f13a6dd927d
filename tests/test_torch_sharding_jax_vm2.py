"""The port's sharded VCM with vertex merging at D = 2 gloo ranks against
JAX's sharded tile merge on 2 virtual devices, on a grid of 8^3 cells
with L = 3, where no slot is subsampled: the port tiles the whole image's
camera vertices, JAX each device's, and the two agree pixel by pixel only
where neither subsamples (``test_torch_sharding_jax_vm4.py`` has D = 4,
``test_torch_sharding_jax_unsharded.py`` JAX's case). Bars in
``_sharding_jax.py``."""
from _sharding_jax import assert_agrees, case, jax_sharded, port_and_jax

D = 2
COARSE = case("vcm_vm", photon_grid_resolution=8, vcm_max_path_length=3)


def test_sharded_vm_matches_jax_sharded_where_nothing_is_subsampled(
        tmp_path):
    port, refs = port_and_jax(
        tmp_path, {D: [COARSE]},
        {D: lambda: jax_sharded(COARSE, D, vcm_vm_use_pallas=True)})
    assert_agrees(port[COARSE["name"], D], refs[D], "vcm")
