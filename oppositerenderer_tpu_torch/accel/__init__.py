from .intersect import Hit, intersect, occluded

__all__ = ["Hit", "intersect", "kernel_wrappers", "occluded"]


def kernel_wrappers():
    """The render and gradient paths' kernel wrappers (B1, B2, B3, B4, B5
    closest and any hit, the gradient's row sums, the threefry RNG's
    draws, words and flat uniforms), each counting its kernel launches in
    ``launches``."""
    from . import bvh_kernels as bk
    from . import gather_kernels as gk
    from . import intersect_kernels as ik
    from . import rng_kernels as nk
    from . import row_kernels as rk
    from . import vm_kernels as vk
    return (ik.closest_hit_tris, ik.occluded_tris, gk.gather_photons_tiled,
            vk.merge_vertices_tiled, bk.traverse, bk.traverse_any,
            rk.sum_rows, nk.threefry_draw, nk.threefry_words,
            nk.threefry_uniform)
