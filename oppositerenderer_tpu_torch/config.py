"""Runtime render configuration.

The counterpart of ``oppositerenderer_tpu/config.py``. Every field the path
tracer reads keeps its name, default and validation; the PPM and VCM fields
stay as plain data so later slices do not reshape the config. The JAX
package's compile- and dispatch-tuning fields have no meaning in eager
PyTorch and are absent. There is no kernel on/off switch: the device of the
tensors decides whether a hand-written kernel or its plain version runs
(``accel/intersect_kernels.py``).
"""
from __future__ import annotations

import dataclasses
import enum


class RenderMethod(enum.IntEnum):
    """Render methods (reference RenderEngine/renderer/RenderMethod.h)."""

    PATH_TRACING = 0
    PROGRESSIVE_PHOTON_MAPPING = 1
    VCM_BIDIRECTIONAL_PATH_TRACING = 2


class PhotonMapStructure(enum.IntEnum):
    """Photon map acceleration structure (reference: config.h:17-21)."""

    SORTED_UNIFORM_GRID = 0
    STOCHASTIC_HASH = 1
    KD_TREE_CPU = 2


class PhotonExchange(enum.IntEnum):
    """Multi-device photon-map exchange strategy (sharded PPM)."""

    ALL_TO_ALL = 0
    ALL_GATHER = 1


class Intersector(enum.IntEnum):
    """Ray-scene intersection backend."""

    AUTO = 0         # dense for small scenes, BVH otherwise
    BRUTEFORCE = 1   # every ray against every triangle
    BVH = 2          # bounding volume hierarchy traversal


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All render-time knobs (frozen, hashable)."""

    width: int = 512
    height: int = 512
    render_method: RenderMethod = RenderMethod.PATH_TRACING

    # --- path depths (reference config.h:33-37) ---
    max_radiance_trace_depth: int = 9
    max_photon_trace_depth: int = 7
    photon_rr_start_depth: int = 3
    path_rr_start_depth: int = 3

    # --- path tracing (reference pt/RayGeneratorPT.cu:67-69) ---
    pt_direct_light_sampling: bool = True
    pt_max_segments_nee: int = 5          # numPaths with NEE
    pt_max_segments_no_nee: int = 10      # numPaths without NEE
    pt_shadow_samples: int = 1

    # --- PPM (reference OptixRenderer.cpp:39-53, config.h:23-27) ---
    photons_per_iteration: int = 1 << 20
    max_photon_deposits_per_emitted: int = 4
    photon_grid_resolution: int = 100
    photon_map_structure: PhotonMapStructure = (
        PhotonMapStructure.SORTED_UNIFORM_GRID)
    stochastic_hash_size_log2: int = 22
    ppm_alpha: float = 2.0 / 3.0                  # Knaus-Zwicker alpha
    ppm_initial_radius: float = 0.20
    ppm_default_radius_from_scene: bool = True
    ppm_direct_shadow_samples: int = 4
    gather_photon_budget: int = 128
    photon_exchange: PhotonExchange = PhotonExchange.ALL_TO_ALL
    photon_exchange_capacity_factor: float = 2.0

    # --- VCM (reference OptixRenderer.cpp:53, vcm/*) ---
    vcm_max_path_length: int = 10
    vcm_use_vc: bool = True
    vcm_use_vm: bool = False
    vcm_vm_budget: int = 64
    vcm_connect_vertices: bool = True
    vcm_connect_camera_t1: bool = True
    vcm_connect_light_s0: bool = True
    vcm_connect_light_s1: bool = True
    vcm_force_continuation_prob: float | None = None
    vcm_uniform_vertex_sampling: bool = False
    vcm_uniform_connections: int = 3

    # --- participating media ---
    media_max_deposits_per_photon: int = 2

    # --- epsilons (reference config.h:41-43) ---
    ray_len_min: float = 1e-4
    eps_cosine: float = 1e-6
    eps_ray: float = 1e-3

    # --- intersection backend ---
    intersector: Intersector = Intersector.AUTO
    bruteforce_max_tris: int = 4096
    bvh_arity: int = 8
    bvh_leaf_size: int = 6

    # --- output (reference Gui/Application.cpp:36-40) ---
    gamma: float = 2.2

    # Iterations whose radiance is summed before it is added to the film
    # (Renderer.render). The sum order is the JAX package's, so the two
    # films agree bit for bit where the iterations do.
    iterations_per_dispatch: int = 8

    # --- reference parity mode: NEE multiplies raw albedo instead of
    # f = albedo/pi, and PPM clamps emitter passthrough radiance ---
    reference_faithful: bool = False

    # USE_CHEAP_RANDOM (config.h:39): hash RNG instead of threefry
    use_cheap_random: bool = False

    def __post_init__(self):
        # The reference hard-codes these as compile-time constants >= 1
        # (config.h:33-37); a depth-0 config is rejected, not rendered.
        for field in ("max_radiance_trace_depth", "max_photon_trace_depth",
                      "pt_max_segments_nee", "pt_max_segments_no_nee",
                      "vcm_max_path_length"):
            if getattr(self, field) < 1:
                raise ValueError(f"RenderConfig.{field} must be >= 1, got "
                                 f"{getattr(self, field)}")
        for field in ("pt_shadow_samples", "ppm_direct_shadow_samples"):
            if getattr(self, field) < 0:
                raise ValueError(f"RenderConfig.{field} must be >= 0, got "
                                 f"{getattr(self, field)}")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def pt_max_segments(self) -> int:
        return (self.pt_max_segments_nee if self.pt_direct_light_sampling
                else self.pt_max_segments_no_nee)
