"""Shared by the ``test_torch_sharding_jax_*.py`` files: the port's sharded
render of ``sharding_cases`` over gloo ranks against the JAX package's
render of the same case, sharded over as many of the conftest's virtual
devices, or unsharded where the port's estimator is JAX's unsharded one.

The files split the JAX compiles (5-25 s each on the CPU) so that none
runs much beyond a minute on one worker. Bars: the port's against JAX's
unsharded render (ROADMAP queue C): PT >= 99.9% of the pixels at rtol
1e-4, PPM and VCM >= 99% at rtol 1e-3; the image means within 1e-3.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np

from oppositerenderer_tpu.config import (PhotonExchange as JExchange,
                                         RenderConfig as JConfig,
                                         RenderMethod as JMethod)
from oppositerenderer_tpu.core.rng import make_root_key as jax_key
from oppositerenderer_tpu.integrators import ppm as jppm
from oppositerenderer_tpu.integrators import vcm as jvcm
from oppositerenderer_tpu.parallel import make_mesh as jax_mesh
from oppositerenderer_tpu.parallel import make_sharded_render_fn as jax_step
from oppositerenderer_tpu.scene import make_cornell_small
from oppositerenderer_tpu_torch.parallel.worker import (sharding_cases,
                                                        spawn_ranks)

# (pixel rtol, share of pixels that must agree, image mean rtol)
BARS = {"pt": (1e-4, 0.999, 1e-3), "ppm": (1e-3, 0.99, 1e-3),
        "vcm": (1e-3, 0.99, 1e-3)}
ENUMS = {"render_method": JMethod, "photon_exchange": JExchange}


def case(name: str, **cfg) -> dict:
    """``sharding_cases``' case ``name``, its config updated by ``cfg``."""
    c = next(c for c in sharding_cases() if c["name"] == name)
    return {**c, "name": name + "".join(f"_{k}{v}" for k, v in cfg.items()),
            "cfg": {**c["cfg"], **cfg}}


def jax_config(c: dict, **extra) -> JConfig:
    fields = {k: ENUMS[k][v] if k in ENUMS else v
              for k, v in c["cfg"].items()}
    return JConfig(**fields, **extra)


def jax_sharded(c: dict, d: int, **extra) -> np.ndarray:
    """JAX's sharded step of case ``c`` on ``d`` virtual devices."""
    scene, cam = make_cornell_small()
    step = jax_step(scene, cam, jax_config(c, **extra), jax_mesh(d))
    out, _ = step(jnp.int32(c["iteration"]), jax_key(c["seed"]),
                  jnp.float32(c["radius_sq"]))
    return np.asarray(out)


def jax_unsharded(c: dict, **extra) -> np.ndarray:
    """JAX's unsharded PPM or VCM iteration of case ``c``, jitted."""
    scene, cam = make_cornell_small()
    cfg = jax_config(c, **extra)
    mod = jppm if cfg.render_method == JMethod.PROGRESSIVE_PHOTON_MAPPING \
        else jvcm
    out, _ = jax.jit(lambda k: mod.render_iteration(
        scene, cam, cfg, jnp.int32(c["iteration"]), k,
        jnp.float32(c["radius_sq"])))(jax_key(c["seed"]))
    return np.asarray(out)


def port_and_jax(tmp, port_cases: dict, jax_refs: dict):
    """({(name, D): the port's sharded image}, {key: JAX's image}): the
    port's ranks (one spawn per D, ``port_cases`` maps D to its cases) run
    while this process computes ``jax_refs`` (key -> a function)."""
    def run(d):
        out = tmp / f"port{d}.npz"
        spawn_ranks(d, port_cases[d], out, device="cpu", backend="gloo",
                    threads=1, timeout=300)
        z = np.load(out)
        return {(c["name"], d): z[c["name"] + ".image"]
                for c in port_cases[d]}

    with concurrent.futures.ThreadPoolExecutor(len(port_cases)) as pool:
        futures = [pool.submit(run, d) for d in port_cases]
        refs = {k: fn() for k, fn in jax_refs.items()}
        port = {}
        for f in futures:
            port.update(f.result())
    return port, refs


def assert_agrees(got: np.ndarray, want: np.ndarray, kind: str) -> None:
    rtol, share, mean_rtol = BARS[kind]
    assert got.shape == want.shape and np.isfinite(got).all()
    agree = np.isclose(got, want, rtol=rtol, atol=0.0).all(axis=-1)
    assert agree.mean() >= share, agree.mean()
    assert abs(got.mean() / want.mean() - 1.0) <= mean_rtol
