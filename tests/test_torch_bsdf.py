"""Port BSDF, Fresnel, sampling and light sampling vs the JAX package.

Same frames, directions and uniforms go through both packages for every
material kind. Values agree to rtol 1e-5 / atol 1e-6: the JAX side runs
through XLA:CPU, whose rsqrt and contracted multiply-adds differ from
torch's in the last ulps, and sums over components are reduced in
another order. The Phong lobe raises its cosine to the power 90, which
multiplies that relative error by 90: the glossy material is held to rtol
5e-5 (its largest difference measured 2.2e-5), and the cone sampler's
1 - cos(theta) cancels at small angles: rtol 1e-4 there. Boolean
decisions (validity, specularity, component picks) are compared exactly.

The component pick is held to the JAX package's ``jnp.cumsum`` bit for
bit on 2^20 lanes, its running sums and its choice, with ``u0`` on and
one ulp beside each boundary; and ``BSDF.sample`` dispatches no scan.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from oppositerenderer_tpu import lights as jlights
from oppositerenderer_tpu.bsdf import BSDF as JBSDF
from oppositerenderer_tpu.bsdf.fresnel import fresnel as jfresnel
from oppositerenderer_tpu.core import math as jm
from oppositerenderer_tpu.core import sampling as js
from oppositerenderer_tpu_torch import lights as tlights
from oppositerenderer_tpu_torch.bsdf import BSDF as TBSDF
from oppositerenderer_tpu_torch.bsdf import bsdf as tbsdf
from oppositerenderer_tpu_torch.bsdf.fresnel import fresnel as tfresnel
from oppositerenderer_tpu_torch.core import math as tm
from oppositerenderer_tpu_torch.core import sampling as ts

torch.set_num_threads(2)

N = 1000
RTOL, ATOL = 1e-5, 1e-6
RTOL_PHONG = 5e-5
RTOL_CONE = 1e-4


def close(got, want, err_msg="", rtol=RTOL):
    if isinstance(got, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            close(g, w, f"{err_msg}[{i}]", rtol)
        return
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL,
                                   err_msg=err_msg)


def unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


# (kd, ks, exponent, kr, kt, ior, kr_is_dielectric, incident side)
MATERIALS = {
    "diffuse": ((0.8, 0.8, 0.8), (0, 0, 0), 0.0, (0, 0, 0), (0, 0, 0), 1.0,
                False, 1.0),
    "glossy": ((0.1, 0.1, 0.1), (0.7, 0.7, 0.7), 90.0, (0, 0, 0), (0, 0, 0),
               1.0, False, 1.0),
    "mirror": ((0, 0, 0), (0, 0, 0), 0.0, (1, 1, 1), (0, 0, 0), 1.0, False,
               1.0),
    "glass_outside": ((0, 0, 0), (0, 0, 0), 0.0, (1, 1, 1), (1, 1, 1), 1.6,
                      True, 1.0),
    # a hit from inside, after bsdf_at_hit's normal flip and IOR swap
    "glass_inside": ((0, 0, 0), (0, 0, 0), 0.0, (1, 1, 1), (1, 1, 1),
                     1.0 / 1.6, True, 1.0),
    # incident below the shading horizon: the exiting branch and TIR
    "glass_below": ((0, 0, 0), (0, 0, 0), 0.0, (1, 1, 1), (1, 1, 1), 1.6,
                    True, -1.0),
}


def make_pair(kind, seed):
    kd, ks, exp, kr, kt, ior, diel, side = MATERIALS[kind]
    rng = np.random.default_rng(seed)
    n = unit(rng, N)
    ng = n.copy()
    wi = unit(rng, N)
    wi = wi * np.sign(np.sum(wi * n, axis=1, keepdims=True)) * side
    coeff = [np.broadcast_to(np.asarray(c, np.float32), shape).copy()
             for c, shape in ((kd, (N, 3)), (ks, (N, 3)), (exp, (N,)),
                              (kr, (N, 3)), (kt, (N, 3)), (ior, (N,)))]
    diel = np.full(N, diel)
    args = [n, ng, wi, *coeff, diel]
    return (JBSDF.make(*[jnp.asarray(a) for a in args]),
            TBSDF.make(*[torch.as_tensor(a) for a in args]), rng)


@pytest.mark.parametrize("kind", list(MATERIALS))
def test_bsdf_matches_jax(kind):
    jb, tb, rng = make_pair(kind, seed=list(MATERIALS).index(kind))
    rtol = RTOL_PHONG if kind == "glossy" else RTOL
    close(tb.pick_probs(), jb.pick_probs(), "pick_probs")
    close(tb.continuation_prob(), jb.continuation_prob(), "cont")
    close(tb.is_specular(), jb.is_specular(), "is_specular")
    close(tb.is_valid(), jb.is_valid(), "is_valid")
    wo = unit(rng, N)
    close(tb.f(torch.as_tensor(wo)), jb.f(jnp.asarray(wo)), "f", rtol)
    close(tb.pdf(torch.as_tensor(wo), reverse=True),
          jb.pdf(jnp.asarray(wo), reverse=True), "pdf", rtol)
    u3 = rng.random((N, 3), dtype=np.float32)
    for adjoint in (False, True):
        got = tb.sample(torch.as_tensor(u3), adjoint=adjoint)
        want = jb.sample(jnp.asarray(u3), adjoint=adjoint)
        assert np.asarray(want.valid).any()
        for field in got._fields:
            close(getattr(got, field), getattr(want, field),
                  f"sample.{field} adjoint={adjoint}", rtol)


def test_fresnel_and_math_match_jax():
    rng = np.random.default_rng(11)
    cos_i = rng.uniform(-1, 1, N).astype(np.float32)
    eta = rng.uniform(0.5, 2.0, N).astype(np.float32)
    diel = rng.random(N) < 0.5
    close(tfresnel(torch.as_tensor(cos_i), torch.ones(N),
                   torch.as_tensor(eta), torch.as_tensor(diel)),
          jfresnel(jnp.asarray(cos_i), jnp.ones(N), jnp.asarray(eta),
                   jnp.asarray(diel)))
    d, n = unit(rng, N), unit(rng, N)
    d = -d * np.sign(np.sum(d * n, axis=1, keepdims=True))
    tj, tt = [jnp.asarray(a) for a in (d, n)], [torch.as_tensor(a)
                                                 for a in (d, n)]
    close(tm.reflect(*tt), jm.reflect(*tj), "reflect")
    close(tm.refract(*tt, torch.as_tensor(eta)),
          jm.refract(*tj, jnp.asarray(eta)), "refract")
    close(tm.build_onb(tt[1]), jm.build_onb(tj[1]), "onb")
    close(tm.cross(*tt), jm.cross(*tj), "cross")
    close(tm.length(tt[0] * 3), jm.length(tj[0] * 3), "length")


def test_sampling_matches_jax():
    rng = np.random.default_rng(12)
    u = rng.random((N, 2), dtype=np.float32)
    n = unit(rng, N)
    power = rng.uniform(1.0, 100.0, N).astype(np.float32)
    theta = rng.uniform(0.05, 1.5, N).astype(np.float32)
    center = rng.normal(size=(N, 3)).astype(np.float32)
    radius = rng.uniform(0.1, 2.0, N).astype(np.float32)
    J = lambda *a: [jnp.asarray(x) for x in a]   # noqa: E731
    T = lambda *a: [torch.as_tensor(x) for x in a]   # noqa: E731
    for bias in (False, True):
        close(ts.sample_unit_hemisphere_cos(*T(n, u), bias),
              js.sample_unit_hemisphere_cos(*J(n, u), bias), "hemi")
    close(ts.cos_hemisphere_pdf_w(*T(n, n[::-1].copy())),
          js.cos_hemisphere_pdf_w(*J(n, n[::-1].copy())), "hemi pdf")
    close(ts.sample_unit_sphere(*T(u)), js.sample_unit_sphere(*J(u)), "sph")
    close(ts.sample_unit_disc(*T(u)), js.sample_unit_disc(*J(u)), "disc")
    close(ts.sample_disc(*T(u, center, radius, n)),
          js.sample_disc(*J(u, center, radius, n)), "disc3")
    close(ts.sample_power_cos_hemisphere(*T(u, power)),
          js.sample_power_cos_hemisphere(*J(u, power)), "phong", RTOL_PHONG)
    close(ts.power_cos_hemisphere_pdf_w(*T(n, n[::-1].copy(), power)),
          js.power_cos_hemisphere_pdf_w(*J(n, n[::-1].copy(), power)),
          "phong pdf", RTOL_PHONG)
    close(ts.sample_cone(*T(u, theta, n)), js.sample_cone(*J(u, theta, n)),
          "cone", RTOL_CONE)
    close(ts.cone_pdf_w(*T(theta)), js.cone_pdf_w(*J(theta)), "cone pdf",
          RTOL_CONE)
    close(ts.pdf_w_to_a(*T(power, radius, theta)),
          js.pdf_w_to_a(*J(power, radius, theta)), "w->a")
    close(ts.pdf_a_to_w(*T(power, radius, theta)),
          js.pdf_a_to_w(*J(power, radius, theta)), "a->w")


def test_light_contribution_matches_jax():
    lights = [jlights.make_area_light((19.66,) * 3, (1.0, 2.499, 1.0),
                                      (0.5, 0, 0), (0, 0, 0.5)),
              jlights.make_point_light((70.0,) * 3, (1.25, 2.25, 1.25)),
              jlights.make_spot_light((30.0,) * 3, (1.25, 2.4, 1.25),
                                      (0, -1, 0), 40.0)]
    jt = jlights.build_light_table(lights)
    tt = tlights.build_light_table(lights, "cpu")
    for f in tlights.LIGHT_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    rng = np.random.default_rng(13)
    idx = rng.integers(0, 3, N)
    pos = rng.uniform(0.1, 2.4, (N, 3)).astype(np.float32)
    nrm = unit(rng, N)
    u2 = rng.random((N, 2), dtype=np.float32)
    close(tlights.light_contribution(tt.row(torch.as_tensor(idx)),
                                     *[torch.as_tensor(a)
                                       for a in (pos, nrm, u2)]),
          jlights.light_contribution(jt.row(jnp.asarray(idx)),
                                     *[jnp.asarray(a)
                                       for a in (pos, nrm, u2)]))


LANES = 1 << 20


def sampled_pick(b, u3):
    """``b.sample(u3)`` and the ``(w, u0, idx)`` of the lobe pick in it."""
    calls = []
    pick_lobe = tbsdf.pick_lobe

    def spy(w, u0):
        calls.append((w, u0, pick_lobe(w, u0)))
        return calls[-1][2]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbsdf, "pick_lobe", spy)
        out = b.sample(u3)
    (call,) = calls
    return out, call


@pytest.fixture(scope="module")
def pick_lanes():
    """A BSDF on 2^20 lanes and the normalised pick probabilities ``w``
    its ``sample`` picks from. The lobes are grey, ior 1 and kr not
    dielectric, so each pick probability is a lobe's luminance (times the
    transmission's 1 - Fresnel). A lane holds each lobe with probability
    1/2, so 1/16 of the lanes have none (pick sum 0) and 1/4 exactly one;
    an eighth of the lobes are scaled by 1e-39 beside normal ones, which
    makes their probabilities subnormal."""
    rng = np.random.default_rng(24)
    n = unit(rng, LANES)
    wi = unit(rng, LANES)
    wi = wi * np.sign(np.sum(wi * n, axis=1, keepdims=True))
    grey = rng.random((LANES, 4), dtype=np.float32)
    grey *= rng.random((LANES, 4)) < 0.5
    grey *= np.where(rng.random((LANES, 4)) < 0.125, np.float32(1e-39),
                     np.float32(1))
    kd, ks, kr, kt = (np.repeat(grey[:, i:i + 1], 3, axis=1)
                      for i in range(4))
    args = [n, n.copy(), wi, kd, ks, np.full(LANES, 20, np.float32), kr, kt,
            np.ones(LANES, np.float32), np.zeros(LANES, bool)]
    b = TBSDF.make(*[torch.as_tensor(a) for a in args])
    u3 = torch.as_tensor(rng.random((LANES, 3), dtype=np.float32))
    _, (w, _, _) = sampled_pick(b, u3)
    w = w.numpy()
    present = w > 0
    assert (~present.any(axis=1)).any() and (present.sum(axis=1) == 1).any()
    assert (present & (w < np.finfo(np.float32).tiny)).any()
    return b, w


def test_lobe_cdf_is_jnp_cumsum_bit_for_bit(pick_lanes):
    """Torch's CPU cumsum accumulates float32 in double, and its third
    running sum misses jnp.cumsum's by an ulp on some lanes."""
    _, w = pick_lanes
    want = np.asarray(jnp.cumsum(jnp.asarray(w), axis=-1))[:, :3]
    np.testing.assert_array_equal(tbsdf.lobe_cdf(torch.as_tensor(w)).numpy(),
                                  want)


@pytest.mark.parametrize("at,ulps", [("uniform", 0)] + [
    (f"c{k}", d) for k in range(3) for d in (-1, 0, 1)])
def test_sample_picks_the_jax_lobe_bit_for_bit(pick_lanes, at, ulps):
    """``u0`` uniform, or on the JAX package's running sum c0, c1 or c2
    moved by ``ulps`` float32 ulps (and held at 0 or above: a uniform)."""
    b, w = pick_lanes
    rng = np.random.default_rng(25)
    cdf = jnp.cumsum(jnp.asarray(w), axis=-1)
    u3 = rng.random((LANES, 3), dtype=np.float32)
    if at != "uniform":
        u0 = np.asarray(cdf)[:, int(at[1])]
        if ulps:
            u0 = np.nextafter(u0, np.float32(np.inf * ulps))
        u3[:, 0] = np.maximum(u0, 0.0)
    _, (w_seen, _, idx) = sampled_pick(b, torch.as_tensor(u3))
    np.testing.assert_array_equal(w_seen.numpy(), w)
    u0 = jnp.asarray(u3[:, 0])
    want = jnp.sum((u0[..., None] >= cdf[..., :-1]).astype(jnp.int32),
                   axis=-1)
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


class AtenOps(TorchDispatchMode):
    """The aten operators dispatched, by name."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kd_grad", [False, True])
def test_sample_dispatches_no_scan(kd_grad):
    """Aten's innermost-dimension scan ran hundreds of times slower than
    its data on the card for rows of four; with ``kd`` requiring grad the
    pick still records no autograd node."""
    _, tb, rng = make_pair("glossy", seed=24)
    if kd_grad:
        tb = dataclasses.replace(tb, kd=tb.kd.clone().requires_grad_())
    u3 = torch.as_tensor(rng.random((N, 3), dtype=np.float32))
    with AtenOps() as seen:
        out, (w, _, idx) = sampled_pick(tb, u3)
    assert "div" in seen.names and "sum" in seen.names
    assert not {"cumsum", "cumsum_"} & seen.names
    assert w.requires_grad == out.f.requires_grad == kd_grad
    assert tbsdf.lobe_cdf(w).grad_fn is None and idx.grad_fn is None
