"""PPM gradients of the port against finite differences and JAX's
``jax.grad`` (``tests/test_grad.py``'s two PPM cases), in a file of their
own so that the two gradient files run on separate workers.

At 24^2 (no 16x16 blocks) the port takes the budgeted gather, whose
gradient carries the photon-power term, as JAX's XLA gather does. At
32^2 it takes the tile gather on every device, whose sums have a zero
gradient as JAX's tile kernel's: the kd gradient flows only through the
BRDF and attenuation outside the gather, so it sits between a quarter of
the full (budgeted) gradient and all of it.
"""
import pytest

from test_torch_grad import JAX_RTOL, PPM, PPM_KW, case, kd_scaled


def test_ppm_grad_kd_matches_fd_and_jax():
    value, g, fd, jv, jg = case(PPM, kd_scaled, "CornellSmall", 1,
                                dict(PPM_KW, width=24, height=24))
    assert g > 0
    assert g == pytest.approx(fd, rel=0.03)
    assert value == pytest.approx(jv, rel=JAX_RTOL["ppm"])
    assert g == pytest.approx(jg, rel=JAX_RTOL["ppm"])


def test_ppm_grad_through_tiled_gather():
    kw = dict(PPM_KW, width=32, height=32)
    value, g, fd, jv, jg = case(PPM, kd_scaled, "CornellSmall", 1, kw,
                                jax_kw=dict(use_pallas_gather=True))
    assert g > 0
    assert value == pytest.approx(jv, rel=JAX_RTOL["ppm"])
    assert g == pytest.approx(jg, rel=JAX_RTOL["ppm"])
    # the full gradient: JAX's budgeted gather on the same image
    *_, g_ref = case(PPM, kd_scaled, "CornellSmall", 1, kw,
                     jax_kw=dict(use_pallas_gather=False))
    assert 0.25 * g_ref < g < g_ref, (g, g_ref)
