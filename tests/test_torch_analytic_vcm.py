"""VCM against the closed-form polygon-luminaire irradiance
(``tests/test_analytic.py``'s VCM test, at its tolerances); the scene and
the helpers are ``test_torch_analytic.py``'s."""
from test_torch_analytic import area_setup, assert_matches, run  # noqa: F401

from oppositerenderer_tpu_torch.config import RenderMethod


def test_vcm_matches_polygon_formula(area_setup):  # noqa: F811
    scene, cam, truth = area_setup
    img = run(scene, cam,
              RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING, 96, seed=9)
    assert_matches(img, truth, med_tol=0.06, mean_tol=0.03)
