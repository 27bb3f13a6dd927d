from .bsdf import (BSDF, EPS_COSINE, EPS_PHONG, LAMBERTIAN, PHONG,
                   SPEC_REFL, SPEC_TRANS, SampleResult)
from .fresnel import fresnel, fresnel_dielectric

__all__ = [
    "BSDF", "SampleResult", "fresnel", "fresnel_dielectric",
    "EPS_COSINE", "EPS_PHONG",
    "LAMBERTIAN", "PHONG", "SPEC_REFL", "SPEC_TRANS",
]
