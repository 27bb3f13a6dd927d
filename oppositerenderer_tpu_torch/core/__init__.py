from . import math, rng, sampling  # noqa: F401
