from .intersect import Hit, intersect, occluded

__all__ = ["Hit", "intersect", "occluded"]
