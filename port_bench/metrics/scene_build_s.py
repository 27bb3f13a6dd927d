"""scene_build_s: seconds of ``get_scene_by_name`` (the procedural
build, and above 2,048 triangles the host BVH build), a harness span."""


def read(ctx):
    return ctx.spans.get("scene_build_s")
