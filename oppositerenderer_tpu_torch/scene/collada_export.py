"""COLLADA (.dae) export of a built Scene.

The counterpart of ``oppositerenderer_tpu/scene/collada_export.py``, the
inverse of :mod:`.collada`'s importer: it turns a procedural scene (the
Sponza-class Atrium, the Conference room) into a real Collada file with
its PNG textures on disk, so that the whole file-import path (transforms,
per-material <triangles> prims, the effect and material libraries,
texture files, point lights) runs as it does on the reference's Sponza and
Conference downloads (``scene/Scene.cpp:73-175``). The same scene gives
the same text as the JAX package's exporter.

Material mapping mirrors the importer's priority rules in reverse:
EMITTER -> emission color, TEXTURED -> diffuse <texture> (+ PNG on disk),
GLASS -> index_of_refraction > 1, MIRROR -> reflective, GLOSSY -> diffuse
+ specular + shininess, DIFFUSE -> diffuse color. Collada has no glossy
class, nor have the reference's import rules: GLOSSY re-imports as
DIFFUSE. Analytic spheres have no Collada mesh and are skipped.
"""
from __future__ import annotations

from pathlib import Path
from xml.sax.saxutils import escape

import numpy as np

from ..lights import POINT
from .types import EMITTER, GLASS, GLOSSY, MIRROR, TEXTURED, Scene


def _fmt(a, nd=6) -> str:
    a = np.asarray(a, np.float32).reshape(-1)
    return " ".join(f"{x:.{nd}g}" for x in a)


def export_collada(scene: Scene, path: str | Path, *,
                   write_normals: bool = True) -> Path:
    """Write ``scene`` to ``path`` (.dae), its textures as PNGs beside it.

    ``write_normals=False`` leaves out the NORMAL inputs, so that the
    importer generates smooth normals (the aiProcess_GenSmoothNormals
    analog).
    """
    def host(t):
        return t.detach().cpu().numpy()

    path = Path(path)
    g = scene.geometry
    m = scene.materials
    v0 = host(g.tri_v0)
    v1 = v0 + host(g.tri_e1)
    v2 = v0 + host(g.tri_e2)
    n0, n1, n2 = (host(x) for x in (g.tri_n0, g.tri_n1, g.tri_n2))
    uv0, uv1, uv2 = (host(x) for x in (g.tri_uv0, g.tri_uv1, g.tri_uv2))
    tri_mat = host(g.tri_mat)
    kinds = host(m.kind)
    kd_all, em_all, kr_all, ks_all = (host(x) for x in (
        m.kd, m.emission, m.kr, m.ks))
    ior_all, exp_all, tex_all = (host(x) for x in (
        m.ior, m.exponent, m.texture_id))
    n_mats = kinds.shape[0]

    # --- texture images to disk ---
    images_xml, tex_files = [], {}
    if scene.has_textures:
        from PIL import Image
        textures = host(scene.textures)
        for t in range(textures.shape[0]):
            arr = np.clip(textures[t] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            fname = f"{path.stem}_tex{t}.png"
            Image.fromarray(arr, "RGB").save(path.parent / fname)
            tex_files[t] = fname
            images_xml.append(
                f'<image id="img{t}"><init_from>{escape(fname)}'
                f'</init_from></image>')

    # --- effects and materials ---
    effects, materials = [], []
    for i in range(n_mats):
        k = int(kinds[i])
        kd = kd_all[i]
        materials.append(f'<material id="mat{i}" name="mat{i}">'
                         f'<instance_effect url="#fx{i}"/></material>')
        if k == TEXTURED and int(tex_all[i]) in tex_files:
            t = int(tex_all[i])
            body = (
                f'<newparam sid="surf{t}"><surface type="2D">'
                f'<init_from>img{t}</init_from></surface></newparam>'
                f'<newparam sid="samp{t}"><sampler2D>'
                f'<source>surf{t}</source></sampler2D></newparam>')
            diff = (f'<diffuse><texture texture="samp{t}" texcoord="UV"/>'
                    f'</diffuse>')
            body += (f'<technique sid="common"><lambert>{diff}</lambert>'
                     f'</technique>')
            effects.append(f'<effect id="fx{i}"><profile_COMMON>{body}'
                           f'</profile_COMMON></effect>')
            continue
        if k == EMITTER:
            body = (f'<emission><color>{_fmt(em_all[i])} 1</color>'
                    f'</emission><diffuse><color>{_fmt(kd)} 1</color>'
                    f'</diffuse>')
        elif k == GLASS:
            body = (f'<transparent><color>1 1 1 1</color></transparent>'
                    f'<index_of_refraction><float>{float(ior_all[i]):.6g}'
                    f'</float></index_of_refraction>')
        elif k == MIRROR:
            body = (f'<reflective><color>{_fmt(kr_all[i])} 1</color>'
                    f'</reflective>')
        elif k == GLOSSY:
            body = (f'<diffuse><color>{_fmt(kd)} 1</color></diffuse>'
                    f'<specular><color>{_fmt(ks_all[i])} 1</color>'
                    f'</specular><shininess><float>'
                    f'{float(exp_all[i]):.6g}</float></shininess>')
        else:  # DIFFUSE, and TEXTURED without an image
            body = f'<diffuse><color>{_fmt(kd)} 1</color></diffuse>'
        effects.append(
            f'<effect id="fx{i}"><profile_COMMON><technique sid="common">'
            f'<phong>{body}</phong></technique></profile_COMMON></effect>')

    # --- one geometry; one <triangles> prim per material ---
    pos = np.stack([v0, v1, v2], axis=1).reshape(-1, 3)     # [3T,3]
    nrm = np.stack([n0, n1, n2], axis=1).reshape(-1, 3)
    uvs = np.stack([uv0, uv1, uv2], axis=1).reshape(-1, 2)

    prims = []
    for i in range(n_mats):
        faces = np.nonzero(tri_mat == i)[0]
        if faces.size == 0:
            continue
        vidx = (faces[:, None] * 3 + np.arange(3)[None, :]).reshape(-1)
        if write_normals:
            p = np.stack([vidx, vidx, vidx], axis=1).reshape(-1)
            inputs = (
                '<input semantic="VERTEX" source="#verts" offset="0"/>'
                '<input semantic="NORMAL" source="#nrm-src" offset="1"/>'
                '<input semantic="TEXCOORD" source="#uv-src" offset="2"/>')
        else:
            p = np.stack([vidx, vidx], axis=1).reshape(-1)
            inputs = (
                '<input semantic="VERTEX" source="#verts" offset="0"/>'
                '<input semantic="TEXCOORD" source="#uv-src" offset="1"/>')
        prims.append(
            f'<triangles material="sym{i}" count="{faces.size}">{inputs}'
            f'<p>{" ".join(map(str, p))}</p></triangles>')

    geometry = f"""<geometry id="geo0"><mesh>
<source id="pos-src"><float_array id="pos-arr" count="{3 * pos.shape[0]}">{_fmt(pos)}</float_array>
<technique_common><accessor source="#pos-arr" count="{pos.shape[0]}" stride="3"/></technique_common></source>
<source id="nrm-src"><float_array id="nrm-arr" count="{3 * nrm.shape[0]}">{_fmt(nrm)}</float_array>
<technique_common><accessor source="#nrm-arr" count="{nrm.shape[0]}" stride="3"/></technique_common></source>
<source id="uv-src"><float_array id="uv-arr" count="{2 * uvs.shape[0]}">{_fmt(uvs)}</float_array>
<technique_common><accessor source="#uv-arr" count="{uvs.shape[0]}" stride="2"/></technique_common></source>
<vertices id="verts"><input semantic="POSITION" source="#pos-src"/></vertices>
{"".join(prims)}
</mesh></geometry>"""

    binds = "".join(
        f'<instance_material symbol="sym{i}" target="#mat{i}"/>'
        for i in range(n_mats))

    # --- point lights (area lights come back from the emissive quads) ---
    lt = scene.lights
    lkind, lem = host(lt.kind), host(lt.emission)
    lights_xml = [
        f'<light id="pl{li}"><technique_common><point>'
        f'<color>{_fmt(lem[li])}</color></point></technique_common></light>'
        for li in range(lt.n_lights) if int(lkind[li]) == POINT]

    doc = f"""<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
<asset><up_axis>Y_UP</up_axis></asset>
<library_images>{"".join(images_xml)}</library_images>
<library_effects>{"".join(effects)}</library_effects>
<library_materials>{"".join(materials)}</library_materials>
<library_lights>{"".join(lights_xml)}</library_lights>
<library_geometries>{geometry}</library_geometries>
<library_visual_scenes><visual_scene id="scene0">
<node id="root"><instance_geometry url="#geo0">
<bind_material><technique_common>{binds}</technique_common></bind_material>
</instance_geometry></node>
</visual_scene></library_visual_scenes>
<scene><instance_visual_scene url="#scene0"/></scene>
</COLLADA>
"""
    path.write_text(doc)
    return path
