"""BVH: the host build of the wide traversal table.

The counterpart of the host half of ``oppositerenderer_tpu/accel/bvh.py``
(``Bvh``, ``build_bvh_arrays``, ``_collapse_wide``, ``_collapse_wide_sah``,
``_pack_wide``, ``build_scene_bvh``). Scenes above ``BVH_AUTO_THRESHOLD``
triangles get a BVH once, on the host: the native binned-SAH binary build
(``native/bvh_builder.cpp``; numpy median split where g++ is missing),
collapsed into an 8-wide tree by the float64 SAH dynamic program, with the
triangles permuted so that each leaf's are contiguous. The result is the
JAX package's unified ``rows`` table, array for array; traversal is
``bvh_kernels.traverse``/``traverse_any`` (kernel B5 on CUDA tensors).

The JAX package's int8 ``q_rows`` table and its code stack serve its TPU
wavefront only: the port's traversal keeps one (node, remaining-child
mask) stack entry per wide-tree level, so ``max_stack`` is depth + 1.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..core.math import Tensor

# triangle count above which the scene builders attach a BVH (the JAX
# package's scene/collada.py:56)
BVH_AUTO_THRESHOLD = 2048


@dataclasses.dataclass
class Bvh:
    """Flattened BVH.

    * The plain BINARY node arrays (nodes_min/max/a/b) from the builder,
      kept on the host for inspection and tests; traversal never reads
      them.
    * The WIDE traversal table ``rows`` [R, 128] float32, one row per wide
      inner node or leaf. Inner row (arity A): child c's bounds (min3,
      max3) at columns 6c..6c+5, the child codes at 6A+c and the valid-child
      mask at 7A, both int32 bit patterns (read them with
      ``.view(torch.int32)``, never a cast). Leaf row (L = leaf_size
      triangles): L x (v0, e1, e2) at 0..9L-1, the occluder flags at 9L+k,
      the first (permuted) prim id at 10L.

    Child codes: inner child = row index (>= 0); leaf child =
    ``-(row * 32 + count) - 1`` (count <= 31). ``builder`` says which
    binary build ran ("native" or "numpy"); None for a table from
    elsewhere.
    """

    nodes_min: Tensor  # [n,3] binary tree (builder output, host, tests)
    nodes_max: Tensor  # [n,3]
    nodes_a: Tensor    # [n] inner: left child; leaf: ~first_prim
    nodes_b: Tensor    # [n] inner: right child; leaf: prim count
    rows: Tensor | None = None   # [R, 128] unified wide node/leaf table
    root_code: int = 0
    arity: int = 8
    leaf_size: int = 6
    max_stack: int = 12
    builder: str | None = None


# ---------------------------------------------------------------------------
# host build
# ---------------------------------------------------------------------------

def _build_numpy(prim_min, prim_max, centroid, leaf_size):
    """Median-split fallback builder (same output contract as the C++)."""
    n = prim_min.shape[0]
    order = np.arange(n, dtype=np.int32)
    nodes_min, nodes_max, nodes_a, nodes_b = [], [], [], []

    def build(first, count):
        idx = order[first:first + count]
        bmin = prim_min[idx].min(axis=0)
        bmax = prim_max[idx].max(axis=0)
        node = len(nodes_a)
        nodes_min.append(bmin)
        nodes_max.append(bmax)
        nodes_a.append(0)
        nodes_b.append(0)
        if count <= leaf_size:
            nodes_a[node] = ~first
            nodes_b[node] = count
            return node
        cen = centroid[idx]
        axis = int(np.argmax(cen.max(axis=0) - cen.min(axis=0)))
        part = np.argsort(cen[:, axis], kind="stable")
        order[first:first + count] = idx[part]
        mid = first + count // 2
        left = build(first, mid - first)
        right = build(mid, first + count - mid)
        nodes_a[node] = left
        nodes_b[node] = right
        return node

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        build(0, n)
    finally:
        sys.setrecursionlimit(old)
    return (np.asarray(nodes_min, np.float32),
            np.asarray(nodes_max, np.float32),
            np.asarray(nodes_a, np.int32), np.asarray(nodes_b, np.int32),
            order)


def build_bvh_arrays(prim_min, prim_max, leaf_size: int = 16):
    """Build over primitive AABBs -> (Bvh with the binary node arrays on
    the host, order). Tries the native C++ binned-SAH builder first; numpy
    median-split fallback."""
    from ..native import build_bvh_native
    centroid = 0.5 * (prim_min + prim_max)
    out = build_bvh_native(prim_min, prim_max, centroid, leaf_size)
    builder = "native"
    if out is None:
        out = _build_numpy(np.asarray(prim_min), np.asarray(prim_max),
                           np.asarray(centroid), leaf_size)
        builder = "numpy"
    nmn, nmx, na, nb, order = out

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a))

    bvh = Bvh(nodes_min=t(nmn), nodes_max=t(nmx), nodes_a=t(na),
              nodes_b=t(nb), leaf_size=leaf_size, builder=builder)
    return bvh, np.asarray(order)


def _bitcast_i2f(x: np.ndarray) -> np.ndarray:
    return x.astype(np.int32).view(np.float32)


def _wide_depth(wide_children) -> int:
    depth = 1
    stack = [(0, 1)]
    while stack:
        wid, d = stack.pop()
        depth = max(depth, d)
        for kind, a, _, _ in wide_children[wid]:
            if kind == "inner":
                stack.append((a, d + 1))
    return depth


def _collapse_wide(nmn, nmx, na, nb, arity):
    """Collapse the binary SAH tree into wide nodes (host numpy).

    A wide node's child list starts as the binary root's two children and
    repeatedly replaces the INNER child with the largest surface area by its
    two binary children until ``arity`` children or all leaves: the
    standard greedy SAH collapse. Returns (wide_children, depth) where
    wide_children[i] is a list of ('leaf', first, count, b) |
    ('inner', wid, 0, b), b the binary node.
    """
    ext = np.maximum(nmx - nmn, 0.0)
    sa = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] \
        + ext[:, 2] * ext[:, 0]

    wide_children: list[list] = [None]
    # queue of (binary inner node -> wide id); binary root handled by caller
    todo = [(0, 0)]
    while todo:
        b, wid = todo.pop()
        kids = [int(na[b]), int(nb[b])]
        while len(kids) < arity:
            best, best_sa = -1, -1.0
            for i, k in enumerate(kids):
                if na[k] >= 0 and sa[k] > best_sa:
                    best, best_sa = i, sa[k]
            if best < 0:
                break
            k = kids.pop(best)
            kids.extend([int(na[k]), int(nb[k])])
        entry = []
        for k in kids:
            if na[k] < 0:
                entry.append(("leaf", int(~na[k]), int(nb[k]), k))
            else:
                nwid = len(wide_children)
                wide_children.append(None)
                todo.append((k, nwid))
                entry.append(("inner", nwid, 0, k))
        wide_children[wid] = entry
    return wide_children, _wide_depth(wide_children)


def _collapse_wide_sah(nmn, nmx, na, nb, arity, L, c_leaf=2.0):
    """SAH-cost-minimising wide collapse.

    Dynamic program over the binary SAH tree in the style of Ylitie et
    al. 2017 (compressed wide BVHs): ``C[n, i]`` is the cheapest expected
    traversal cost of representing subtree ``n`` as a forest of ``i``
    wide-node child slots::

        C[n, i>=2] = min_k C[left, k] + C[right, i-k]      (slot split)
        C[n, 1]    = min( leaf(n),  p(n)*c_node + C[n, A] )

    with p(n) = area(n)/area(root) the geometric visit probability and
    ``leaf(n) = p(n) * c_leaf`` whenever subtree n holds <= L primitives
    (contiguous in prim order by the builder's in-place partition). The
    float64 arithmetic is the JAX package's, so both packages pick the
    same tree. Returns the same (wide_children, depth) structure as
    ``_collapse_wide``.
    """
    n = na.shape[0]
    A = arity
    INF = np.float64(1e30)
    leaf_b = na < 0
    l = np.where(leaf_b, 0, na).astype(np.int64)  # noqa: E741
    r = np.where(leaf_b, 0, nb).astype(np.int64)
    ext = np.maximum(nmx - nmn, 0.0).astype(np.float64)
    sa = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
          + ext[:, 2] * ext[:, 0])
    p = sa / max(float(sa[0]), 1e-30)

    # prim ranges (contiguous per subtree) + level schedule, leaves up
    first = np.where(leaf_b, ~na, 0).astype(np.int64)
    count = np.where(leaf_b, nb, 0).astype(np.int64)
    done = leaf_b.copy()
    batches = []
    while not done.all():
        ready = ~done & done[l] & done[r]
        idx = np.nonzero(ready)[0]
        batches.append(idx)
        first[idx] = first[l[idx]]
        count[idx] = count[l[idx]] + count[r[idx]]
        done[ready] = True

    C = np.full((n, A + 1), INF)
    K = np.zeros((n, A + 1), np.int8)    # best split; 0 = single root
    leaf_ok = count <= min(L, 31)
    is_leaf_choice = leaf_b.copy()       # slot-root becomes a leaf row
    C[leaf_b, 1:] = (p[leaf_b] * c_leaf)[:, None]
    for idx in batches:
        cl, cr = C[l[idx]], C[r[idx]]    # [B, A+1]
        for i in range(2, A + 1):
            ks = np.arange(1, i)
            cand = cl[:, ks] + cr[:, i - ks]         # [B, i-1]
            j = np.argmin(cand, axis=1)
            C[idx, i] = cand[np.arange(len(idx)), j]
            K[idx, i] = (j + 1).astype(np.int8)
        cost_int = p[idx] + C[idx, A]
        cost_leaf = np.where(leaf_ok[idx], p[idx] * c_leaf, INF)
        pick_leaf = cost_leaf <= cost_int
        C[idx, 1] = np.where(pick_leaf, cost_leaf, cost_int)
        is_leaf_choice[idx] = pick_leaf
        # a forest of i roots may always collapse to a single root
        for i in range(2, A + 1):
            better = C[idx, 1] < C[idx, i]
            C[idx, i] = np.where(better, C[idx, 1], C[idx, i])
            K[idx, i] = np.where(better, np.int8(0), K[idx, i])

    def collect(b, i):
        """Slot roots of subtree b distributed over i slots (iterative)."""
        out, stack = [], [(int(b), int(i))]
        while stack:
            bb, ii = stack.pop()
            k = int(K[bb, ii]) if ii > 1 else 0
            if k == 0:
                out.append(bb)
            else:
                # right first so left's slots come out first
                stack.append((int(r[bb]), ii - k))
                stack.append((int(l[bb]), k))
        return out

    wide_children: list[list] = [None]
    todo = [(0, 0)]
    while todo:
        b, wid = todo.pop()
        entry = []
        for s in collect(b, A):
            if is_leaf_choice[s]:
                entry.append(("leaf", int(first[s]), int(count[s]), s))
            else:
                if s == b:
                    raise RuntimeError("internal single-root collapse cycle")
                nwid = len(wide_children)
                wide_children.append(None)
                todo.append((s, nwid))
                entry.append(("inner", nwid, 0, s))
        wide_children[wid] = entry
    return wide_children, _wide_depth(wide_children)


def _row_width(arity: int) -> int:
    """Unified row width: 128 float32 columns at arity 8 (an inner row
    needs 7A + 1 = 57), so a leaf row holds 12 triangles."""
    return max(128, -(-(7 * arity + 1) // 8) * 8)


def _fill_leaf_row(rows, r, first, count, tri9_perm, occluder, L):
    n_tris = tri9_perm.shape[0]
    k = np.arange(L)
    idx = np.minimum(first + k, n_tris - 1)
    valid = k < count
    rows[r, :9 * L] = np.where(valid[:, None], tri9_perm[idx],
                               0.0).reshape(-1)
    rows[r, 9 * L:10 * L] = np.where(valid, occluder[idx], 0.0)
    rows[r, 10 * L] = np.float32(first)


def _pack_wide(nmn, nmx, na, nb, tri9_perm, occluder, arity, L,
               collapse: str = "greedy", c_leaf: float = 2.0):
    """Pack the collapsed wide tree into the unified row table. ``L`` is
    the leaf triangle capacity (also the column layout of leaf rows).
    ``collapse``: 'sah' = DP cost-minimising (_collapse_wide_sah), 'greedy'
    = max-area expansion (_collapse_wide). Returns (rows, root_code,
    depth, n_wide)."""
    W = _row_width(arity)
    n_tris = tri9_perm.shape[0]
    if n_tris >= (1 << 24):
        raise ValueError("first-prim ids must be exact in float32")

    if na[0] < 0:  # whole scene is one binary leaf
        first, count = int(~na[0]), int(nb[0])
        if count > L:
            raise ValueError(f"one leaf of {count} > {L} triangles")
        rows = np.zeros((1, W), np.float32)
        _fill_leaf_row(rows, 0, first, count, tri9_perm, occluder, L)
        return rows, -(0 * 32 + count) - 1, 1, 0

    if collapse == "sah":
        wide_children, depth = _collapse_wide_sah(nmn, nmx, na, nb,
                                                  arity, L, c_leaf)
    else:
        wide_children, depth = _collapse_wide(nmn, nmx, na, nb, arity)
    n_wide = len(wide_children)
    n_leaf = sum(1 for ch in wide_children for c in ch if c[0] == "leaf")
    # stack entries pack (node << A) | mask into an int32
    if n_wide >= (1 << (30 - arity)):
        raise ValueError("too many wide nodes for the stack packing")
    rows = np.zeros((n_wide + n_leaf, W), np.float32)

    leaf_row = n_wide
    for wid, ch in enumerate(wide_children):
        valid = 0
        for i, (kind, a, cnt, b) in enumerate(ch):
            rows[wid, 6 * i:6 * i + 3] = nmn[b]
            rows[wid, 6 * i + 3:6 * i + 6] = nmx[b]
            valid |= 1 << i
            if kind == "inner":
                code = a
            else:
                _fill_leaf_row(rows, leaf_row, a, cnt, tri9_perm,
                               occluder, L)
                code = -(leaf_row * 32 + cnt) - 1
                leaf_row += 1
            rows[wid, 6 * arity + i] = _bitcast_i2f(np.asarray([code]))[0]
        rows[wid, 7 * arity] = _bitcast_i2f(np.asarray([valid]))[0]
    return rows, 0, depth, n_wide


def build_scene_bvh(scene, leaf_size: int | None = None, arity: int = 8,
                    collapse: str = "sah", c_leaf: float = 2.0):
    """Returns (scene-with-permuted-triangles, Bvh), the table on the
    scene's device. ``collapse`` 'greedy' exists for parity with the JAX
    package's option; the scenes take 'sah'. Spheres stay dense (their count is tiny in every reference scene).
    The leaf size follows from the 128-column row: 12 triangles at arity 8
    (``leaf_size`` may lower it)."""
    from ..scene.types import EMITTER
    W = _row_width(arity)
    L = (W - 1) // 10
    if leaf_size is not None:
        L = min(L, leaf_size)
    g = scene.geometry
    device = scene.device
    v0 = g.tri_v0.cpu().numpy()
    v1 = v0 + g.tri_e1.cpu().numpy()
    v2 = v0 + g.tri_e2.cpu().numpy()
    pmin = np.minimum(np.minimum(v0, v1), v2)
    pmax = np.maximum(np.maximum(v0, v1), v2)
    # the DP collapse wants fine binary granularity (it decides leaf
    # boundaries itself); the greedy collapse consumes builder leaves
    bvh, order = build_bvh_arrays(pmin, pmax,
                                  2 if collapse == "sah" else L)
    perm = torch.as_tensor(order.astype(np.int64), device=device)
    geom = dataclasses.replace(g, **{
        f: getattr(g, f)[perm] for f in (
            "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
            "tri_uv0", "tri_uv1", "tri_uv2", "tri_tangent", "tri_bitangent",
            "tri_mat")})

    # pack the table from the PERMUTED triangles; occluder flags are baked
    # (emitter surfaces never occlude: DiffuseEmitter.cu:63-68)
    tri9 = np.concatenate([geom.tri_v0.cpu().numpy(),
                           geom.tri_e1.cpu().numpy(),
                           geom.tri_e2.cpu().numpy()], axis=1)   # [T, 9]
    is_em = (scene.materials.kind.cpu().numpy()[geom.tri_mat.cpu().numpy()]
             == EMITTER)
    rows, root_code, depth, _ = _pack_wide(
        bvh.nodes_min.numpy(), bvh.nodes_max.numpy(),
        bvh.nodes_a.numpy(), bvh.nodes_b.numpy(),
        tri9, (~is_em).astype(np.float32), arity, L,
        collapse=collapse, c_leaf=c_leaf)
    bvh = dataclasses.replace(
        bvh, rows=torch.as_tensor(rows, device=device), root_code=root_code,
        arity=arity, leaf_size=L, max_stack=depth + 1)
    return dataclasses.replace(scene, geometry=geom), bvh
