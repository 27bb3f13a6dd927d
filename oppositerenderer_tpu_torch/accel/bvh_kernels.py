"""Wide-BVH traversal: the counterpart of both
``oppositerenderer_tpu/accel/pallas_bvh.py`` (kernel B5, the packet
traversal) and the JAX package's wavefront ``accel/bvh.traverse``/
``traverse_any``.

``traverse`` (closest hit) and ``traverse_any`` (any hit) walk the unified
``Bvh.rows`` table (``accel/bvh.py``) with one stack per ray. For CUDA
tensors they launch the hand-written kernel of ``csrc/bvh.cu``; for CPU
tensors they run the plain versions ``traverse_plain`` and
``traverse_any_plain``. Each wrapper counts its traversal launches in a
``launches`` attribute. On the card each block of the kernel first
compacts the live lanes (``tmax > tmin``) of its 128 lanes and its
threads walk only those; :func:`compact_live` runs that compaction alone
(its plain version :func:`compact_live_plain`) so that it can be checked.

The plain version is the JAX wavefront's float32 loop (``bvh._run_until``)
as a masked lockstep loop in torch over the live lanes: a gathered
``[N, max_stack]`` stack instead of the one-hot one, and no compaction
ladder. Every lane visits rows in the kernel's order:

* refill: a lane whose cursor is dry pops ``(node << A) | remaining mask``;
* leaf: Moller-Trumbore over the leaf's triangles in index order; a hit
  counts only if ``tmin < t < t_best``, so the lowest index wins a tie; any
  hit takes only triangles whose occluder flag is > 0.5 and stops at the
  first;
* inner: the children in ``cmask & valid`` are slab-tested against the
  current ``t_best``; the cursor goes to the nearest (the lowest child index
  among equal entry distances) and ``(node << A) | rest`` is pushed when
  two or more children are hit; a popped node is slab-tested again.

Lanes with ``!(tmax > tmin)`` do not traverse and return t = min(tmax,
BIG), prim -1, u = v = 0, found False, as the wavefront's lanes do. The
kernel performs the same float32 operations in the same order (built with
``--fmad=false``), so on the card the two agree bit for bit.
"""
from __future__ import annotations

import torch

from .cuda_build import launch

BIG = 1e30
# the kernel's static stack (csrc/bvh.cu kMaxStack) and row layout
KERNEL_MAX_STACK = 32
KERNEL_ARITY = 8
ROW_WIDTH = 128
COMPACT_BLOCK = 128   # lanes per block of the kernel (csrc/bvh.cu kBlock)


def _check(bvh, o, d, tmin, tmax):
    n = o.shape[0]
    for name, a, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("tmin", tmin, (n,)), ("tmax", tmax, (n,)),
                           ("rows", bvh.rows, (bvh.rows.shape[0],
                                               ROW_WIDTH))):
        if a.device != o.device:
            raise ValueError(f"{name} is on {a.device}, o on {o.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bvh.arity != KERNEL_ARITY:
        raise ValueError(f"the kernel walks arity {KERNEL_ARITY} tables, "
                         f"got {bvh.arity}")
    if not 1 <= bvh.leaf_size <= 12:
        raise ValueError(f"leaf size {bvh.leaf_size} does not fit a row")
    if bvh.max_stack > KERNEL_MAX_STACK:
        raise ValueError(f"the tree needs a stack of {bvh.max_stack}, the "
                         f"kernel holds {KERNEL_MAX_STACK}")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def plain_traversal(bvh, o, d, tmin, tmax, any_hit: bool):
    """The plain version of both traversals: (t, prim, u, v, found,
    visits, row_floats). ``visits`` [N, 4] int64 counts per ray the inner
    rows and leaf rows it read, the child slab tests it made (the children
    in ``cmask & valid`` of each inner visit) and the triangles it tested
    (any hit: the flagged ones up to its first hit); ``row_floats`` [R]
    int64 holds, for each row any ray read, the floats of it a traversal
    uses (inner: 7 per valid child and the mask; leaf: 9 per triangle and
    the first prim id, or 10 per triangle with the flags for any hit), and
    0 for the rows no ray read."""
    n = o.shape[0]
    dev = o.device
    A = bvh.arity
    L = bvh.leaf_size
    full = (1 << A) - 1
    rows = bvh.rows
    rows_i = rows.view(torch.int32)
    n_rows = rows.shape[0]
    abits = torch.arange(A, dtype=torch.int32, device=dev)
    ks = torch.arange(L, device=dev)

    t_out = torch.minimum(tmax, torch.tensor(BIG, device=dev))
    prim_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros(n, device=dev)
    v_out = torch.zeros(n, device=dev)
    found_out = torch.zeros(n, dtype=torch.bool, device=dev)
    visits = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    row_floats = torch.zeros(n_rows, dtype=torch.int64, device=dev)

    # state of the live lanes only; finished lanes leave it
    lane = torch.nonzero(tmax > tmin)[:, 0]
    m = lane.shape[0]
    ro, rd, rtmin = o[lane], d[lane], tmin[lane]
    inv_d = 1.0 / torch.where(torch.abs(rd) < 1e-12, 1e-12, rd)
    t_best = t_out[lane]
    i_best = torch.full((m,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(m, device=dev)
    v_best = torch.zeros(m, device=dev)
    found = torch.zeros(m, dtype=torch.bool, device=dev)
    cur = torch.full((m,), bvh.root_code, dtype=torch.int32, device=dev)
    cmask = torch.full((m,), full, dtype=torch.int32, device=dev)
    cur_ok = torch.ones(m, dtype=torch.bool, device=dev)
    stack = torch.zeros((m, bvh.max_stack), dtype=torch.int32, device=dev)
    sp = torch.zeros(m, dtype=torch.int64, device=dev)
    vis = torch.zeros((m, 4), dtype=torch.int64, device=dev)

    while lane.shape[0] > 0:
        m = lane.shape[0]
        ar = torch.arange(m, device=dev)
        # refill the cursor from the stack where it ran dry
        need = ~cur_ok & (sp > 0)
        top = stack[ar, torch.clamp_min(sp - 1, 0)]
        cur = torch.where(need, top >> A, cur)
        cmask = torch.where(need, top & full, cmask)
        cur_ok = cur_ok | need
        sp = sp - need.long()

        is_leaf = cur < 0
        dec = -cur - 1
        row_idx = torch.where(is_leaf, dec >> 5, cur).clamp(0, n_rows - 1)
        vis[:, 0] += ~is_leaf
        vis[:, 1] += is_leaf

        # ---- leaves: Moller-Trumbore over the leaf's triangles ----------
        li = torch.nonzero(is_leaf)[:, 0]
        if li.shape[0] > 0:
            row = rows[row_idx[li]]
            count = (dec[li] & 31).long()
            row_floats[row_idx[li]] = count * (10 if any_hit else 9) + (
                0 if any_hit else 1)
            tri = row[:, :9 * L].reshape(-1, L, 9)
            cand = ks[None, :] < count[:, None]
            if any_hit:
                cand = cand & (row[:, 9 * L:10 * L] > 0.5)
            ox, oy, oz = (ro[li, k:k + 1] for k in range(3))
            dx, dy, dz = (rd[li, k:k + 1] for k in range(3))
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                tri[..., k] for k in range(9))
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            ok_det = torch.abs(det) > 1e-12
            inv_det = torch.where(ok_det, 1.0 / det, 0.0)
            tx = ox - v0x
            ty = oy - v0y
            tz = oz - v0z
            u = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            tb = t_best[li]
            ok = (cand & ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t > rtmin[li, None]) & (t < tb[:, None]))
            if any_hit:
                hit_any = torch.any(ok, dim=1)
                j = torch.where(hit_any, torch.argmax(ok.int(), dim=1), L)
                vis[li, 3] += (cand & (ks[None, :] <= j[:, None])).sum(dim=1)
                found[li] = found[li] | hit_any
            else:
                vis[li, 3] += count
                t = torch.where(ok, t, BIG)
                j = torch.argmin(t, dim=1)    # the lowest index among ties
                tj = torch.gather(t, 1, j[:, None])[:, 0]
                better = tj < tb
                first = row[:, 10 * L].to(torch.int32)
                t_best[li] = torch.where(better, tj, tb)
                i_best[li] = torch.where(better, first + j.to(torch.int32),
                                         i_best[li])
                u_best[li] = torch.where(
                    better, torch.gather(u, 1, j[:, None])[:, 0], u_best[li])
                v_best[li] = torch.where(
                    better, torch.gather(v, 1, j[:, None])[:, 0], v_best[li])
                found[li] = found[li] | better
            cur_ok[li] = False

        # ---- inner nodes: slab-test the children in cmask & valid -------
        ii = torch.nonzero(~is_leaf)[:, 0]
        if ii.shape[0] > 0:
            ni = ii.shape[0]
            row = rows[row_idx[ii]]
            rowi = rows_i[row_idx[ii]]
            ch = row[:, :6 * A].reshape(ni, A, 6)
            ob = ro[ii, None, :]
            idb = inv_d[ii, None, :]
            t0 = (ch[..., 0:3] - ob) * idb
            t1 = (ch[..., 3:6] - ob) * idb
            tn = torch.maximum(torch.amax(torch.minimum(t0, t1), -1),
                               rtmin[ii, None])
            tf = torch.minimum(torch.amin(torch.maximum(t0, t1), -1),
                               t_best[ii, None])
            valid = rowi[:, 7 * A]
            mbit = (((cmask[ii] & valid)[:, None] >> abits[None, :]) & 1) > 0
            vis[ii, 2] += mbit.sum(dim=1)
            n_valid = (((valid[:, None] >> abits[None, :]) & 1)).sum(dim=1)
            row_floats[row_idx[ii]] = 7 * n_valid.long() + 1
            hit = (tn <= tf) & mbit
            codes = rowi[:, 6 * A:7 * A]
            key = torch.where(hit, tn, BIG)
            j = torch.argmin(key, dim=1)      # the lowest child among ties
            oh = abits[None, :] == j[:, None]
            go = torch.gather(codes, 1, j[:, None])[:, 0]
            khits = hit.sum(dim=1)
            rem = torch.sum(torch.where(hit & ~oh, 1 << abits[None, :], 0),
                            dim=1).to(torch.int32)
            push = khits >= 2
            pi = ii[push]
            stack[pi, sp[pi]] = (cur[pi] << A) | rem[push]
            sp[pi] += 1
            cur[ii] = go
            cmask[ii] = full
            cur_ok[ii] = khits > 0

        # ---- lanes with nothing left to visit leave the loop ------------
        done = ~cur_ok & (sp == 0)
        if any_hit:
            done = done | found
        if bool(done.any()):
            out = lane[done]
            t_out[out] = t_best[done]
            prim_out[out] = i_best[done]
            u_out[out] = u_best[done]
            v_out[out] = v_best[done]
            found_out[out] = found[done]
            visits[out] = vis[done]
            keep = ~done
            (lane, ro, rd, rtmin, inv_d, t_best, i_best, u_best, v_best,
             found, cur, cmask, cur_ok, stack, sp, vis) = (
                a[keep] for a in (lane, ro, rd, rtmin, inv_d, t_best,
                                  i_best, u_best, v_best, found, cur, cmask,
                                  cur_ok, stack, sp, vis))
    return t_out, prim_out, u_out, v_out, found_out, visits, row_floats


def traverse_plain(bvh, o, d, tmin, tmax):
    """Plain PyTorch closest hit: (t [N] f32, prim [N] int32, u, v,
    found [N] bool)."""
    return plain_traversal(bvh, o, d, tmin, tmax, any_hit=False)[:5]


def traverse_any_plain(bvh, o, d, tmin, tmax):
    """Plain PyTorch any hit: found [N] bool."""
    return plain_traversal(bvh, o, d, tmin, tmax, any_hit=True)[4]


# ---------------------------------------------------------------------------
# wrappers (B5)
# ---------------------------------------------------------------------------

def _launch(name, bvh, o, d, tmin, tmax, outs):
    with torch.cuda.device(o.device):
        launch(name, bvh.rows.data_ptr(), bvh.rows.shape[0], bvh.root_code,
               bvh.leaf_size, o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
               tmax.data_ptr(), o.shape[0], *(a.data_ptr() for a in outs),
               torch.cuda.current_stream().cuda_stream)


def compact_live_plain(tmin, tmax):
    """Plain version of the kernel's lane compaction: the lanes in blocks
    of COMPACT_BLOCK; returns (live [B * COMPACT_BLOCK] int32, counts [B]
    int32), B = ceil(N / COMPACT_BLOCK): block b's lanes with
    ``tmax > tmin``, ascending, at ``live[b * COMPACT_BLOCK:][:counts[b]]``
    and -1 after them."""
    n = tmin.shape[0]
    nb = -(-n // COMPACT_BLOCK)
    live = torch.zeros(nb * COMPACT_BLOCK, dtype=torch.bool,
                       device=tmin.device)
    live[:n] = tmax > tmin
    live = live.reshape(nb, COMPACT_BLOCK)
    counts = live.sum(dim=1, dtype=torch.int32)
    pos = torch.cumsum(live, dim=1) - 1 + torch.arange(
        nb, device=tmin.device)[:, None] * COMPACT_BLOCK
    out = torch.full((nb * COMPACT_BLOCK,), -1, dtype=torch.int32,
                     device=tmin.device)
    out[pos[live]] = torch.arange(nb * COMPACT_BLOCK, dtype=torch.int32,
                                  device=tmin.device)[live.reshape(-1)]
    return out, counts


def compact_live(tmin, tmax):
    """The lane compaction every traversal launch does first, alone, in
    the format of :func:`compact_live_plain`. The plain version for CPU
    tensors."""
    if tmin.device.type == "cpu":
        return compact_live_plain(tmin, tmax)
    n = tmin.shape[0]
    nb = -(-n // COMPACT_BLOCK)
    live = torch.full((nb * COMPACT_BLOCK,), -1, dtype=torch.int32,
                      device=tmin.device)
    counts = torch.empty(nb, dtype=torch.int32, device=tmin.device)
    if n:
        with torch.cuda.device(tmin.device):
            launch("bvh_compact_live", tmin.data_ptr(), tmax.data_ptr(), n,
                   live.data_ptr(), counts.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    return live, counts


def traverse(bvh, o, d, tmin, tmax):
    """Closest hit through the BVH: (t [N] f32, prim [N] int32 (permuted
    triangle id, -1 on a miss), u [N], v [N], found [N] bool). The kernel
    for CUDA tensors, the plain version for CPU tensors; on both devices
    the inputs must meet the kernel's contract."""
    _check(bvh, o, d, tmin, tmax)
    if o.device.type == "cpu":
        return traverse_plain(bvh, o, d, tmin, tmax)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    found = torch.empty(n, dtype=torch.bool, device=o.device)
    if n == 0:
        return t, prim, u, v, found
    _launch("bvh_closest", bvh, o, d, tmin, tmax, (t, prim, u, v, found))
    traverse.launches += 1
    return t, prim, u, v, found


traverse.launches = 0


def traverse_any(bvh, o, d, tmin, tmax):
    """Any hit through the BVH against the triangles whose baked occluder
    flag is set: found [N] bool. The kernel for CUDA tensors, the plain
    version for CPU tensors; on both devices the inputs must meet the
    kernel's contract."""
    _check(bvh, o, d, tmin, tmax)
    if o.device.type == "cpu":
        return traverse_any_plain(bvh, o, d, tmin, tmax)
    found = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    if o.shape[0] == 0:
        return found
    _launch("bvh_any", bvh, o, d, tmin, tmax, (found,))
    traverse_any.launches += 1
    return found


traverse_any.launches = 0
