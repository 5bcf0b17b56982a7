"""BVH traversal kernel for the GPU (Pallas, lowered through Triton).

One ray per lane, BLOCK rays per program.  Each lane walks the
preorder + escape-link node arrays of ``rt.bvh.BVH.as_stackless_arrays``
on its own — the node pointer and the running best hit live in
registers, so divergent rays cost a lane its own path length and nothing
more.  A program leaves its loop when its last lane is done.  Node boxes
and triangles are gathered from device memory; the triangles are stored
in leaf order, so a leaf's primitives are one contiguous record range.

One body serves three modes:

  closest  lexicographic (t, prim) minimum hit in (t_min, t_max)
  any      a lane leaves the walk at its first hit in (t_min, t_max)
  after    lexicographic (t, prim) minimum strictly after a per-ray
           (t_lo, prim_lo) bound — repeated calls, each fed the previous
           result, enumerate every hit along a ray exactly once, exact-t
           ties included (the K-slot enumeration of rt.frame)

The plain references are rt.bvh.closest_hit_stackless /
any_hit_stackless (the same walk in lockstep over the whole batch, in
XLA) and rt.intersect's brute-force all-pairs tests.  Box and triangle
arithmetic is shared with the stackless walk (rt.bvh.ROBUST_FAR and
intersect.EPS), so both agree hit for hit.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..rt import intersect
from ..rt.bvh import LEAF_SIZE, ROBUST_FAR

F32 = jnp.float32
I32 = jnp.int32

MODES = ("closest", "any", "after")
#: node record widths in the packed arrays (see prepare_scene)
NODE_F = 8          # min.xyz max.xyz pad pad
NODE_I = 4          # first count escape pad
TRI_F = 12          # v0.xyz e1.xyz e2.xyz pad pad pad
#: rays per program and warps per program (one ray per lane): one warp
#: per program leaves the loop as soon as its own 32 rays are done —
#: fastest of 32/64/128 rays on the north-star frame (PERF.md)
BLOCK = 32
NUM_WARPS = 1


def prepare_scene(stackless_arrays, tri_arrays, leaf_size: int = LEAF_SIZE):
    """Pack a scene for the kernel (device arrays; jit-traceable).

    stackless_arrays: BVH.as_stackless_arrays(); tri_arrays: (v0, e1, e2)
    in ORIGINAL primitive order.  Returns a dict of flat arrays: node
    boxes (N * NODE_F,) f32, node links (N * NODE_I,) i32, triangle
    records in leaf order (P * TRI_F,) f32 and their original ids (P,).
    """
    nmin, nmax, nfirst, ncount, escape, prim_order = stackless_arrays
    v0, e1, e2 = tri_arrays
    n = nmin.shape[0]
    zf = jnp.zeros((n, NODE_F - 6), F32)
    nodes_f = jnp.concatenate([nmin.astype(F32), nmax.astype(F32), zf], 1)
    nodes_i = jnp.stack([nfirst, ncount, escape, jnp.zeros_like(nfirst)],
                        1).astype(I32)
    order = prim_order.astype(I32)
    rec = jnp.concatenate(
        [v0[order], e1[order], e2[order],
         jnp.zeros((order.shape[0], TRI_F - 9), F32)], 1).astype(F32)
    return {"nodes_f": nodes_f.reshape(-1), "nodes_i": nodes_i.reshape(-1),
            "tris": rec.reshape(-1), "tri_prim": order,
            "num_nodes": n, "leaf_size": leaf_size}


def _make_kernel(mode: str, num_nodes: int, leaf_size: int, t_min: float):
    N = num_nodes

    def kernel(nodes_f, nodes_i, tris, tri_prim,
               ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmax_ref,
               *rest):
        if mode == "after":
            tlo_ref, plo_ref, *outs = rest
            tlo = tlo_ref[...]
            plo = plo_ref[...]
        else:
            outs = rest
        o = (ox_ref[...], oy_ref[...], oz_ref[...])
        d = (dx_ref[...], dy_ref[...], dz_ref[...])
        tmax = tmax_ref[...]
        inv = []
        for c in d:
            safe = jnp.abs(c) > 1e-12
            inv.append(jnp.where(safe, 1.0 / jnp.where(safe, c, 1.0), 1e30))

        def gather(ref, idx, mask, other):
            return plgpu.load(ref.at[idx], mask=mask, other=other)

        def cond(state):
            return jnp.min(state[0]) < N

        def body(state):
            node, best_t, best_p, best_u, best_v = state
            active = node < N
            nc = jnp.minimum(node, N - 1)
            fb = nc * NODE_F
            tn = jnp.zeros_like(tmax)
            tf = jnp.full_like(tmax, jnp.inf)
            for a in range(3):
                lo = gather(nodes_f, fb + a, active, 0.0)
                hi = gather(nodes_f, fb + 3 + a, active, 0.0)
                t0 = (lo - o[a]) * inv[a]
                t1 = (hi - o[a]) * inv[a]
                tn = jnp.maximum(tn, jnp.minimum(t0, t1))
                tf = jnp.minimum(tf, jnp.maximum(t0, t1))
            far = tmax if mode == "any" else best_t
            hit_box = active & (tn <= jnp.minimum(tf, far) * ROBUST_FAR)

            ib = nc * NODE_I
            first = gather(nodes_i, ib, active, 0)
            cnt = gather(nodes_i, ib + 1, active, 0)
            esc = gather(nodes_i, ib + 2, active, N)
            is_leaf = cnt > 0
            in_leaf = hit_box & is_leaf
            done = jnp.zeros_like(active)
            for k in range(leaf_size):
                valid = in_leaf & (k < cnt)
                j = first + k
                rb = j * TRI_F
                tv = [gather(tris, rb + c, valid, 0.0) for c in range(9)]
                v0, e1, e2 = tv[0:3], tv[3:6], tv[6:9]
                # Möller–Trumbore, the same operation order as
                # rt.intersect.moller_trumbore
                px = d[1] * e2[2] - d[2] * e2[1]
                py = d[2] * e2[0] - d[0] * e2[2]
                pz = d[0] * e2[1] - d[1] * e2[0]
                det = e1[0] * px + e1[1] * py + e1[2] * pz
                ok = jnp.abs(det) > intersect.EPS
                inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
                sx = o[0] - v0[0]
                sy = o[1] - v0[1]
                sz = o[2] - v0[2]
                u = (sx * px + sy * py + sz * pz) * inv_det
                qx = sy * e1[2] - sz * e1[1]
                qy = sz * e1[0] - sx * e1[2]
                qz = sx * e1[1] - sy * e1[0]
                v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
                t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
                h = (valid & ok & (u >= 0.0) & (v >= 0.0)
                     & (u + v <= 1.0) & (t > t_min) & (t < tmax))
                if mode == "any":
                    done = done | h
                    continue
                pid = gather(tri_prim, j, valid, 0)
                h = h & ((t < best_t) | ((t == best_t) & (pid < best_p)))
                if mode == "after":
                    h = h & ((t > tlo) | ((t == tlo) & (pid > plo)))
                best_t = jnp.where(h, t, best_t)
                best_p = jnp.where(h, pid, best_p)
                best_u = jnp.where(h, u, best_u)
                best_v = jnp.where(h, v, best_v)
            nxt = jnp.where(hit_box & ~is_leaf, node + 1, esc)
            node = jnp.where(active & ~done, nxt, N)
            if mode == "any":
                best_p = jnp.where(done, 0, best_p)
            return node, best_t, best_p, best_u, best_v

        zero = jnp.zeros_like(tmax)
        state = (jnp.zeros(tmax.shape, I32), tmax,
                 jnp.full(tmax.shape, -1, I32), zero, zero)
        _, best_t, best_p, best_u, best_v = jax.lax.while_loop(
            cond, body, state)
        outs[0][...] = best_p
        if mode != "any":
            outs[1][...] = best_t
            outs[2][...] = best_u
            outs[3][...] = best_v

    return kernel


@functools.partial(jax.jit, static_argnames=(
    "mode", "num_nodes", "leaf_size", "t_min", "interpret"))
def _traverse_call(nodes_f, nodes_i, tris, tri_prim, rays, *, mode,
                   num_nodes, leaf_size, t_min, interpret):
    rp = rays[0].shape[0]
    kernel = _make_kernel(mode, num_nodes, leaf_size, t_min)
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    n_out = 1 if mode == "any" else 4
    out_shape = [jax.ShapeDtypeStruct((rp,), I32)] + [
        jax.ShapeDtypeStruct((rp,), F32)] * (n_out - 1)
    return pl.pallas_call(
        kernel,
        grid=(rp // BLOCK,),
        in_specs=[whole] * 4 + [ray_spec] * len(rays),
        out_specs=[ray_spec] * n_out,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=f"bvh_{mode}",
    )(nodes_f, nodes_i, tris, tri_prim, *rays)


def traverse(scene, orig, direction, mode: str = "closest",
             t_min: float = 1e-4, t_max=None, t_lo=None, prim_lo=None,
             interpret: bool = False):
    """Walk the rays (R, 3) through a prepare_scene() scene.

    t_max: None (no bound), a scalar or (R,) per-ray upper bounds.
    t_lo / prim_lo: (R,) lexicographic lower bound for mode="after"
    (start an enumeration at (-inf, -1)).
    Returns (prim (R,) i32 original ids [-1 miss], t [inf miss], u, v)
    for closest/after, and occluded (R,) bool for any.
    """
    if mode not in MODES:
        raise ValueError(f"unknown traversal mode {mode!r}")
    if (mode == "after") != (t_lo is not None and prim_lo is not None):
        raise ValueError("t_lo/prim_lo are required by, and only by, "
                         "mode='after'")
    R = orig.shape[0]
    rp = max(-(-R // BLOCK), 1) * BLOCK
    pad = rp - R

    def col(x, fill, dtype=F32):
        x = jnp.broadcast_to(jnp.asarray(x, dtype), (R,))
        return jnp.pad(x, (0, pad), constant_values=fill) if pad else x

    tm = jnp.inf if t_max is None else t_max
    # padding lanes get t_max = -1: the root box test fails, so they
    # leave on the first iteration
    rays = [col(orig[:, a], 0.0) for a in range(3)]
    rays += [col(direction[:, a], 1.0) for a in range(3)]
    rays.append(col(tm, -1.0))
    if mode == "after":
        rays += [col(t_lo, jnp.inf), col(prim_lo, 2 ** 30, I32)]
    outs = _traverse_call(
        scene["nodes_f"], scene["nodes_i"], scene["tris"],
        scene["tri_prim"], tuple(rays), mode=mode,
        num_nodes=scene["num_nodes"], leaf_size=scene["leaf_size"],
        t_min=float(t_min), interpret=interpret)
    if mode == "any":
        return outs[0][:R] >= 0
    prim = outs[0][:R]
    miss = prim < 0
    return (prim, jnp.where(miss, jnp.inf, outs[1][:R]),
            jnp.where(miss, 0.0, outs[2][:R]),
            jnp.where(miss, 0.0, outs[3][:R]))
