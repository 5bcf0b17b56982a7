"""Möller–Trumbore ray-triangle intersection, vectorized.

The reference snapshot contains no ray-tracing code (SURVEY §0) — this is
the designed-from-scratch RT extension the north star names, built by
analogy with the raster path: fixed-function intersection math (this
module), a traversal unit (rt.bvh), and a shading loop (rt.tracer) that
reuses the texture/OM stages.

Layout: rays and triangles are structure-of-arrays float32; the brute-force
closest-hit here is the correctness oracle for the BVH traversal (the same
jnp-reference ↔ optimized-path pattern as ref ↔ deferred, SURVEY §4.2;
the GPU traversal kernel, ops.traverse, is tested against it).
"""
from __future__ import annotations

import jax.numpy as jnp

F32 = jnp.float32
I32 = jnp.int32

EPS = 1e-9


def moller_trumbore(orig, direction, v0, e1, e2, t_min=1e-4, t_max=jnp.inf):
    """Batched Möller–Trumbore.

    orig, direction: (..., 3); v0, e1, e2: (..., 3) broadcastable triangle
    data (v0 = first vertex, e1 = v1-v0, e2 = v2-v0).
    Returns (hit bool, t, u, v) with barycentrics u, v of the hit point
    (p = v0 + u*e1 + v*e2).  Backfaces hit too (two-sided, like the raster
    path which renders both windings — gfxutil.cpp:62-72).
    """
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    valid = jnp.abs(det) > EPS
    inv_det = jnp.where(valid, 1.0 / jnp.where(valid, det, 1.0), 0.0)

    tvec = orig - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det

    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return hit, t, u, v


def closest_hit_bruteforce(orig, direction, v0, e1, e2,
                           t_min=1e-4, t_max=jnp.inf):
    """All-pairs closest hit: rays (R, 3) x triangles (P, 3).

    Returns (prim_id (R,) int32 [-1 = miss], t, u, v).  O(R*P) — the
    correctness oracle and the fast path for small scenes (dense compute
    maps onto vector lanes with zero divergence).
    """
    hit, t, u, v = moller_trumbore(
        orig[:, None, :], direction[:, None, :],
        v0[None], e1[None], e2[None], t_min, t_max,
    )  # all (R, P)
    t_masked = jnp.where(hit, t, jnp.inf)
    best = jnp.argmin(t_masked, axis=1)
    r = jnp.arange(orig.shape[0])
    best_t = t_masked[r, best]
    found = jnp.isfinite(best_t)
    prim = jnp.where(found, best, -1).astype(I32)
    return (prim,
            jnp.where(found, best_t, jnp.inf),
            jnp.where(found, u[r, best], 0.0),
            jnp.where(found, v[r, best], 0.0))


def any_hit_bruteforce(orig, direction, v0, e1, e2, t_min=1e-4, t_max=1.0):
    """Occlusion query (shadow rays): does anything block [t_min, t_max)?"""
    hit, _, _, _ = moller_trumbore(
        orig[:, None, :], direction[:, None, :],
        v0[None], e1[None], e2[None], t_min, t_max,
    )
    return jnp.any(hit, axis=1)


def triangle_arrays(verts, faces):
    """(V,3) verts + (P,3) faces -> (v0, e1, e2) arrays for MT."""
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    return v0, v1 - v0, v2 - v0
