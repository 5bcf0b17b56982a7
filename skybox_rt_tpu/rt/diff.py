"""Differentiable ray tracing (north-star configs 2-4: pixel gradients
through the RT path w.r.t. vertex positions and materials).

Policy (the RT analog of diff/pipeline's discrete-step policy):
  * WHICH primitive a ray hits is discrete — the BVH traversal runs under
    stop_gradient and returns prim ids only
  * WHERE it hits is continuous — t, u, v are *recomputed* from the winning
    primitive with the closed-form Möller–Trumbore solve, so gradients flow
    to ray origin/direction and to the triangle vertices
  * silhouette (visibility) gradients are out of scope for the HARD path,
    exactly as in the raster pipeline's hard-coverage mode; finite-diff
    validation excludes pixels whose winner changes
  * the SOFT path (render_lambert_soft, round 5 — the RT twin of the
    raster pipeline's soft_edge_temp mode) composites the top-K
    plane-hit candidates per ray with sigmoid boundary weights and
    front-to-back transmittance, so visibility IS differentiable:
    gradients move object silhouettes (BASELINE.json configs[3] "pixel
    grads w.r.t. vertex pos" including the visibility term), FD-validated
    at winner-change pixels in tests/test_rt_diff.py

This mirrors how diff/pipeline reuses the binning winner: discrete
selection forward-exact, continuous attributes differentiable.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import bvh as bvh_mod
from . import intersect

F32 = jnp.float32


def solve_hit(o, d, v0, e1, e2):
    """Differentiable Möller–Trumbore solve for known-hit pairs.

    o, d, v0, e1, e2: (..., 3).  Returns (t, u, v); no validity checks —
    callers mask with the traversal's hit mask."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    return t, u, v


def closest_hit_diff(verts, faces, o, d, bvh_arrays=None,
                     t_min=1e-4, t_max=jnp.inf,
                     leaf_size=bvh_mod.LEAF_SIZE):
    """Differentiable closest hit.

    verts: (V, 3) traced (gradients flow); faces: (P, 3) static int.
    Returns (prim (R,) i32 stop-grad, t, u, v differentiable).
    Uses the BVH when bvh_arrays given (pass leaf_size=bvh.leaf_size when
    the tree was built with a non-default capacity), else brute force
    (also fine for grads since prim selection is detached either way)."""
    tri = intersect.triangle_arrays(verts, faces)
    tri_ng = tuple(jax.lax.stop_gradient(a) for a in tri)
    o_ng = jax.lax.stop_gradient(o)
    d_ng = jax.lax.stop_gradient(d)

    if bvh_arrays is not None:
        prim, _, _, _ = bvh_mod.closest_hit(bvh_arrays, tri_ng, o_ng, d_ng,
                                            t_min, t_max,
                                            leaf_size=leaf_size)
    else:
        prim, _, _, _ = intersect.closest_hit_bruteforce(
            o_ng, d_ng, *tri_ng, t_min, t_max)

    p = jnp.maximum(prim, 0)
    v0, e1, e2 = (a[p] for a in tri)
    t, u, v = solve_hit(o, d, v0, e1, e2)
    hit = prim >= 0
    return (prim,
            jnp.where(hit, t, jnp.inf),
            jnp.where(hit, u, 0.0),
            jnp.where(hit, v, 0.0))


def render_depth(verts, faces, o, d, bvh_arrays=None, background=0.0):
    """Minimal differentiable RT image: hit distance per ray (the quantity
    inverse-geometry losses use).  Returns (R,) f32."""
    prim, t, u, v = closest_hit_diff(verts, faces, o, d, bvh_arrays)
    return jnp.where(prim >= 0, t, background)


def render_lambert_smooth(verts, faces, normals, vert_colors, o, d,
                          light_dir, bvh_arrays=None, ambient=0.1,
                          background=(0., 0., 0.)):
    """Differentiable RT with interpolated vertex normals: gradients flow
    to `normals` (the north-star 'grads w.r.t. normals' axis), to verts
    (hit position + barycentrics), and to vert_colors."""
    prim, t, u, v = closest_hit_diff(verts, faces, o, d, bvh_arrays)
    hit = prim >= 0
    p = jnp.maximum(prim, 0)
    f = faces[p]
    w = (1.0 - u - v)

    def interp(a):
        return (a[f[:, 0]] * w[:, None] + a[f[:, 1]] * u[:, None]
                + a[f[:, 2]] * v[:, None])

    albedo = interp(vert_colors)[:, :3]
    n = interp(normals)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    n = jnp.where(jnp.sum(n * d, -1, keepdims=True) > 0, -n, n)

    l = jnp.asarray(light_dir, F32)
    l = l / jnp.linalg.norm(l)
    ndotl = jnp.maximum(jnp.sum(n * l, -1), 0.0)
    rgb = albedo * (ambient + ndotl[:, None])
    return jnp.where(hit[:, None], rgb, jnp.asarray(background, F32))


def topk_plane_hits(verts, faces, o, d, K: int, t_min=1e-4, t_max=jnp.inf,
                    margin: float = 0.2):
    """Stop-gradient candidate enumeration for the soft path.

    Intersects every ray with every primitive's support PLANE (not the
    bounded triangle) and keeps candidates whose barycentric boundary
    distance min(u, v, 1-u-v) > -margin — so near-miss primitives just
    outside a ray's footprint are candidates too, which is what lets the
    soft weights carry gradients ACROSS the silhouette (a hit-only
    enumeration would zero the gradient one pixel outside the edge).
    Returns (R, K) i32 prim ids in ascending-t order, -1 = none.

    Brute force over (R, P) — the soft path targets inverse-rendering
    scenes (small P, small images); selection is discrete and detached
    either way, so a kernel-accelerated enumeration
    (ops.traverse, mode='after') can replace this for large
    scenes without touching the gradient math.
    """
    tri = intersect.triangle_arrays(verts, faces)
    v0, e1, e2 = (jax.lax.stop_gradient(a) for a in tri)
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)

    pvec = jnp.cross(d[:, None, :], e2[None])            # (R, P, 3)
    det = jnp.sum(e1[None] * pvec, axis=-1)
    valid = jnp.abs(det) > 1e-12
    inv = 1.0 / jnp.where(valid, det, 1.0)
    tvec = o[:, None, :] - v0[None]
    u = jnp.sum(tvec * pvec, -1) * inv
    qvec = jnp.cross(tvec, e1[None])
    v = jnp.sum(d[:, None, :] * qvec, -1) * inv
    t = jnp.sum(e2[None] * qvec, -1) * inv
    bdist = jnp.minimum(jnp.minimum(u, v), 1.0 - u - v)
    cand = valid & (bdist > -margin) & (t > t_min) & (t < t_max)
    key = jnp.where(cand, t, jnp.inf)
    k = min(K, key.shape[1])
    negt, idx = jax.lax.top_k(-key, k)                   # ascending t
    prim = jnp.where(jnp.isfinite(negt), idx, -1).astype(jnp.int32)
    if k < K:
        prim = jnp.pad(prim, ((0, 0), (0, K - k)), constant_values=-1)
    return prim


def render_lambert_soft(verts, faces, vert_colors, o, d, light_dir,
                        K: int = 4, temp: float = 0.02,
                        margin: float = 0.2, ambient: float = 0.1,
                        t_min=1e-4, shade_smooth: float = 0.05,
                        background=(0., 0., 0.)):
    """Differentiable RT render WITH silhouette gradients (the RT twin
    of diff/pipeline's soft_edge_temp mode, VERDICT r4 #6).

    Per ray, the K nearest plane-hit candidates (topk_plane_hits,
    detached) are re-solved differentiably and composited front-to-back
    with sigmoid coverage weights

        w_k = sigmoid(min(u, v, 1-u-v) / temp)

    and transmittance prod_{j<k}(1 - w_j); the remaining transmittance
    takes the background.  w is ~1 inside a triangle, ~0 beyond the
    margin, and smooth across the edge, so d(image)/d(vertex) includes
    the visibility term — moving a vertex moves the silhouette.
    The Lambert clamp is softplus-smoothed (shade_smooth) so the image
    is C^1 through the terminator too — max(n.l, 0) kinks otherwise
    break FD validation at terminator-adjacent candidates.
    temp -> 0, shade_smooth -> 0 recover the hard image away from
    edges.  Returns (R, 3).
    """
    prim_k = topk_plane_hits(verts, faces, o, d, K, t_min=t_min,
                             margin=margin)
    tri = intersect.triangle_arrays(verts, faces)
    l = jnp.asarray(light_dir, F32)
    l = l / jnp.linalg.norm(l)

    R = o.shape[0]
    rgb = jnp.zeros((R, 3), F32)
    trans = jnp.ones((R,), F32)
    for k in range(K):
        prim = prim_k[:, k]
        live = prim >= 0
        p = jnp.maximum(prim, 0)
        v0, e1, e2 = (a[p] for a in tri)
        t, u, v = solve_hit(o, d, v0, e1, e2)
        bdist = jnp.minimum(jnp.minimum(u, v), 1.0 - u - v)
        # smoothstep cutoff that reaches EXACTLY 0 at bdist = -margin:
        # candidates enter/leave the detached top-K set with zero weight
        # and C^1 continuity, so set-membership changes under
        # perturbation cause no jump in the composite (FD-validated)
        ramp = jnp.clip((bdist + F32(margin)) / F32(0.5 * margin),
                        0.0, 1.0)
        cut = ramp * ramp * (3.0 - 2.0 * ramp)
        w = jax.nn.sigmoid(bdist / F32(temp)) * cut * live.astype(F32)

        f = faces[p]
        c0, c1, c2 = (vert_colors[f[:, j]] for j in range(3))
        bw = (1.0 - u - v)
        albedo = (c0 * bw[:, None] + c1 * u[:, None]
                  + c2 * v[:, None])[:, :3]
        n = jnp.cross(e1, e2)
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True),
                            1e-20)
        n = jnp.where(jnp.sum(n * d, -1, keepdims=True) > 0, -n, n)
        ndotl = jnp.sum(n * l, -1)
        if shade_smooth > 0:
            s = F32(shade_smooth)
            ndotl = s * jax.nn.softplus(ndotl / s)
        else:
            ndotl = jnp.maximum(ndotl, 0.0)
        col = albedo * (ambient + ndotl[:, None])

        rgb = rgb + (trans * w)[:, None] * col
        trans = trans * (1.0 - w)
    return rgb + trans[:, None] * jnp.asarray(background, F32)


def render_lambert(verts, faces, vert_colors, o, d, light_dir,
                   bvh_arrays=None, ambient=0.1, background=(0., 0., 0.)):
    """Differentiable Lambert-shaded RT render.

    Gradients flow to verts (through hit position, geometric normal, and
    barycentrics) and to vert_colors (through interpolation).
    Returns (R, 3) float32."""
    prim, t, u, v = closest_hit_diff(verts, faces, o, d, bvh_arrays)
    hit = prim >= 0
    p = jnp.maximum(prim, 0)

    f = faces[p]
    c0, c1, c2 = (vert_colors[f[:, k]] for k in range(3))
    w = (1.0 - u - v)
    albedo = (c0 * w[:, None] + c1 * u[:, None] + c2 * v[:, None])[:, :3]

    v0, v1, v2 = (verts[f[:, k]] for k in range(3))
    n = jnp.cross(v1 - v0, v2 - v0)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    n = jnp.where(jnp.sum(n * d, -1, keepdims=True) > 0, -n, n)

    l = jnp.asarray(light_dir, F32)
    l = l / jnp.linalg.norm(l)
    ndotl = jnp.maximum(jnp.sum(n * l, -1), 0.0)
    rgb = albedo * (ambient + ndotl[:, None])
    return jnp.where(hit[:, None], rgb, jnp.asarray(background, F32))
