"""Wavefront helpers: ray sorting for traversal coherence (SURVEY §5
"long-context" note: multi-bounce = loop with re-compaction).

What matters for traversal is COHERENCE: rays that traverse the same
BVH nodes should share a warp, so the lanes of the GPU kernel
(ops.traverse) walk similar paths and gather the same node and triangle
records, and the lockstep walk (rt.bvh.closest_hit_stackless) visits
fewer distinct nodes per step.  After a bounce scatters directions,
re-sorting restores that coherence.

Sort key: direction octant (3 bits) then 30-bit Morton code of the
quantized origin — the standard wavefront-path-tracer binning.
"""
from __future__ import annotations

import jax.numpy as jnp

I32 = jnp.int32
U32 = jnp.uint32


def _expand_bits10(v):
    """Spread 10 bits to every 3rd position (Morton interleave helper)."""
    v = jnp.asarray(v, U32)
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def morton3d(x, y, z):
    """30-bit Morton code from 10-bit integer coordinates."""
    return ((_expand_bits10(x) << 2) | (_expand_bits10(y) << 1)
            | _expand_bits10(z))


def ray_sort_keys(orig, direction, scene_min, scene_max):
    """(R,) uint32 sort keys: [octant:3][morton(origin):30] >> fits u32
    by dropping the lowest morton bit."""
    ext = jnp.maximum(scene_max - scene_min, 1e-20)
    q = jnp.clip((orig - scene_min) / ext * 1023.0, 0.0, 1023.0)
    q = q.astype(U32)
    m = morton3d(q[:, 0], q[:, 1], q[:, 2])
    octant = ((direction[:, 0] > 0).astype(U32)
              | ((direction[:, 1] > 0).astype(U32) << 1)
              | ((direction[:, 2] > 0).astype(U32) << 2))
    return (octant << 29) | (m >> 1)


def sort_rays(orig, direction, scene_min, scene_max):
    """Returns (perm, inv_perm): apply perm to ray arrays before
    traversal, inv_perm to results after.  Static shapes throughout."""
    keys = ray_sort_keys(orig, direction, jnp.asarray(scene_min),
                         jnp.asarray(scene_max))
    perm = jnp.argsort(keys)
    inv = jnp.argsort(perm)
    return perm, inv


def traverse_sorted(closest_fn, orig, direction, scene_min, scene_max):
    """Sort -> traverse -> unsort wrapper around any closest-hit fn."""
    perm, inv = sort_rays(orig, direction, scene_min, scene_max)
    prim, t, u, v = closest_fn(orig[perm], direction[perm])
    return prim[inv], t[inv], u[inv], v[inv]


def tile_order_perm(width: int, height: int, tile: int = 32):
    """Static permutation turning scanline ray order into pixel-tile order
    (tile*tile consecutive rays per screen tile) — primary-ray blocks
    become spatially compact, which is what makes the clustered kernel's
    whole-tile AABB skips fire.  Returns (perm, inv) numpy int32 arrays:
    rays[perm] is tile-ordered; results[inv] restores scanline order."""
    import numpy as np

    ys, xs = np.mgrid[0:height, 0:width]
    key = (((ys // tile) * ((width + tile - 1) // tile) + (xs // tile))
           * (tile * tile)
           + (ys % tile) * tile + (xs % tile))
    perm = np.argsort(key.ravel(), kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm, inv
