"""Edge-function rasterization, vectorized over pixel grids.

Array-native reformulation of the reference's recursive tile->subtile->quad
descent (graphics.cpp:715-843).  On int32 two's-complement hardware the
descent's incremental edge sums equal the direct evaluation
``E_k(x, y) = a_k*x + b_k*y + c_k  (mod 2^32)``, so a flat vectorized
evaluation over all pixels of a tile is bit-identical to the reference's
traversal (the hierarchical trivial-reject is a pure optimization as long as
intermediate values stay in int32 range, which holds for screens < 2^15 px).

Coverage per pixel = all three edges >= 0, inside scissor
(graphics.cpp:813-825 PREPARE_QUAD).
"""
from __future__ import annotations

import jax.numpy as jnp

I32 = jnp.int32


def eval_edges(edge, xs, ys):
    """Evaluate the three edge functions over a pixel grid.

    edge: (3, 3) int32 fixed16 [edge][a, b, c]
    xs, ys: broadcastable int32 pixel coordinate grids
    Returns (3, *grid) int32 edge values (fixed16, wraps like the reference).
    """
    edge = jnp.asarray(edge, I32)
    xs = jnp.asarray(xs, I32)
    ys = jnp.asarray(ys, I32)
    return (edge[:, 0][:, None, None] * xs[None]
            + edge[:, 1][:, None, None] * ys[None]
            + edge[:, 2][:, None, None])


def coverage(evals, xs, ys, scissor):
    """Coverage mask: inside all edges and the scissor rect.

    evals: (3, H, W) int32; scissor: (left, top, right, bottom) ints.
    """
    left, top, right, bottom = scissor
    inside = (evals[0] >= 0) & (evals[1] >= 0) & (evals[2] >= 0)
    return (inside
            & (xs >= left) & (xs < right)
            & (ys >= top) & (ys < bottom))
