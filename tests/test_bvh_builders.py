"""BVH builder suite: median / binned-SAH / LBVH (SURVEY §7 step 5).

Every builder must produce a structurally valid tree (each prim in exactly
one leaf, AABBs containing their prims, contiguous subtree ranges) and
bit-identical hit results vs the brute-force Möller–Trumbore oracle under
both traversals.  SAH must not be worse than median split on the
node-visit metric that the traversal cost model counts.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from skybox_rt_tpu.models import scenes
from skybox_rt_tpu.rt import bvh as bvh_mod
from skybox_rt_tpu.rt import intersect, tracer

METHODS = ["median", "sah", "lbvh"]


def _soup(n=257, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    verts = np.concatenate([base, base + e1, base + e2], 0)
    faces = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n],
                     1).astype(np.int64)
    return verts, faces


def _rays(m=512, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (m, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _check_structure(bvh, verts, faces):
    P = faces.shape[0]
    # permutation property: every prim in exactly one leaf
    assert sorted(bvh.prim_order.tolist()) == list(range(P))
    leaves = bvh.node_count > 0
    covered = np.zeros(P, bool)
    for ni in np.flatnonzero(leaves):
        f, c = int(bvh.node_first[ni]), int(bvh.node_count[ni])
        assert not covered[f:f + c].any()
        covered[f:f + c] = True
        assert c <= bvh.leaf_size
    assert covered.all()
    # AABB containment
    tri = verts[faces]
    tmin, tmax = tri.min(1), tri.max(1)
    for ni in np.flatnonzero(leaves):
        f, c = int(bvh.node_first[ni]), int(bvh.node_count[ni])
        pids = bvh.prim_order[f:f + c]
        assert (tmin[pids] >= bvh.node_min[ni] - 1e-5).all()
        assert (tmax[pids] <= bvh.node_max[ni] + 1e-5).all()
    # internal nodes contain their children
    for ni in np.flatnonzero(~leaves):
        for ci in (bvh.node_left[ni], bvh.node_right[ni]):
            assert (bvh.node_min[ci] >= bvh.node_min[ni] - 1e-5).all()
            assert (bvh.node_max[ci] <= bvh.node_max[ni] + 1e-5).all()


@pytest.mark.parametrize("method", METHODS)
def test_structure_soup(method):
    verts, faces = _soup()
    bvh = bvh_mod.build(verts, faces, method=method)
    _check_structure(bvh, verts, faces)


@pytest.mark.parametrize("method", METHODS)
def test_traversal_parity_vs_bruteforce(method):
    verts, faces = _soup(129, seed=2)
    bvh = bvh_mod.build(verts, faces, method=method)
    v0, e1, e2 = intersect.triangle_arrays(jnp.asarray(verts),
                                           jnp.asarray(faces))
    o, d = _rays(256)

    bp, bt, bu, bv = intersect.closest_hit_bruteforce(o, d, v0, e1, e2)
    for arrays, fn in [
        (bvh.as_device_arrays(), bvh_mod.closest_hit),
        (bvh.as_stackless_arrays(), bvh_mod.closest_hit_stackless),
    ]:
        p, t, u, v = fn(arrays, (v0, e1, e2), o, d,
                        leaf_size=bvh.leaf_size)
        np.testing.assert_array_equal(np.asarray(p), np.asarray(bp))
        np.testing.assert_allclose(np.asarray(t)[np.asarray(p) >= 0],
                                   np.asarray(bt)[np.asarray(bp) >= 0],
                                   rtol=1e-5)


@pytest.mark.parametrize("method", ["sah", "lbvh"])
def test_render_image_matches_median(method):
    """Same image regardless of builder (engine-independent oracle)."""
    verts, faces = scenes.icosphere(subdiv=2)
    colors = np.ones((verts.shape[0], 4), np.float32)
    cam = tracer.Camera(eye=(0, 0, 3), look_at=(0, 0, 0))
    cfg = tracer.RTConfig(width=64, height=64, engine="bvh", shadows=True)
    imgs = {}
    for m in ("median", method):
        sc = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                            bvh_method=m).finalize()
        imgs[m] = np.asarray(tracer.render(sc, cam, cfg))
    np.testing.assert_allclose(imgs[method], imgs["median"],
                               atol=1e-5, rtol=1e-5)


def _sah_cost(bvh):
    """Expected traversal cost (the SAH objective): sum over nodes of
    P(hit node | hit root) * work(node), work = count for leaves else 2."""
    def area(ni):
        e = np.maximum(bvh.node_max[ni] - bvh.node_min[ni], 0)
        return e[0] * e[1] + e[1] * e[2] + e[2] * e[0]

    root_a = max(area(0), 1e-30)
    cost = 0.0
    for ni in range(bvh.num_nodes):
        w = bvh.node_count[ni] if bvh.node_count[ni] > 0 else 2
        cost += area(ni) / root_a * w
    return cost


def test_sah_cost_not_worse_than_median():
    """SAH's raison d'être: lower expected traversal cost on irregular
    (clustered, mixed-scale) geometry."""
    rng = np.random.default_rng(5)
    parts = []
    for k in range(8):  # 8 clusters of very different density/scale
        c = rng.uniform(-4, 4, 3)
        s = 10.0 ** rng.uniform(-2, 0)
        v, f = _soup(64, seed=10 + k)
        parts.append((v * s + c, f))
    verts = np.concatenate([v for v, _ in parts], 0).astype(np.float32)
    off = np.cumsum([0] + [v.shape[0] for v, _ in parts[:-1]])
    faces = np.concatenate([f + o for (_, f), o in zip(parts, off)], 0)

    cost = {m: _sah_cost(bvh_mod.build(verts, faces, method=m))
            for m in ("median", "sah")}
    assert cost["sah"] <= cost["median"], cost


def test_morton_codes_locality():
    """Morton codes are deterministic and order nearby points together."""
    pts = np.array([[0, 0, 0], [1, 1, 1], [0.01, 0, 0], [0.99, 1, 1]],
                   np.float32)
    c = bvh_mod.morton_codes(pts)
    assert c[0] < c[1] and c[2] < c[3]
    perm = np.argsort(c)
    # the two near-origin points are adjacent after sorting
    p0, p2 = np.flatnonzero(perm == 0)[0], np.flatnonzero(perm == 2)[0]
    assert abs(int(p0) - int(p2)) == 1
