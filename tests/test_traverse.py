"""GPU BVH traversal kernel (ops/traverse.py) in the Pallas interpreter.

Each mode is checked against the brute-force all-pairs oracles of
rt/intersect.py over scenes that exercise the walk's edge cases, at ray
counts that fill a program exactly and that leave a padded tail.  The
kernel's lexicographic (t, prim) order makes its closest hit equal the
brute-force argmin prim for prim, exact-t ties included.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from skybox_rt_tpu.models import scenes
from skybox_rt_tpu.ops import traverse
from skybox_rt_tpu.rt import bvh as bvh_mod
from skybox_rt_tpu.rt import intersect

BLOCK = traverse.BLOCK


def _scene(verts, faces, method="sah"):
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    b = bvh_mod.build(verts, faces, method=method)
    tri = intersect.triangle_arrays(jnp.asarray(verts), jnp.asarray(faces))
    return traverse.prepare_scene(b.as_stackless_arrays(), tri,
                                  b.leaf_size), tri


def _random_rays(R, seed, center=(0.0, 0.0, 0.0), radius=3.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * radius
    o = o + np.asarray(center, np.float32)
    target = rng.normal(size=(R, 3)).astype(np.float32) * 0.5 + center
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _case(name, R):
    """(verts, faces, o, d, t_max) for one named scene."""
    if name.startswith("ico"):
        v, f = scenes.icosphere(subdiv=int(name[3:]))
        o, d = _random_rays(R, seed=R + len(name))
        return v, f, o, d, None
    if name == "sphere_field":
        v, f, _ = scenes.sphere_field(copies=4, subdiv=1)
        o, d = _random_rays(R, seed=5, center=(0.0, 0.0, 0.0), radius=6.0)
        return v, f, o, d, None
    if name == "axis_parallel":
        v, f = scenes.icosphere(subdiv=2)
        rng = np.random.default_rng(7)
        axis = rng.integers(0, 3, R)
        sign = rng.choice([-1.0, 1.0], R)
        d = np.zeros((R, 3), np.float32)
        d[np.arange(R), axis] = sign
        o = rng.uniform(-0.8, 0.8, (R, 3)).astype(np.float32)
        o[np.arange(R), axis] = -2.5 * sign
        return v, f, o, d, None
    if name == "all_miss":
        v, f = scenes.icosphere(subdiv=1)
        o, d = _random_rays(R, seed=9)
        return v, f, o, -d, None          # every ray points away
    if name == "t_max_cut":
        v, f = scenes.icosphere(subdiv=2)
        o, d = _random_rays(R, seed=11)
        tm = np.random.default_rng(12).uniform(1.5, 3.5, R).astype(
            np.float32)
        return v, f, o, d, tm
    if name == "exact_ties":
        # every triangle duplicated: each hit is an exact-t tie between
        # prim p and prim p + P; the lower id must win
        v, f = scenes.icosphere(subdiv=1)
        f = np.concatenate([f, f])
        o, d = _random_rays(R, seed=13)
        return v, f, o, d, None
    raise ValueError(name)


SCENES = ["ico1", "ico2", "ico3", "sphere_field", "axis_parallel",
          "all_miss", "t_max_cut", "exact_ties"]
RAY_COUNTS = [BLOCK * 2, BLOCK * 2 + 13]


@pytest.mark.parametrize("R", RAY_COUNTS)
@pytest.mark.parametrize("name", SCENES)
def test_closest_matches_bruteforce(name, R):
    v, f, o, d, tm = _case(name, R)
    scene, tri = _scene(v, f)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    t_max = jnp.inf if tm is None else jnp.asarray(tm)[:, None]
    p, t, u, w = traverse.traverse(scene, oj, dj, t_max=tm,
                                   interpret=True)
    bp, bt, bu, bw = intersect.closest_hit_bruteforce(oj, dj, *tri,
                                                      t_max=t_max)
    np.testing.assert_array_equal(np.asarray(p), np.asarray(bp))
    hit = np.asarray(bp) >= 0
    if name == "all_miss":
        assert not hit.any()
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(bt)[hit],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(u)[hit], np.asarray(bu)[hit],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(w)[hit], np.asarray(bw)[hit],
                               atol=1e-5)
    assert np.isinf(np.asarray(t)[~hit]).all()


@pytest.mark.parametrize("R", RAY_COUNTS)
@pytest.mark.parametrize("name", SCENES)
def test_any_matches_bruteforce(name, R):
    v, f, o, d, tm = _case(name, R)
    if tm is None:
        tm = np.full((R,), 2.8, np.float32)     # a cut-off on every ray
    scene, tri = _scene(v, f)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    got = traverse.traverse(scene, oj, dj, mode="any", t_max=tm,
                            interpret=True)
    want = intersect.any_hit_bruteforce(oj, dj, *tri, t_max=jnp.asarray(tm)
                                        [:, None])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", ["ico2", "sphere_field", "exact_ties",
                                  "t_max_cut"])
def test_after_enumerates_every_hit_in_order(name):
    """Feeding each "after" walk its predecessor's (t, prim) enumerates
    every hit along a ray once, in lexicographic (t, prim) order."""
    R = BLOCK + 5
    v, f, o, d, tm = _case(name, R)
    scene, tri = _scene(v, f)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    hit, t, _, _ = intersect.moller_trumbore(
        oj[:, None], dj[:, None], tri[0][None], tri[1][None], tri[2][None],
        1e-4, jnp.inf if tm is None else jnp.asarray(tm)[:, None])
    T = np.where(np.asarray(hit), np.asarray(t), np.inf)
    K = int(np.isfinite(T).sum(1).max()) + 1
    tlo = jnp.full((R,), -jnp.inf, jnp.float32)
    plo = jnp.full((R,), -1, jnp.int32)
    got = [[] for _ in range(R)]
    for _ in range(K):
        p, tt, _, _ = traverse.traverse(scene, oj, dj, mode="after",
                                        t_max=tm, t_lo=tlo, prim_lo=plo,
                                        interpret=True)
        pn = np.asarray(p)
        for r in np.flatnonzero(pn >= 0):
            got[r].append(int(pn[r]))
        tlo, plo = tt, p
    assert (np.asarray(plo) < 0).all()       # the last walk found nothing
    for r in range(R):
        want = sorted((T[r, q], q) for q in np.flatnonzero(np.isfinite(
            T[r])))
        assert got[r] == [q for _, q in want], r


@pytest.mark.parametrize("R", [1, 7, BLOCK, BLOCK + 1, 3 * BLOCK - 1])
def test_wrapper_padding_and_shapes(R):
    """Any ray count pads to whole programs; padding lanes never leak."""
    v, f = scenes.icosphere(subdiv=1)
    scene, tri = _scene(v, f)
    o, d = _random_rays(R, seed=R)
    p, t, u, w = traverse.traverse(scene, jnp.asarray(o), jnp.asarray(d),
                                   interpret=True)
    assert p.shape == t.shape == u.shape == w.shape == (R,)
    assert p.dtype == jnp.int32 and t.dtype == jnp.float32
    occ = traverse.traverse(scene, jnp.asarray(o), jnp.asarray(d),
                            mode="any", t_max=10.0, interpret=True)
    assert occ.shape == (R,) and occ.dtype == jnp.bool_
    bp, _, _, _ = intersect.closest_hit_bruteforce(
        jnp.asarray(o), jnp.asarray(d), *tri)
    np.testing.assert_array_equal(np.asarray(p), np.asarray(bp))


@pytest.mark.parametrize("kwargs,match", [
    (dict(mode="nearest"), "mode"),
    (dict(mode="after"), "t_lo"),
    (dict(t_lo=jnp.zeros(4), prim_lo=jnp.zeros(4, jnp.int32)), "t_lo"),
    (dict(mode="after", prim_lo=jnp.zeros(4, jnp.int32)), "t_lo"),
])
def test_wrapper_rejects_bad_arguments(kwargs, match):
    v, f = scenes.icosphere(subdiv=1)
    scene, _ = _scene(v, f)
    o = jnp.zeros((4, 3), jnp.float32)
    d = jnp.ones((4, 3), jnp.float32)
    with pytest.raises(ValueError, match=match):
        traverse.traverse(scene, o, d, interpret=True, **kwargs)


@pytest.mark.parametrize("method", ["median", "sah", "lbvh"])
def test_prepare_scene_layout(method):
    """Node records carry the preorder boxes and links; triangle records
    are in leaf order, each tagged with its original prim id."""
    v, f = scenes.icosphere(subdiv=2)
    b = bvh_mod.build(v, f, method=method)
    tri = intersect.triangle_arrays(jnp.asarray(v), jnp.asarray(f))
    sc = traverse.prepare_scene(b.as_stackless_arrays(), tri, b.leaf_size)
    b.build_preorder()
    N, P = b.num_nodes, f.shape[0]
    assert sc["num_nodes"] == N and sc["leaf_size"] == b.leaf_size
    nf = np.asarray(sc["nodes_f"]).reshape(N, traverse.NODE_F)
    ni = np.asarray(sc["nodes_i"]).reshape(N, traverse.NODE_I)
    np.testing.assert_array_equal(nf[:, 0:3], b.pre_min)
    np.testing.assert_array_equal(nf[:, 3:6], b.pre_max)
    np.testing.assert_array_equal(ni[:, 0], b.pre_first)
    np.testing.assert_array_equal(ni[:, 1], b.pre_count)
    np.testing.assert_array_equal(ni[:, 2], b.pre_escape)
    rec = np.asarray(sc["tris"]).reshape(P, traverse.TRI_F)
    pid = np.asarray(sc["tri_prim"])
    assert sorted(pid.tolist()) == list(range(P))
    np.testing.assert_array_equal(rec[:, 0:3], np.asarray(tri[0])[pid])
    np.testing.assert_array_equal(rec[:, 6:9], np.asarray(tri[2])[pid])
