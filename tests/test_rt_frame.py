"""Compiled single-dispatch RT frame (rt/frame.py) — the config-3 path.

Covers: the "closest after" enumeration walk's exactness (every hit,
exact-t ties included, in lexicographic (t, prim) order) on both
traversal routes, the fused frame's agreement with the exact
submission-order scan oracle (rt/raster_bridge._scan_drawcall ≅
om_unit.cpp:24-154 in float), and the overflow-retry contract (probe
walk counts dropped fragments; K doubles until clean — the deferred
raster blend-K pattern, ops/deferred.py).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from skybox_rt_tpu.geom import cgltrace
from skybox_rt_tpu.ops import traverse
from skybox_rt_tpu.rt import bvh as bvh_mod
from skybox_rt_tpu.rt import frame, raster_bridge


def _mt_all_t(o, d, v0, e1, e2):
    """(R, P) hit t (inf = miss) — brute-force enumeration oracle with
    the walks' MT semantics (intersect.moller_trumbore eps/bounds)."""
    pv = np.cross(d[:, None], e2[None])
    det = np.einsum("pk,rpk->rp", e1, pv)
    valid = np.abs(det) > 1e-9
    inv = np.where(valid, 1.0 / np.where(valid, det, 1), 0)
    tv = o[:, None] - v0[None]
    u = np.einsum("rpk,rpk->rp", tv, pv) * inv
    qv = np.cross(tv, e1[None])
    vv = np.einsum("rk,rpk->rp", d, qv) * inv
    t = np.einsum("pk,rpk->rp", e2, qv) * inv
    hit = valid & (u >= 0) & (vv >= 0) & (u + vv <= 1) & (t > 1e-6)
    return np.where(hit, t, np.inf).astype(np.float32)


@pytest.mark.parametrize("engine", ["kernel", "bvh"])
def test_after_walk_enumerates_all_hits_including_ties(engine):
    rng = np.random.default_rng(0)
    P, R, K = 37, 300, 8
    v0 = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    # exact duplicate prim => exact-t tie on every hit; a plain
    # t-epsilon advance would enumerate only one of the pair
    v0[20], e1[20], e2[20] = v0[5], e1[5], e2[5]
    verts = np.stack([v0, v0 + e1, v0 + e2], 1).reshape(-1, 3)
    faces = np.arange(verts.shape[0]).reshape(-1, 3)
    bvh = bvh_mod.build_sah(verts, faces)
    tri = tuple(jnp.asarray(a) for a in (v0, e1, e2))
    stackless = bvh.as_stackless_arrays()
    scene = traverse.prepare_scene(stackless, tri, bvh.leaf_size)

    o = rng.uniform(-3, -2, (R, 3)).astype(np.float32)
    d = (rng.uniform(-1, 1, (R, 3)) + 1.5).astype(np.float32)
    oj, dj = jnp.asarray(o), jnp.asarray(d)

    tlo = jnp.full((R,), -np.inf, jnp.float32)
    plo = jnp.full((R,), -1, jnp.int32)
    got = [[] for _ in range(R)]
    for _ in range(K):
        if engine == "kernel":
            prim, t, u, v = traverse.traverse(
                scene, oj, dj, mode="after", t_min=1e-6, t_lo=tlo,
                prim_lo=plo, interpret=True)
        else:
            prim, t, u, v = bvh_mod.closest_hit_stackless(
                stackless, tri, oj, dj, t_min=1e-6,
                leaf_size=bvh.leaf_size, t_lo=tlo, p_lo=plo)
        pn, tn = np.asarray(prim), np.asarray(t)
        for r in range(R):
            if pn[r] >= 0:
                got[r].append((tn[r], pn[r]))
        tlo, plo = t, prim

    T = _mt_all_t(o, d, v0, e1, e2)
    tie_rays = 0
    for r in range(R):
        ref = sorted((T[r, p], p) for p in range(P) if np.isfinite(T[r, p]))
        n = min(len(ref), K)
        assert len(got[r]) == n, f"ray {r}: {len(got[r])} != {n} hits"
        ref_t = np.asarray([a for a, _ in ref[:n]])
        got_t = np.asarray([a for a, _ in got[r]])
        np.testing.assert_allclose(got_t, ref_t, rtol=1e-5, atol=1e-6)
        # enumeration order is (t, prim), the oracle's too
        assert [p for _, p in ref[:n]] == [p for _, p in got[r]]
        if np.isfinite(T[r, 5]):
            tie_rays += 1
            assert {5, 20} <= {p for _, p in got[r]}
    assert tie_rays > 0          # the tie case actually exercised


@pytest.fixture(scope="module")
def vase():
    return cgltrace.load_cached(cgltrace.trace_path("vase"))


def test_fused_frame_matches_scan_oracle(vase):
    """One jitted frame == the exact per-draw submission-order scan."""
    a = frame.render_trace_rt_fused(vase, 64, 64)
    b = raster_bridge.render_trace_rt(vase, 64, 64, engine="bvh",
                                      camera="perspective")
    diff = np.abs(a[..., :3] - b[..., :3]).max(-1)
    assert diff.max() <= 1e-3, f"max diff {diff.max()}"


def _layered_trace(layers=3, grid=6):
    """Synthetic one-drawcall trace: `layers` stacked viewport-covering
    triangle sheets (grid x grid quads each), blend on, depth off — every
    pixel receives `layers` fragments in submission order, and P > the
    scan cutoff so the K-slot walks (not the tiny-draw scan) run."""
    import types

    from skybox_rt_tpu.core import constants as Cc

    verts, idx, cols, uvs = [], [], [], []
    for li in range(layers):
        base = len(verts)
        w = 1.0
        for gy in range(grid + 1):
            for gx in range(grid + 1):
                # deterministic jitter: no pixel ray grazes a shared
                # edge, so kernel-vs-scan MT rounding can't flip an
                # inclusive edge hit (float tie sensitivity, not a bug)
                j = 0.013 * np.sin(12.9898 * gx + 78.233 * gy + li)
                x = (2.0 * gx / grid - 1.0) * w + j
                y = (2.0 * gy / grid - 1.0) * w - j
                verts.append([x, y, 0.2 + 0.2 * li, 1.0])
                cols.append([0.9 - 0.2 * li, 0.3 + 0.2 * li, 0.5, 0.5])
                uvs.append([gx / grid, gy / grid])
        for gy in range(grid):
            for gx in range(grid):
                v00 = base + gy * (grid + 1) + gx
                v10 = v00 + 1
                v01 = v00 + (grid + 1)
                v11 = v01 + 1
                idx.append([v00, v10, v11])
                idx.append([v00, v11, v01])
    P = len(idx)
    assert P > frame._SCAN_MAX_PRIMS, P

    st = types.SimpleNamespace(
        stencil_test=False, blend_enabled=True,
        blend_src=Cc.CGL_BLEND_SRC_ALPHA,
        blend_dst=Cc.CGL_BLEND_ONE_MINUS_SRC_ALPHA,
        depth_test=False, depth_func=0, depth_writemask=0,
        texture_enabled=False, texture_envmode=0,
        texture_addressU=0, texture_magfilter=0,
        color_enabled=True, color_writemask=0xFFFFFFFF)
    dc = types.SimpleNamespace(
        pos=np.asarray(verts, np.float32),
        indices=np.asarray(idx, np.int32),
        color=np.asarray(cols, np.float32),
        texcoord=np.asarray(uvs, np.float32),
        near=0.0, far=1.0, states=st, texture_id=-1)
    tr = types.SimpleNamespace(drawcalls=[dc], textures={})
    return tr


@pytest.mark.parametrize("engine", ["kernel", "bvh"])
def test_fused_frame_overflow_retry_converges(engine):
    """A scene whose per-ray fragment count (3 stacked translucent
    layers) exceeds the starting K must trip the probe walk and double K
    until the image matches the exact scan oracle."""
    tr = _layered_trace(layers=3)
    tkey = frame._trace_key(tr)
    out = frame.render_trace_rt_fused(tr, 32, 32, engine=engine,
                                      interpret=engine == "kernel")
    # the retry loop must have discovered K >= 3 for the kslot draw
    ks = [k for (tk, _), k in frame._K_HINTS.items() if tk == tkey]
    assert ks and max(ks) >= 3, ks
    oracle = raster_bridge.render_trace_rt(tr, 32, 32, engine="brute",
                                          camera="perspective")
    diff = np.abs(out[..., :3] - oracle[..., :3]).max(-1)
    assert diff.max() <= 1e-3, f"max diff {diff.max()}"


def test_fused_frame_is_single_dispatch(vase):
    """The whole frame traces into ONE jitted callable whose inputs stay
    device-resident (no per-draw host loop)."""
    fn, arrays, rays, metas = frame.make_frame_fn(vase, 32, 32)
    zbuf, color, ovf = fn(arrays, *rays)
    assert color.shape == (32 * 32, 4)
    # the vase plan: draw 1 opaque LESS -> winner walk; blended draws
    # above the scan cutoff (2, 3, 4) -> K-slot enumeration; the 2-prim
    # full-screen quads (0, 5) -> exact vectorized scan in the same jit
    modes = {m["draw_index"]: m["mode"] for m in metas}
    assert modes == {0: "scan", 1: "winner", 2: "kslot", 3: "kslot",
                     4: "kslot", 5: "scan"}
    # probed draws (K < P) report an overflow count each
    assert ovf.shape[0] == sum(1 for m in metas
                               if m["mode"] == "kslot" and m["K"] < m["P"])
