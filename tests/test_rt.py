"""Ray-tracing path tests: MT intersection, BVH vs brute-force parity,
end-to-end renders (north-star configs 2-3 shapes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skybox_rt_tpu.models import scenes
from skybox_rt_tpu.rt import bvh as bvh_mod
from skybox_rt_tpu.rt import intersect, tracer


def test_moller_trumbore_analytic():
    # unit triangle in z=0 plane
    v0 = jnp.array([[0.0, 0.0, 0.0]])
    e1 = jnp.array([[1.0, 0.0, 0.0]])
    e2 = jnp.array([[0.0, 1.0, 0.0]])
    o = jnp.array([[0.25, 0.25, -1.0], [0.9, 0.9, -1.0], [0.25, 0.25, 1.0]])
    d = jnp.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    hit, t, u, v = intersect.moller_trumbore(o, d, v0, e1, e2)
    assert bool(hit[0]) and not bool(hit[1])
    assert bool(hit[2])  # two-sided: hits from behind too
    np.testing.assert_allclose(float(t[0]), 1.0, atol=1e-6)
    np.testing.assert_allclose([float(u[0]), float(v[0])], [0.25, 0.25],
                               atol=1e-6)


def test_bvh_matches_bruteforce():
    verts, faces = scenes.icosphere(subdiv=2)
    bvh = bvh_mod.build(verts, faces)
    tri = intersect.triangle_arrays(jnp.asarray(verts), jnp.asarray(faces))

    rng = np.random.default_rng(0)
    R = 512
    o = rng.normal(size=(R, 3)).astype(np.float32) * 3.0
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    p_b, t_b, u_b, v_b = intersect.closest_hit_bruteforce(
        jnp.asarray(o), jnp.asarray(d), *tri)
    p_h, t_h, u_h, v_h = bvh_mod.closest_hit(
        bvh.as_device_arrays(), tri, jnp.asarray(o), jnp.asarray(d))

    np.testing.assert_array_equal(np.asarray(p_b), np.asarray(p_h))
    hits = np.asarray(p_b) >= 0
    np.testing.assert_allclose(np.asarray(t_b)[hits], np.asarray(t_h)[hits],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(u_b)[hits], np.asarray(u_h)[hits],
                               atol=1e-5)


def test_bvh_structure():
    verts, faces = scenes.icosphere(subdiv=1)
    bvh = bvh_mod.build(verts, faces)
    # every prim appears exactly once across leaves
    leaves = bvh.node_count > 0
    covered = []
    for ni in np.flatnonzero(leaves):
        f = bvh.node_first[ni]
        covered.extend(bvh.prim_order[f:f + bvh.node_count[ni]])
    assert sorted(covered) == list(range(faces.shape[0]))
    # children AABBs inside parent AABB
    for ni in np.flatnonzero(~leaves):
        for ci in (bvh.node_left[ni], bvh.node_right[ni]):
            assert (bvh.node_min[ci] >= bvh.node_min[ni] - 1e-6).all()
            assert (bvh.node_max[ci] <= bvh.node_max[ni] + 1e-6).all()


def _sphere_scene(reflectivity=0.0):
    verts, faces = scenes.icosphere(subdiv=2)
    colors = np.ones((verts.shape[0], 4), np.float32)
    colors[:, 0] = 0.8
    colors[:, 1] = 0.3
    colors[:, 2] = 0.2
    return tracer.RTScene(verts=verts, faces=faces, colors=colors,
                          reflectivity=reflectivity)


@pytest.mark.parametrize("use_bvh", [False, True])
def test_primary_ray_sphere_render(use_bvh):
    """North-star config 2: primary-ray BVH trace, flat shading."""
    scene = _sphere_scene()
    cam = tracer.Camera(eye=(0, 0, 3), look_at=(0, 0, 0))
    cfg = tracer.RTConfig(width=64, height=64, use_bvh=use_bvh)
    img = np.asarray(tracer.render(scene, cam, cfg))
    assert img.shape == (64, 64, 4)
    # sphere silhouette: center hit, corner miss
    assert img[32, 32, :3].max() > 0.05
    assert (img[0, 0] == np.array([0, 0, 0, 1], np.float32)).all()
    # silhouette is approximately a disc of radius ~ r*f/z
    hit_frac = (img[..., :3].sum(-1) > 0).mean()
    assert 0.2 < hit_frac < 0.6

    # shading is brighter toward the light
    bright_up = img[40, 36, :3].sum()
    dark_down = img[18, 24, :3].sum()
    assert bright_up > dark_down


def test_bvh_and_bruteforce_render_identical():
    scene = _sphere_scene()
    cam = tracer.Camera(eye=(0.5, 0.8, 2.5), look_at=(0, 0, 0))
    a = np.asarray(tracer.render(
        scene, cam, tracer.RTConfig(width=48, height=48, use_bvh=True)))
    b = np.asarray(tracer.render(
        scene, cam, tracer.RTConfig(width=48, height=48, use_bvh=False)))
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_shadows_and_plane():
    """Sphere over ground plane: the plane must show a shadow."""
    verts_s, faces_s = scenes.icosphere(subdiv=2)
    verts_p, faces_p = scenes.mesh_grid_plane(n=4, y=-1.2, half=6.0)
    verts = np.concatenate([verts_s, verts_p])
    faces = np.concatenate([faces_s, faces_p + verts_s.shape[0]])
    colors = np.ones((verts.shape[0], 4), np.float32) * 0.8
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors)
    cam = tracer.Camera(eye=(0, 1.5, 4.5), look_at=(0, -0.5, 0))
    cfg = tracer.RTConfig(width=64, height=64, shadows=True,
                          light_dir=(0.1, 1.0, 0.1))
    img = np.asarray(tracer.render(scene, cam, cfg))
    noshadow = np.asarray(tracer.render(
        scene, cam, tracer.RTConfig(width=64, height=64, shadows=False,
                                    light_dir=(0.1, 1.0, 0.1))))
    # shadowed image must be darker somewhere on the plane
    diff = noshadow[..., :3].sum() - img[..., :3].sum()
    assert diff > 1.0


def test_reflection_bounce():
    """Mirror sphere over checkered plane: bounces change the image."""
    scene = _sphere_scene(reflectivity=0.6)
    verts_p, faces_p = scenes.mesh_grid_plane(n=4, y=-1.2, half=8.0)
    v = np.concatenate([scene.verts, verts_p])
    f = np.concatenate([scene.faces, faces_p + scene.verts.shape[0]])
    c = np.concatenate([scene.colors,
                        np.tile(np.array([[0.2, 0.6, 0.9, 1.0]], np.float32),
                                (verts_p.shape[0], 1))])
    scene = tracer.RTScene(verts=v, faces=f, colors=c, reflectivity=0.6)
    cam = tracer.Camera(eye=(0, 0.8, 3.5), look_at=(0, 0, 0))
    img0 = np.asarray(tracer.render(
        scene, cam, tracer.RTConfig(width=48, height=48, bounces=0)))
    img2 = np.asarray(tracer.render(
        scene, cam, tracer.RTConfig(width=48, height=48, bounces=2)))
    assert np.abs(img2 - img0).max() > 0.05
    assert np.isfinite(img2).all()


def test_stackless_matches_bruteforce():
    """Preorder/escape-link lockstep traversal (the XLA reference walk)
    vs brute force — exact prim agreement."""
    verts, faces = scenes.icosphere(subdiv=2)
    bvh = bvh_mod.build(verts, faces)
    tri = intersect.triangle_arrays(jnp.asarray(verts), jnp.asarray(faces))

    rng = np.random.default_rng(7)
    R = 1024
    o = rng.normal(size=(R, 3)).astype(np.float32) * 3.0
    d = -o + rng.normal(size=(R, 3)).astype(np.float32) * 0.3  # aimed inward
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    p_b, t_b, u_b, v_b = intersect.closest_hit_bruteforce(
        jnp.asarray(o), jnp.asarray(d), *tri)
    p_s, t_s, u_s, v_s = bvh_mod.closest_hit_stackless(
        bvh.as_stackless_arrays(), tri, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(p_b), np.asarray(p_s))
    hits = np.asarray(p_b) >= 0
    assert hits.mean() > 0.5          # the aimed rays mostly hit
    np.testing.assert_allclose(np.asarray(t_b)[hits], np.asarray(t_s)[hits],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(u_b)[hits], np.asarray(u_s)[hits],
                               atol=1e-5)


def test_preorder_escape_invariants():
    verts, faces = scenes.icosphere(subdiv=1)
    bvh = bvh_mod.build(verts, faces).build_preorder()
    N = bvh.num_nodes
    esc = bvh.pre_escape
    assert esc[0] == N
    # escape always jumps forward and never past N
    for i in range(N):
        assert i < esc[i] <= N
    # leaf prim ranges cover every prim exactly once
    covered = []
    for i in range(N):
        if bvh.pre_count[i] > 0:
            f = bvh.pre_first[i]
            covered.extend(bvh.prim_order[f:f + bvh.pre_count[i]])
    assert sorted(covered) == list(range(faces.shape[0]))


def test_wavefront_sort_roundtrip():
    """Morton/octant ray sorting: permutation correctness — sorted
    traversal returns identical results in original ray order."""
    from skybox_rt_tpu.rt import wavefront

    verts, faces = scenes.icosphere(subdiv=2)
    tri = intersect.triangle_arrays(jnp.asarray(verts), jnp.asarray(faces))
    rng = np.random.default_rng(11)
    R = 777
    o = rng.normal(size=(R, 3)).astype(np.float32) * 3.0
    d = -o + rng.normal(size=(R, 3)).astype(np.float32) * 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)

    def closest(o_, d_):
        return intersect.closest_hit_bruteforce(o_, d_, *tri)

    ref = closest(o, d)
    got = wavefront.traverse_sorted(closest, o, d,
                                    verts.min(0) - 3.0, verts.max(0) + 3.0)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_morton_locality():
    """Morton keys of nearby points differ less than far points (sanity of
    the interleave) and octant dominates the key."""
    from skybox_rt_tpu.rt import wavefront

    o = jnp.asarray([[0.0, 0.0, 0.0], [0.01, 0.01, 0.01], [0.9, 0.9, 0.9]],
                    jnp.float32)
    d_pos = jnp.asarray([[1.0, 1.0, 1.0]] * 3, jnp.float32)
    keys = np.asarray(wavefront.ray_sort_keys(o, d_pos,
                                              jnp.zeros(3), jnp.ones(3)))
    assert abs(int(keys[0]) - int(keys[1])) < abs(int(keys[0]) - int(keys[2]))
    d_neg = -d_pos
    keys_neg = np.asarray(wavefront.ray_sort_keys(o, d_neg,
                                                  jnp.zeros(3), jnp.ones(3)))
    assert (keys_neg != keys).all()


def _cfg(engine, **kw):
    """RTConfig for `engine`; the GPU kernel runs in the Pallas
    interpreter here."""
    return tracer.RTConfig(engine=engine, interpret=engine == "kernel",
                           **kw)


def test_all_engines_render_identical():
    """kernel / bvh / brute engines through the full tracer: same image."""
    scene = _sphere_scene()
    cam = tracer.Camera(eye=(0.3, 0.5, 2.8), look_at=(0, 0, 0))
    imgs = []
    for engine in ("kernel", "bvh", "brute"):
        cfg = _cfg(engine, width=32, height=32, shadows=True)
        imgs.append(np.asarray(tracer.render(scene, cam, cfg)))
    np.testing.assert_allclose(imgs[0], imgs[2], atol=2e-5)
    np.testing.assert_allclose(imgs[1], imgs[2], atol=2e-5)


def test_textured_rt():
    """North-star config 3: textured RT using the shared bilinear sampler."""
    verts, faces = scenes.icosphere(subdiv=2)
    colors = np.ones((verts.shape[0], 4), np.float32)
    # spherical uv from vertex position
    uvs = np.stack([
        0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi),
        0.5 + np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi,
    ], -1).astype(np.float32)
    tex = scenes.checkerboard_texture(size=32, tiles=4)
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                           uvs=uvs, texture=tex)
    cam = tracer.Camera(eye=(0, 0, 3), look_at=(0, 0, 0))
    cfg = tracer.RTConfig(width=48, height=48, textured=True,
                          engine="brute")
    img = np.asarray(tracer.render(scene, cam, cfg))
    assert np.isfinite(img).all()
    # the checker must produce both bright and dark hit pixels
    hits = img[..., :3].sum(-1) > 0
    vals = img[..., :3].sum(-1)[hits]
    assert vals.max() > vals.min() * 2.0


def test_tile_order_perm():
    from skybox_rt_tpu.rt import wavefront

    perm, inv = wavefront.tile_order_perm(8, 8, tile=4)
    assert np.array_equal(np.sort(perm), np.arange(64))
    assert np.array_equal(perm[inv], np.arange(64))
    # first 16 entries = the 4x4 top-left tile, row-major
    xs = perm[:16] % 8
    ys = perm[:16] // 8
    assert xs.max() < 4 and ys.max() < 4
    assert np.array_equal(xs[:4], [0, 1, 2, 3]) and (ys[:4] == 0).all()


def test_large_scene_kernel_matches_bvh():
    """A 20k-triangle scene through the kernel engine matches the
    stackless BVH engine's image."""
    verts, faces = scenes.icosphere(subdiv=5)     # 20480 tris
    colors = np.ones((verts.shape[0], 4), np.float32)
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors)
    cam = tracer.Camera(eye=(0, 0, 3), look_at=(0, 0, 0))
    cfg = _cfg("kernel", width=16, height=16)
    img = np.asarray(tracer.render(scene, cam, cfg))
    assert np.isfinite(img).all()
    assert (img[..., :3].sum(-1) > 0).any()
    ref = np.asarray(tracer.render(
        scene, cam, tracer.RTConfig(width=16, height=16, engine="bvh")))
    np.testing.assert_allclose(img, ref, atol=1e-5)


@pytest.mark.parametrize("engine", ["kernel", "bvh", "brute"])
def test_bounce_compaction_image_identical(engine):
    """Re-compaction between bounces (SURVEY §5 long-context analog) is a
    pure scheduling change: the image must be identical with it on/off,
    on every engine."""
    scene = _sphere_scene(reflectivity=0.6)
    verts_p, faces_p = scenes.mesh_grid_plane(n=4, y=-1.2, half=8.0)
    v = np.concatenate([scene.verts, verts_p])
    f = np.concatenate([scene.faces, faces_p + scene.verts.shape[0]])
    c = np.concatenate([scene.colors,
                        np.tile(np.array([[0.2, 0.6, 0.9, 1.0]], np.float32),
                                (verts_p.shape[0], 1))])
    scene = tracer.RTScene(verts=v, faces=f, colors=c, reflectivity=0.6)
    cam = tracer.Camera(eye=(0, 0.8, 3.5), look_at=(0, 0, 0))
    kw = dict(width=48, height=48, bounces=2, shadows=True)
    a = np.asarray(tracer.render(
        scene, cam, _cfg(engine, compact_bounces=True, **kw)))
    b = np.asarray(tracer.render(
        scene, cam, _cfg(engine, compact_bounces=False, **kw)))
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    assert np.isfinite(a).all()


def test_compact_stay_image_identical():
    """The stay-compacted bounce loop (state kept in compacted order,
    one packed gather per bounce + one final scatter) is a pure
    scheduling change vs the per-bounce unsort path: identical image."""
    scene = _sphere_scene(reflectivity=0.6)
    cam = tracer.Camera(eye=(0, 0.8, 3.5), look_at=(0, 0, 0))
    kw = dict(width=48, height=48, bounces=2, shadows=True,
              compact_bounces=True)
    a = np.asarray(tracer.render(
        scene, cam, _cfg("kernel", compact_stay=True, **kw)))
    b = np.asarray(tracer.render(
        scene, cam, _cfg("kernel", compact_stay=False, **kw)))
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    assert np.isfinite(a).all()


def test_bounce_width_ladder_image_identical():
    """The bounce shape ladder (closest+shade at a runtime-chosen
    width R >> k, lax.cond over the live count) is exact: live rays are
    a compacted prefix and per-ray results are launch-width-independent."""
    scene = _sphere_scene(reflectivity=0.6)
    cam = tracer.Camera(eye=(0, 0.8, 3.5), look_at=(0, 0, 0))
    kw = dict(width=64, height=64, bounces=2, shadows=True,
              compact_bounces=True, compact_stay=True)
    a = np.asarray(tracer.render(
        scene, cam, _cfg("kernel", bounce_width_ladder=2, **kw)))
    b = np.asarray(tracer.render(
        scene, cam, _cfg("kernel", bounce_width_ladder=0, **kw)))
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    assert np.isfinite(a).all()


@pytest.mark.parametrize("method",
                         ["argsort", "argsort_om", "octant", "partition"])
def test_compact_methods_image_identical(method):
    """Every compaction permutation (full Morton argsort, octant
    counting sort, active-first partition — rt.tracer._compact_perm) is
    a pure scheduling change: identical image."""
    scene = _sphere_scene(reflectivity=0.6)
    cam = tracer.Camera(eye=(0, 0.8, 3.5), look_at=(0, 0, 0))
    kw = dict(width=32, height=32, bounces=2, shadows=True, engine="bvh")
    a = np.asarray(tracer.render(
        scene, cam, tracer.RTConfig(compact_bounces=True,
                                    compact_method=method, **kw)))
    b = np.asarray(tracer.render(
        scene, cam, tracer.RTConfig(compact_bounces=False, **kw)))
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_bucket_perm_is_stable_counting_sort():
    rng = np.random.default_rng(0)
    key = jnp.asarray(rng.integers(0, 9, size=1000).astype(np.int32))
    perm, inv = tracer._bucket_perm(key, 9)
    perm, inv = np.asarray(perm), np.asarray(inv)
    k = np.asarray(key)
    sorted_keys = k[perm]
    assert (np.diff(sorted_keys) >= 0).all()          # bucket-ordered
    # stability: equal keys keep original relative order
    for b in range(9):
        idx = perm[sorted_keys == b]
        assert (np.diff(idx) > 0).all()
    # inv really inverts
    assert (perm[inv] == np.arange(1000)).all()
    assert (inv[perm] == np.arange(1000)).all()
