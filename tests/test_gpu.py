"""Card-only tests: the traversal kernel compiled by Triton for the GPU.

The CPU suite runs the same kernel in the Pallas interpreter
(tests/test_traverse.py); these tests compile it for the card and compare
it with its plain reference, the XLA stackless walk, on the same device.
They skip where JAX has no GPU; chip_smoke.py runs them on the card.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from skybox_rt_tpu.models import scenes
from skybox_rt_tpu.ops import traverse
from skybox_rt_tpu.rt import bvh as bvh_mod
from skybox_rt_tpu.rt import intersect, tracer

pytestmark = pytest.mark.gpu


def _field(copies=4, subdiv=3):
    v, f, c = scenes.sphere_field(copies=copies, subdiv=subdiv)
    b = bvh_mod.build(v, f, method="sah")
    tri = intersect.triangle_arrays(jnp.asarray(v), jnp.asarray(f))
    sl = b.as_stackless_arrays()
    return traverse.prepare_scene(sl, tri, b.leaf_size), sl, tri, b


def _rays(R, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 2.0
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("R", [1, traverse.BLOCK * 2048,
                               traverse.BLOCK * 2048 + 77])
def test_closest_compiled_matches_stackless(gpu_device, R):
    """Whole programs and a partial last program."""
    scene, sl, tri, b = _field()
    o, d = _rays(R)
    p, t, u, v = jax.jit(lambda o, d: traverse.traverse(scene, o, d))(o, d)
    rp, rt_, _, _ = bvh_mod.closest_hit_stackless(sl, tri, o, d,
                                                  leaf_size=b.leaf_size)
    np.testing.assert_array_equal(np.asarray(p), np.asarray(rp))
    hit = np.asarray(rp) >= 0
    assert R == 1 or hit.mean() > 0.05
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(rt_)[hit],
                               rtol=1e-5)


def test_any_compiled_matches_stackless(gpu_device):
    scene, sl, tri, b = _field()
    o, d = _rays(65536, seed=1)
    tm = jnp.asarray(np.random.default_rng(2).uniform(1, 8, 65536),
                     jnp.float32)
    got = jax.jit(lambda o, d: traverse.traverse(
        scene, o, d, mode="any", t_max=tm))(o, d)
    want = bvh_mod.any_hit_stackless(sl, tri, o, d, t_max=tm,
                                     leaf_size=b.leaf_size)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_after_compiled_matches_stackless(gpu_device):
    scene, sl, tri, b = _field(copies=4, subdiv=2)
    o, d = _rays(16384, seed=3)
    tlo = jnp.full((o.shape[0],), -jnp.inf, jnp.float32)
    plo = jnp.full((o.shape[0],), -1, jnp.int32)
    klo, kplo = tlo, plo
    for _ in range(4):
        p, t, _, _ = traverse.traverse(scene, o, d, mode="after",
                                       t_lo=klo, prim_lo=kplo)
        rp, rt_, _, _ = bvh_mod.closest_hit_stackless(
            sl, tri, o, d, leaf_size=b.leaf_size, t_lo=tlo, p_lo=plo)
        np.testing.assert_array_equal(np.asarray(p), np.asarray(rp))
        klo, kplo, tlo, plo = t, p, rt_, rp


def test_tracer_frame_compiled_matches_bvh(gpu_device):
    v, f, c = scenes.sphere_field(copies=4, subdiv=3)
    scene = tracer.RTScene(verts=v, faces=f, colors=c, reflectivity=0.35)
    cam = tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                        fov_y_deg=55.0)
    kw = dict(width=256, height=256, bounces=2, shadows=True)
    got = np.asarray(tracer.render(scene, cam,
                                   tracer.RTConfig(engine="kernel", **kw)))
    want = np.asarray(tracer.render(scene, cam,
                                    tracer.RTConfig(engine="bvh", **kw)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert tracer.resolve_engine(tracer.RTConfig(**kw)) == "kernel"
