"""Ray-sharded RT rendering == single-device rendering (SURVEY §2.7:
multi-host DP over rays; correctness oracle = the unsharded frame, since
no multi-device golden exists — SURVEY §7 'Multi-host goldens')."""
import jax
import numpy as np
import pytest

from skybox_rt_tpu.models import scenes
from skybox_rt_tpu.parallel import mesh as mesh_mod
from skybox_rt_tpu.parallel import ray_shard
from skybox_rt_tpu.rt import tracer


def _scene():
    verts, faces = scenes.icosphere(subdiv=2)
    colors = np.tile(np.array([[0.8, 0.3, 0.25, 1.0]], np.float32),
                     (verts.shape[0], 1))
    return tracer.RTScene(verts=verts.astype(np.float32),
                          faces=faces.astype(np.int32), colors=colors,
                          reflectivity=0.4)


CAM = tracer.Camera(eye=(0.0, 0.6, 3.2), look_at=(0.0, -0.1, 0.0))


@pytest.mark.parametrize("n,engine,shadows,bounces", [
    (2, "bvh", False, 0),
    (4, "bvh", True, 1),
    (8, "brute", True, 0),
    (2, "kernel", True, 0),
])
def test_sharded_matches_single(n, engine, shadows, bounces):
    if len(jax.devices()) < n:
        pytest.skip("not enough devices")
    scene = _scene()
    # 40x48: rows not divisible by 8 devices forces the padding path
    cfg = tracer.RTConfig(width=48, height=40, shadows=shadows,
                          bounces=bounces, engine=engine,
                          interpret=engine == "kernel")
    ref = np.asarray(tracer.render(scene, CAM, cfg))
    mesh = mesh_mod.make_mesh(n)
    got = np.asarray(ray_shard.render_sharded(scene, CAM, cfg, mesh))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_sharded_northstar_config_matches_single():
    """The north-star scene class (multi-object sphere field + ground,
    multi-bounce + shadows, the kernel engine in the Pallas
    interpreter) ray-sharded over the CPU mesh == the single-device
    frame (chip_smoke.py --four runs the same check at 1024^2 on four
    GPUs)."""
    n = min(4, len(jax.devices()))
    if n < 2:
        pytest.skip("not enough devices")
    verts, faces, colors = scenes.sphere_field(copies=4, subdiv=2)
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                           reflectivity=0.35)
    cam = tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                        fov_y_deg=55.0)
    cfg = tracer.RTConfig(width=48, height=40, bounces=2, shadows=True,
                          engine="kernel", interpret=True)
    ref = np.asarray(tracer.render(scene, cam, cfg))
    mesh = mesh_mod.make_mesh(n)
    got = np.asarray(ray_shard.render_sharded(scene, cam, cfg, mesh))
    np.testing.assert_allclose(got, ref, atol=1e-6)
