"""Whole tracer frames with the GPU traversal kernel (in the Pallas
interpreter) against the same frames on the XLA stackless walk, engine
"bvh" — the kernel's plain reference.  Both walk the same node arrays
with the same arithmetic and the same (t, prim) order, so the images
agree to float noise over bounces, shadows and the bounce width ladder.
"""
import numpy as np
import pytest

from skybox_rt_tpu.models import scenes
from skybox_rt_tpu.rt import tracer


def _scene():
    verts, faces, colors = scenes.sphere_field(copies=4, subdiv=1)
    return tracer.RTScene(verts=verts, faces=faces, colors=colors,
                          reflectivity=0.35)


CAM = tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                    fov_y_deg=55.0)


@pytest.mark.parametrize("ladder", [0, 2])
@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("bounces", [0, 1, 2])
def test_kernel_frame_matches_bvh(bounces, shadows, ladder):
    scene = _scene()
    kw = dict(width=32, height=32, bounces=bounces, shadows=shadows,
              bounce_width_ladder=ladder)
    got = np.asarray(tracer.render(
        scene, CAM, tracer.RTConfig(engine="kernel", interpret=True, **kw)))
    want = np.asarray(tracer.render(
        scene, CAM, tracer.RTConfig(engine="bvh", **kw)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[..., :3].sum(-1) > 0).mean() > 0.1      # the scene is hit
