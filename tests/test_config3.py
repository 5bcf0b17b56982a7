"""Config-3 standing artifact (BASELINE.json configs[2]): the FULL RT
path — BVH traversal + textured shading + OM blend over-compositing — on
a multi-object scene with translucent layers, golden-pinned and
cross-validated against the raster path.

Scene: `vase` — 6 drawcalls: textured meshes plus translucent blended
layers (draws 1-5 blend-enabled), exactly the "several textured meshes +
a translucent blended layer" scene class.  Rendered by
rt.raster_bridge(engine="auto", camera="perspective"), i.e. the compiled
frame (rt.frame) on the device's traversal route: opaque winner
selection runs one closest-hit walk; blended draws the K-slot "closest
after" enumeration (the RT analog of the deferred blend slots).

Golden: self-pinned PNG (the reference has no RT renderer —
SURVEY §0), regenerated by scripts/make_config3_golden.py.  The raster
cross-check reuses the bridge-test tolerance (4/255).  The 512^2 size
runs in the @slow tier.
"""
import os

import numpy as np
import pytest

from skybox_rt_tpu.ref import driver
from skybox_rt_tpu.rt import raster_bridge
from skybox_rt_tpu.utils import image

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "config3_vase_128_rt.png")
SCENE, SIZE = "vase", 128


def _render(size):
    return raster_bridge.render_scene_rt(
        SCENE, size, size, engine="auto", camera="perspective")


def test_config3_rt_golden_and_raster_crosscheck():
    rt = _render(SIZE)
    assert np.isfinite(rt).all()

    # self-golden: the standing pin (catches any drift in the RT path)
    golden = image.load_png_argb(GOLDEN)
    # save_framebuffer_png writes bottom-up (the reference's PNG
    # convention, draw3d/main.cpp SaveImage); load returns top-down
    g = raster_bridge.framebuffer_to_float(golden)[::-1]
    diff_g = np.abs(rt[..., :3] - g[..., :3]).max(-1)
    assert (diff_g <= 2 / 255).mean() >= 0.9995, (
        f"golden drift: {(diff_g > 2/255).mean():.4%} pixels off "
        f"(max {diff_g.max():.4f})")

    # cross-validation against the bit-exact raster path where states
    # overlap (same rule/tolerance as test_perspective_rt_matches_raster)
    raster = raster_bridge.framebuffer_to_float(
        driver.render_scene(SCENE, SIZE, SIZE))
    diff = np.abs(rt[..., :3] - raster[..., :3]).max(-1)
    frac = (diff <= 4 / 255).mean()
    assert frac >= 0.995, (
        f"only {frac:.4f} of pixels match the raster path "
        f"(max diff {diff.max():.3f})")


@pytest.mark.slow
def test_config3_rt_512():
    """The full 512^2 artifact size."""
    rt = _render(512)
    raster = raster_bridge.framebuffer_to_float(
        driver.render_scene(SCENE, 512, 512))
    diff = np.abs(rt[..., :3] - raster[..., :3]).max(-1)
    assert (diff <= 4 / 255).mean() >= 0.995
