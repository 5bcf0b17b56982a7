"""Gradient-twin <-> golden-anchored-path cross-validation (VERDICT r4 #4).

The reference's pattern is triple-implementation cross-check: the same
frame through HW, device-SW, and RTL against one golden
(/root/reference/tests/regression/draw3d/main.cpp:110-118).  Here the
float DIFF pipeline (diff/pipeline) renders the same textured CGLTrace
drawcall as the bit-exact int path (ref/driver, pinned by the PNG
goldens) and the RT bridge, and must agree within a documented
tolerance — so drift in the gradient twin breaks CI instead of passing
silently against its own oracle.

Tolerance rationale: the int path is 8-bit fixed point (Div255-biased
blends, 8-bit bilinear weights, TFixed interpolation); the float twin
rounds differently, and hard-coverage edge pixels may flip on exact
edge-function ties.  Measured on tekkaman draw 1 (755 prims, textured,
MODULATE, depth LESS): >=99.9 % of pixels within 4/255, mean |diff|
~2e-3; the assert pins those margins.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from skybox_rt_tpu.core import constants as C
from skybox_rt_tpu.diff import binning as dbin
from skybox_rt_tpu.diff import pipeline
from skybox_rt_tpu.geom import cgltrace
from skybox_rt_tpu.ref import driver
from skybox_rt_tpu.rt import raster_bridge
from skybox_rt_tpu.texture import mipmap

W = H = 128


class _OneDraw:
    """Trace view holding a single drawcall (the -x/-u/-y single-unit
    swap analog: all three implementations see identical inputs)."""

    def __init__(self, trace, i):
        self.drawcalls = [trace.drawcalls[i]]
        self.textures = trace.textures


def _diff_render(trace, dc):
    """The gradient twin's view of the drawcall: same vertices/texture,
    rendered through diff/pipeline.render_deferred in hard mode."""
    tex = trace.textures[dc.texture_id]
    img = np.asarray(mipmap.texture_rgba_float(
        tex.pixels, C.CGL_TO_VX_FORMAT[tex.format], tex.width, tex.height))
    pos = np.asarray(dc.pos, np.float32)
    params = {"pos": jnp.asarray(pos),
              "color": jnp.asarray(np.asarray(dc.color, np.float32)),
              "uv": jnp.asarray(np.asarray(dc.texcoord, np.float32)),
              "tex": jnp.asarray(img)}
    cfg = pipeline.DiffRenderConfig(
        width=W, height=H, tile_logsize=5, near=dc.near, far=dc.far,
        depth_test=True, textured=True, modulate=True)
    static = dbin.bin_static(pos, np.asarray(dc.indices, np.int32), W, H,
                             tile_logsize=5)
    static = {k: jnp.asarray(v) for k, v in static.items()}
    out, _ = pipeline.render_deferred(params, static, cfg, slots=1)
    return np.asarray(out)[:H, :W]


@pytest.fixture(scope="module")
def trace():
    return cgltrace.load_cached(cgltrace.trace_path("tekkaman"))


def test_diff_pipeline_matches_int_reference(trace):
    """diff/pipeline vs the golden-anchored fixed-point path (draw 1: 755
    prims, textured, MODULATE, depth LESS)."""
    ref = raster_bridge.framebuffer_to_float(
        driver.render_trace(_OneDraw(trace, 1), W, H))
    out = _diff_render(trace, trace.drawcalls[1])
    diff = np.abs(out[..., :3] - ref[..., :3]).max(-1)
    frac = (diff <= 4 / 255).mean()
    assert frac >= 0.999, (
        f"gradient twin drifted from the golden-anchored path: only "
        f"{frac:.4%} of pixels within 4/255 (mean {diff.mean():.5f})")
    assert diff.mean() <= 5e-3, f"mean drift {diff.mean():.5f}"


def test_rt_bridge_matches_diff_pipeline(trace):
    """rt/raster_bridge (the compiled RT frame on the device's traversal
    route) vs diff/pipeline on the overlapping state (textured +
    modulate + depth LESS): the two float renderers must agree wherever
    both are defined."""
    rt = raster_bridge.render_trace_rt(_OneDraw(trace, 1), W, H,
                                       engine="auto", camera="perspective")
    out = _diff_render(trace, trace.drawcalls[1])
    diff = np.abs(out[..., :3] - rt[..., :3]).max(-1)
    frac = (diff <= 4 / 255).mean()
    assert frac >= 0.995, (
        f"RT bridge vs diff pipeline: only {frac:.4%} within 4/255 "
        f"(mean {diff.mean():.5f})")
