"""Deferred-shading path: exact equality with the immediate oracle
(the dual-backend equivalence pattern, SURVEY §4.2), plus the
single-dispatch whole-frame compiler."""
import numpy as np
import pytest

from skybox_rt_tpu.geom import cgltrace
from skybox_rt_tpu.ref import driver


SCENES = [("triangle", 64), ("tekkaman", 64), ("scene", 64),
          ("box", 64), ("vase", 32), ("evilskull", 32)]


@pytest.mark.parametrize("scene,size", SCENES)
def test_deferred_matches_immediate(scene, size):
    a = driver.render_scene(scene, size, size, mode="immediate")
    b = driver.render_scene(scene, size, size, mode="deferred")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_compile_frame_matches_render_trace():
    trace = cgltrace.load_cached(cgltrace.trace_path("tekkaman"))
    ref = driver.render_trace(trace, 64, 64)
    frame, arrays = driver.compile_frame(trace, 64, 64)
    got = np.asarray(frame(arrays))
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_compile_frame_modes_agree():
    """Single-dispatch frame compiler: immediate vs deferred inner paths
    must produce identical frames."""
    import jax
    import numpy as np

    from skybox_rt_tpu.geom import cgltrace
    from skybox_rt_tpu.ref import driver

    trace = cgltrace.load_cached(cgltrace.trace_path("tekkaman"))
    frames = {}
    for mode in ("immediate", "deferred"):
        fn, arrays = driver.compile_frame(trace, 64, 64, mode=mode)
        fb = fn(arrays)
        jax.block_until_ready(fb)
        frames[mode] = np.asarray(fb)
    np.testing.assert_array_equal(frames["immediate"], frames["deferred"])


@pytest.mark.parametrize("scene,size,tile_logsize", [
    ("triangle", 32, 3),      # 8x8 tiles
    ("triangle", 64, 4),      # 16x16 tiles
    ("box", 128, 5),
    ("vase", 32, 5),          # blended draws: the slotted pass
])
def test_deferred_matches_immediate_tile_sizes(scene, size, tile_logsize):
    """The deferred pass-1/pass-2 path is bit-exact vs the immediate
    oracle at every tile size, small tiles included."""
    from skybox_rt_tpu.ref import driver

    ref = driver.render_scene(scene, size, size, mode="immediate",
                              tile_logsize=tile_logsize)
    got = driver.render_scene(scene, size, size, mode="deferred",
                              tile_logsize=tile_logsize)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
