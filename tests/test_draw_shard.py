"""Sharded exact-int draw3d: the flagship path tile-striped over the mesh
must stay BIT-EXACT vs the reference goldens and the single-device
renderer at every mesh size (the reference's raster-unit striping rule,
raster_unit.cpp:221-227, applied across devices)."""
import numpy as np
import pytest

from skybox_rt_tpu.geom import cgltrace
from skybox_rt_tpu.parallel import draw_shard, mesh as mesh_mod
from skybox_rt_tpu.ref import driver
from skybox_rt_tpu.utils import image

ASSETS = "/root/reference/tests/regression/draw3d"


def _trace(name):
    return cgltrace.load_cached(cgltrace.trace_path(name))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_tekkaman_golden(n):
    mesh = mesh_mod.make_mesh(n)
    fb = draw_shard.render_trace_sharded(_trace("tekkaman"), 128, 128, mesh)
    errors, maxdiff = image.compare_to_golden(
        fb, f"{ASSETS}/tekkaman_ref_128.png")
    assert errors == 0 and maxdiff == 0


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_blended_scene_exact(n):
    """vase has 4 blended draws -> exercises the slotted pass under
    striping (pmax-ed overflow protocol)."""
    mesh = mesh_mod.make_mesh(n)
    ref = driver.render_scene("vase", 32, 32, mode="immediate")
    got = draw_shard.render_trace_sharded(_trace("vase"), 32, 32, mesh)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_striping_rule_matches_reference():
    """Device i's shard block must hold tiles i, i+N, i+2N, ...
    (raster_unit.cpp:221-227)."""
    binned = type("B", (), {})()
    T, M, n = 11, 3, 4
    binned.tile_pids = np.arange(T * M).reshape(T, M).astype(np.int32)
    binned.tile_xy = np.stack([np.arange(T), np.zeros(T)], -1).astype(np.int32)
    pids, xy, valid = draw_shard.stripe_tiles(binned, n)
    Tl = -(-T // n)
    pids = pids.reshape(n, Tl, M)
    valid = valid.reshape(n, Tl)
    for i in range(n):
        expect = np.arange(i, T, n)
        assert valid[i].sum() == len(expect)
        np.testing.assert_array_equal(
            pids[i, : len(expect), 0], binned.tile_pids[expect, 0])
