"""Tile-striped multi-device execution of the exact-int draw3d path.

The reference's primary parallel axis stripes a drawcall's binned tiles
round-robin across raster units: unit i of N takes tiles i, i+N, i+2N, ...
(sim/simx/raster_unit.cpp:109-114,221-227; SW twin gpu_sw.h:38).  This
module applies the identical rule across a JAX device mesh:

  * geometry (edge/attribute planes, texel table) is REPLICATED — same as
    the reference, where every raster unit reads the shared primbuf
  * the tile list is PERMUTED into round-robin strips (device i's block
    holds tiles i, i+N, ...) and sharded over the mesh axis, so shard_map's
    blocked partitioning realizes exactly the reference's striding rule
  * each device runs the unchanged exact deferred passes
    (ops.deferred.render_tiles_deferred) on its own tiles — bit-exact by
    construction, since tiles are independent given the pre-draw fb state
  * framebuffer assembly: each device scatter-adds its owned tiles into a
    zeroed frame, one psum sums the disjoint contributions, and unowned
    tiles keep the incoming fb — integer-exact (every real tile has
    exactly one contributor)

The result is bit-identical to the single-device renderer for every OM
state (including blended draws via the slotted pass), which the golden
tests assert at mesh sizes 1/2/4/8 (tests/test_draw_shard.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..ops import deferred
from ..ref import renderer as ref_renderer

I32 = jnp.int32
U32 = jnp.uint32


def stripe_tiles(binned, n_devices: int):
    """Round-robin tile striping (raster_unit.cpp:221-227): device i's
    contiguous shard block holds tiles i, i+N, i+2N, ... padded to equal
    length with invalid tiles.  Returns (tile_pids, tile_xy, tile_valid)
    with leading dim n_devices * ceil(T/N)."""
    tile_pids = np.asarray(binned.tile_pids)
    tile_xy = np.asarray(binned.tile_xy)
    T, M = tile_pids.shape
    Tl = -(-T // n_devices)
    pids = np.full((n_devices, Tl, M), -1, np.int32)
    xy = np.zeros((n_devices, Tl, 2), np.int32)
    valid = np.zeros((n_devices, Tl), np.int32)
    for i in range(n_devices):
        sel = np.arange(i, T, n_devices)
        pids[i, : len(sel)] = tile_pids[sel]
        xy[i, : len(sel)] = tile_xy[sel]
        valid[i, : len(sel)] = 1
    return (pids.reshape(n_devices * Tl, M),
            xy.reshape(n_devices * Tl, 2),
            valid.reshape(n_devices * Tl))


@functools.lru_cache(maxsize=None)
def _sharded_draw_fn(mesh, render_state, tile_logsize, blend_slots):
    """Build (and cache) the jitted shard-mapped drawcall renderer for one
    (mesh, state) combination."""
    axis = tuple(mesh.axis_names)   # 1D or hosts x chips (mesh.make_mesh_2d)
    ts = 1 << tile_logsize

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(), P(), P()), check_vma=False)
    def _render(texels, edges, attribs, zattr, tile_pids, tile_xy,
                tile_valid, fbc_t, fbd_t):
        gh, gw = fbc_t.shape[:2]
        tx = tile_xy[:, 0]
        ty = tile_xy[:, 1]
        out_c, out_d, max_cnt = deferred.render_tiles_deferred(
            render_state, texels, edges, attribs, zattr, tile_pids,
            tile_xy, fbc_t[ty, tx], fbd_t[ty, tx], tile_logsize,
            blend_slots=blend_slots)

        v = tile_valid.astype(U32)[:, None, None]
        upd_c = jnp.zeros((gh, gw, ts, ts), U32).at[ty, tx].add(out_c * v)
        upd_d = jnp.zeros((gh, gw, ts, ts), U32).at[ty, tx].add(out_d * v)
        cnt = jnp.zeros((gh, gw), I32).at[ty, tx].add(tile_valid)

        upd_c = jax.lax.psum(upd_c, axis)
        upd_d = jax.lax.psum(upd_d, axis)
        cnt = jax.lax.psum(cnt, axis)
        max_cnt = jax.lax.pmax(max_cnt, axis)

        owned = (cnt > 0)[:, :, None, None]
        return (jnp.where(owned, upd_c, fbc_t),
                jnp.where(owned, upd_d, fbd_t), max_cnt)

    @jax.jit
    def fn(texels, edges, attribs, zattr, tile_pids, tile_xy, tile_valid,
           fb_color, fb_ds):
        Hp, Wp = fb_color.shape
        gh, gw = Hp // ts, Wp // ts
        fbc_t = fb_color.reshape(gh, ts, gw, ts).transpose(0, 2, 1, 3)
        fbd_t = fb_ds.reshape(gh, ts, gw, ts).transpose(0, 2, 1, 3)
        fbc_t, fbd_t, max_cnt = _render(
            texels, edges, attribs, zattr, tile_pids, tile_xy, tile_valid,
            fbc_t, fbd_t)
        fb_color = fbc_t.transpose(0, 2, 1, 3).reshape(Hp, Wp)
        fb_ds = fbd_t.transpose(0, 2, 1, 3).reshape(Hp, Wp)
        return fb_color, fb_ds, max_cnt

    return fn


def render_drawcall_sharded(mesh, render_state, texels, binned,
                            fb_color, fb_ds, info=None,
                            blend_k=None, overflow_out=None):
    """Tile-striped exact render of one drawcall over the mesh.

    Bit-identical to ops.deferred.render_drawcall (same passes, same blend
    slot/overflow protocol, lax.pmax-ed across devices).  blend_k /
    overflow_out: cached-K dispatch with frame-end overflow verification,
    same contract as ops.deferred.render_drawcall (VERDICT r3 #7)."""
    n = int(np.prod(mesh.devices.shape))
    if texels is None:
        texels = jnp.zeros((1,), jnp.uint32)
    # per-(binned, n) device-array cache — same rationale as
    # ops.deferred.render_drawcall's _dev_arrays
    cache = getattr(binned, "_dev_stripes", None)
    if cache is None:
        cache = {}
        binned._dev_stripes = cache
    dev = cache.get(n)
    if dev is None:
        pids, xy, valid = stripe_tiles(binned, n)
        dev = (jnp.asarray(binned.edges), jnp.asarray(binned.attribs),
               jnp.asarray(binned.attribs[:, 0]), jnp.asarray(pids),
               jnp.asarray(xy), jnp.asarray(valid))
        cache[n] = dev
    args = (texels,) + dev + (fb_color, fb_ds)

    if deferred.deferrable(render_state):
        fn = _sharded_draw_fn(mesh, render_state, binned.tile_logsize, 0)
        fbc, fbd, _ = fn(*args)
        if info is not None:
            info["blend_k"] = 0
        return fbc, fbd

    max_k = binned.tile_pids.shape[1]
    if blend_k is not None:
        k = min(max(int(blend_k), 1), max_k)
        fn = _sharded_draw_fn(mesh, render_state, binned.tile_logsize, k)
        fbc, fbd, max_cnt = fn(*args)
        if overflow_out is not None:
            overflow_out.append((k, max_cnt))
            if info is not None:
                info["blend_k"] = k
            return fbc, fbd
        m = int(max_cnt)
        if m <= k or k >= max_k:
            if info is not None:
                info["blend_k"] = k
                info["max_frag_count"] = m
            return fbc, fbd
        k = min(deferred._next_pow2(m), max_k)
    else:
        k = deferred.DEFAULT_BLEND_SLOTS
    while True:
        fn = _sharded_draw_fn(mesh, render_state, binned.tile_logsize,
                              min(k, max_k))
        fbc, fbd, max_cnt = fn(*args)
        m = int(max_cnt)
        if m <= k or k >= max_k:
            break
        k = min(deferred._next_pow2(m), max_k)
    if info is not None:
        info["blend_k"] = min(k, max_k)
        info["max_frag_count"] = m
    return fbc, fbd


def render_trace_sharded(trace, width: int, height: int, mesh,
                         tile_logsize: int = 5) -> np.ndarray:
    """Full-frame tile-striped render (the sharded twin of
    ref.driver.render_trace; persistent z/color buffers across draws).

    Shares the trace-attached blend-K cache with the single-device driver
    (the measured counts are identical — the sharded render is bit-exact
    and max_cnt is pmax-ed), so steady-state frames dispatch blended
    draws with a static K and verify overflow only at frame end."""
    from ..ref import driver as ref_driver

    draws = ref_driver.prepare_drawcalls(trace, width, height, tile_logsize)
    cache = getattr(trace, "_blend_k_cache", None)
    if cache is None:
        cache = {}
        trace._blend_k_cache = cache
    # "prepared" namespace: prepare_drawcalls drops unbinnable draws, so
    # its indices differ from render_trace's raw drawcall indices
    ks = cache.setdefault((width, height, tile_logsize, "prepared"), {})
    pending = []
    fbc = np.full((height, width), ref_driver.CLEAR_COLOR, np.uint32)
    fbd = np.full((height, width), ref_driver.CLEAR_DEPTH, np.uint32)
    fbc = jnp.asarray(ref_renderer.pad_framebuffer(fbc, tile_logsize))
    fbd = jnp.asarray(ref_renderer.pad_framebuffer(fbd, tile_logsize))
    for d, (rs, texels, binned) in enumerate(draws):
        info = {}
        hint = ks.get(d)
        fbc, fbd = render_drawcall_sharded(
            mesh, rs, texels, binned, fbc, fbd,
            info=info, blend_k=hint or None,
            overflow_out=pending if hint else None)
        ks[d] = info["blend_k"]
    out = np.asarray(fbc)[:height, :width]
    if pending and any(int(mc) > k for k, mc in pending):
        cache.pop((width, height, tile_logsize, "prepared"), None)
        return render_trace_sharded(trace, width, height, mesh,
                                    tile_logsize)
    return out
