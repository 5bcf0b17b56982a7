"""Deferred-shading drawcall renderer — the optimized exact path.

The immediate-mode oracle (ref.renderer) shades and textures every covered
fragment of every primitive.  The expensive part is texture gather;
this module restructures the draw into

  pass 1 (visibility): scan primitives per tile carrying only
      (depth-stencil word, winner/fragment-slot state) per pixel —
      cheap int/float ops, no gathers except one row of edge/z data
      per primitive step
  pass 2 (shading): shade only the pixels'/fragments' surviving
      primitives — one texture gather per *contributing* fragment instead
      of one per rasterized fragment

Exactness, matching the sequential OM semantics of om_unit.cpp:24-154:

  * the depth-stencil word carry applies the FULL DepthTencil::test
    (stencil func → depth func → stencil op, graphics.cpp:564-596) plus
    the masked ds write (om_unit.cpp:118-127) per primitive step, so the
    zbuf/stencil buffer after the draw is exact for any state
  * blending DISABLED: the color word equals the LAST passing covered
    fragment's masked color write — track that fragment's pid (`win`) in
    the carry and shade it once per pixel in pass 2
  * blending ENABLED: every passing covered fragment contributes, in
    primitive submission order.  Pass 1 additionally records each pixel's
    passing pids into K per-pixel slots (K static); pass 2 shades each
    slot and folds Blender::blend + masked write (om_unit.cpp:107-135)
    sequentially over the K slots.  A per-draw max-slot-count output lets
    the caller re-dispatch with a larger K on overflow, so the result is
    exact for any depth complexity.

Face is hardwired front (draw3d/kernel.cpp:225 passes face=0), so only
the front stencil state applies — same assumption as the oracle.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.state import RenderState
from ..om import blend as blend_mod
from ..om import merger as om_merger
from ..raster import edge as edge_mod
from ..raster import interp as interp_mod
from ..texture import sampler as sampler_mod

I32 = jnp.int32
U32 = jnp.uint32
FX24_ONE = 1 << 24

DEFAULT_BLEND_SLOTS = 4


def deferrable(render_state: RenderState) -> bool:
    """True when the single-winner (blend-off) fast path applies.

    Blended draws use the slotted deferred path instead (still deferred,
    never the immediate oracle) — this predicate only selects between the
    two pass-2 strategies."""
    return not render_state.om.blend.enabled


def _ds_update(om, flags, zattr_p, dx, dy, cov, dsw):
    """One primitive's exact depth-stencil step over a pixel grid.

    Computes the shader's depth output (z interpolation or the DEFAULTS
    z=0, draw3d/kernel.cpp:16-23) and applies the shared exact ds-carry
    update (om.merger.ds_carry_update).  Returns (new dsw, contrib).
    """
    if flags.depth_enabled:
        z = interp_mod.interpolate(zattr_p, dx, dy)
    else:
        z = jnp.zeros_like(dx)               # shader DEFAULTS z=0
    return om_merger.ds_carry_update(om, z.astype(U32), cov, dsw)


def _visibility_tiles(render_state, edges, zattr, tile_pids, tile_xy,
                      fb_ds_tiles, tile_logsize, blend_slots=0):
    """Pass 1: per-tile primitive scan.

    blend_slots == 0  -> (dsw (T,ts,ts) u32, winner pid (T,ts,ts) i32)
    blend_slots == K  -> (dsw, slots (T,K,ts,ts) i32 pids (-1 empty),
                          cnt (T,ts,ts) i32 passing-fragment count)

    zattr: (P, 3) int32 fixed24 z plane (x, y, c).
    """
    ts = 1 << tile_logsize
    om = render_state.om
    flags = render_state.flags

    def one_tile(pids, ds0, origin):
        ys = jax.lax.broadcasted_iota(I32, (ts, ts), 0) + origin[1]
        xs = jax.lax.broadcasted_iota(I32, (ts, ts), 1) + origin[0]

        def prim_step(dsw, pid):
            valid = pid >= 0
            p = jnp.maximum(pid, 0)
            evals = edge_mod.eval_edges(edges[p], xs, ys)
            cov = edge_mod.coverage(evals, xs, ys, render_state.scissor) & valid
            dx, dy = interp_mod.gradients(evals)
            dsw, contrib = _ds_update(om, flags, zattr[p], dx, dy, cov, dsw)
            return dsw, contrib, p

        if blend_slots == 0:
            def step(carry, pid):
                dsw, win = carry
                dsw, contrib, p = prim_step(dsw, pid)
                win = jnp.where(contrib, p, win)
                return (dsw, win), None

            win0 = jnp.full((ts, ts), -1, I32)
            (dsw, win), _ = jax.lax.scan(step, (ds0, win0), pids)
            return dsw, win

        K = blend_slots
        k_iota = jax.lax.broadcasted_iota(I32, (K, ts, ts), 0)

        def step(carry, pid):
            dsw, slots, cnt = carry
            dsw, contrib, p = prim_step(dsw, pid)
            onehot = (k_iota == cnt[None]) & contrib[None]
            slots = jnp.where(onehot, p, slots)
            cnt = cnt + contrib.astype(I32)
            return (dsw, slots, cnt), None

        slots0 = jnp.full((K, ts, ts), -1, I32)
        cnt0 = jnp.zeros((ts, ts), I32)
        (dsw, slots, cnt), _ = jax.lax.scan(step, (ds0, slots0, cnt0), pids)
        return dsw, slots, cnt

    origins = tile_xy * ts
    return jax.vmap(one_tile)(tile_pids, fb_ds_tiles, origins)


def _shade_pixels(render_state, texels, edges, attribs, win, xs, ys):
    """Pass 2: per-pixel shading of winners (win >= 0).

    Recomputes the winner's edge values/gradients and runs the exact
    interpolate/texture/modulate shader (draw3d/kernel.cpp:167-228) once
    per pixel.  Returns packed ARGB uint32.
    """
    flags = render_state.flags
    p = jnp.maximum(win, 0)
    e = edges[p]                                # (..., 3, 3) pixelwise gather
    ex = e[..., 0]
    ey = e[..., 1]
    ez = e[..., 2]
    evals = jnp.stack([ex[..., k] * xs + ey[..., k] * ys + ez[..., k]
                       for k in range(3)])
    dx, dy = interp_mod.gradients(evals)

    at = attribs[p]                             # (..., 7, 3)

    def interp(idx):
        a = at[..., idx, :]
        tmp = jnp.asarray(
            interp_mod.fixed.imadd24(a[..., 0], dx, a[..., 2]))
        return interp_mod.fixed.imadd24(a[..., 1], dy, tmp)

    if flags.color_enabled:
        r = interp(1)
        g = interp(2)
        b = interp(3)
        a_ = interp(4)
    else:
        r = g = b = a_ = jnp.full_like(dx, FX24_ONE)

    if flags.tex_enabled:
        u = interp(5)
        v = interp(6)
        tex_color = sampler_mod.sample(
            render_state.tex, texels,
            jnp.right_shift(u, 1), jnp.right_shift(v, 1), lod=0)
        if flags.tex_modulate:
            return interp_mod.modulate(r, g, b, a_, tex_color)
        return tex_color
    return interp_mod.to_rgba8(r, g, b, a_)


def _merge_color(om, valid, color, dst):
    """Masked color write (om_unit.cpp:129-135) of one fragment layer."""
    cmask = jnp.uint32(om.cbuf_writemask)
    merged = jnp.bitwise_or(jnp.bitwise_and(dst, ~cmask),
                            jnp.bitwise_and(color, cmask))
    return jnp.where(valid, merged, dst)


def render_tiles_deferred(render_state, texels, edges, attribs, zattr,
                          tile_pids, tile_xy, sel_c, sel_d, tile_logsize,
                          blend_slots=0):
    """Both deferred passes over a set of gathered framebuffer tiles.

    sel_c, sel_d: (T, ts, ts) uint32 tiles gathered at tile_xy.  Returns
    (out_c (T,ts,ts), out_d (T,ts,ts), max_frag_count scalar).  This is
    the unit the tile-striping shard layer distributes across devices
    (parallel.draw_shard) — pure per-tile compute, no global scatter.
    """
    ts = 1 << tile_logsize
    om = render_state.om
    max_cnt = jnp.int32(0)

    if blend_slots == 0:
        dsw, win = _visibility_tiles(render_state, edges, zattr,
                                     tile_pids, tile_xy, sel_d,
                                     tile_logsize)
    else:
        dsw, slots, cnt = _visibility_tiles(
            render_state, edges, zattr, tile_pids, tile_xy, sel_d,
            tile_logsize, blend_slots=blend_slots)
        max_cnt = jnp.max(cnt)

    # pass 2 over the selected tiles' pixels
    origins = tile_xy * ts
    ys = (jax.lax.broadcasted_iota(I32, (1, ts, ts), 1)
          + origins[:, 1][:, None, None])
    xs = (jax.lax.broadcasted_iota(I32, (1, ts, ts), 2)
          + origins[:, 0][:, None, None])

    if blend_slots == 0:
        color = _shade_pixels(render_state, texels, edges, attribs, win,
                              xs, ys)
        if om.color_write:
            sel_c = _merge_color(om, win >= 0, color, sel_c)
    else:
        # fold slots in primitive submission order: blend reads the
        # evolving destination (om_unit.cpp:107-113) then masked-writes
        for k in range(blend_slots):
            win_k = slots[:, k]
            color = _shade_pixels(render_state, texels, edges, attribs,
                                  win_k, xs, ys)
            blended = blend_mod.blend(om.blend, color, sel_c)
            if om.color_write:
                sel_c = _merge_color(om, win_k >= 0, blended, sel_c)

    return sel_c, dsw, max_cnt


@functools.partial(jax.jit, static_argnames=("render_state", "tile_logsize",
                                             "blend_slots"))
def _render_deferred_jit(render_state, texels, edges, attribs, zattr,
                         tile_pids, tile_xy, fb_color, fb_ds, tile_logsize,
                         blend_slots=0):
    """Returns (fb_color, fb_ds, max_frag_count).  max_frag_count is the
    per-pixel passing-fragment maximum (blend path only; 0 otherwise) —
    callers re-dispatch with blend_slots >= max_frag_count on overflow."""
    ts = 1 << tile_logsize
    Hp, Wp = fb_color.shape
    gh, gw = Hp // ts, Wp // ts

    fbc_t = fb_color.reshape(gh, ts, gw, ts).transpose(0, 2, 1, 3)
    fbd_t = fb_ds.reshape(gh, ts, gw, ts).transpose(0, 2, 1, 3)
    tx = tile_xy[:, 0]
    ty = tile_xy[:, 1]

    sel_c, dsw, max_cnt = render_tiles_deferred(
        render_state, texels, edges, attribs, zattr, tile_pids, tile_xy,
        fbc_t[ty, tx], fbd_t[ty, tx], tile_logsize,
        blend_slots=blend_slots)

    fbc_t = fbc_t.at[ty, tx].set(sel_c)
    fbd_t = fbd_t.at[ty, tx].set(dsw)
    fb_color = fbc_t.transpose(0, 2, 1, 3).reshape(Hp, Wp)
    fb_ds = fbd_t.transpose(0, 2, 1, 3).reshape(Hp, Wp)
    return fb_color, fb_ds, max_cnt


@functools.partial(jax.jit, static_argnames=("render_state", "tile_logsize"))
def _count_jit(render_state, edges, zattr, tile_pids, tile_xy, fb_ds,
               tile_logsize):
    """MEASURED per-draw fragment counters (emulator.cpp:416-545 analog).

    Replays pass 1's exact coverage + depth/stencil carry against the live
    depth-stencil buffer and counts, per draw:
      covered  — fragments emitted by the rasterizer (stamp/tex-read count)
      passing  — fragments that pass the ds test (OM write count)
    Unlike runtime.perf.drawcall_traffic's coverage-area upper bound, these
    are the actual counts the reference's units would record.
    """
    ts = 1 << tile_logsize
    Hp, Wp = fb_ds.shape
    gh, gw = Hp // ts, Wp // ts
    fbd_t = fb_ds.reshape(gh, ts, gw, ts).transpose(0, 2, 1, 3)
    sel_d = fbd_t[tile_xy[:, 1], tile_xy[:, 0]]
    om = render_state.om
    flags = render_state.flags

    def one_tile(pids, ds0, origin):
        ys = jax.lax.broadcasted_iota(I32, (ts, ts), 0) + origin[1]
        xs = jax.lax.broadcasted_iota(I32, (ts, ts), 1) + origin[0]

        def step(carry, pid):
            dsw, ncov, npass = carry
            valid = pid >= 0
            p = jnp.maximum(pid, 0)
            evals = edge_mod.eval_edges(edges[p], xs, ys)
            cov = edge_mod.coverage(evals, xs, ys,
                                    render_state.scissor) & valid
            dx, dy = interp_mod.gradients(evals)
            dsw, contrib = _ds_update(om, flags, zattr[p], dx, dy, cov, dsw)
            return (dsw, ncov + cov.sum(dtype=I32),
                    npass + contrib.sum(dtype=I32)), None

        (dsw, ncov, npass), _ = jax.lax.scan(
            step, (ds0, jnp.int32(0), jnp.int32(0)), pids)
        return ncov, npass

    ncov, npass = jax.vmap(one_tile)(tile_pids, sel_d, tile_xy * ts)
    return ncov.sum(), npass.sum()


def measure_drawcall_counts(render_state: RenderState, binned,
                            fb_ds) -> dict:
    """Exact fragment counts for one drawcall against the current ds
    buffer.  Returns {"fragments": covered, "om_passing": passing}."""
    ncov, npass = _count_jit(
        render_state, jnp.asarray(binned.edges),
        jnp.asarray(binned.attribs[:, 0]), jnp.asarray(binned.tile_pids),
        jnp.asarray(binned.tile_xy), fb_ds, binned.tile_logsize)
    return {"fragments": int(ncov), "om_passing": int(npass)}


def _next_pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def render_drawcall(render_state: RenderState, texels, binned,
                    fb_color, fb_ds, info=None,
                    blend_k=None, overflow_out=None):
    """Deferred render of one drawcall — exact for every OM state.

    Blended draws start at DEFAULT_BLEND_SLOTS per-pixel fragment slots
    and re-dispatch with the measured count on overflow (one host sync of
    a scalar per blended draw).  info, when a dict, receives
    ``blend_k`` = the K that sufficed (0 for non-blended draws) and
    ``max_frag_count`` — callers like driver.compile_frame use it to pick
    static slot counts.

    blend_k: a previously-measured slot count for THIS draw (e.g. from a
    frame-level cache).  The draw dispatches once with that static K and
    — instead of syncing — appends ``(blend_k, max_cnt_device_scalar)``
    to ``overflow_out`` (a list) for the caller to verify at frame end,
    where the framebuffer materialization has already paid the sync
    (VERDICT r3 #7: no per-draw host sync in the steady-state eager
    frame path).  With blend_k set and overflow_out=None the count is
    verified synchronously (falls back to the retry loop on overflow).
    """
    if texels is None:
        texels = jnp.zeros((1,), jnp.uint32)
    # device-array cache: eager render loops call this per frame with the
    # same binned host arrays — re-uploading them per call costs H2D
    # transfers every draw
    dev = getattr(binned, "_dev_arrays", None)
    if dev is None:
        dev = (jnp.asarray(binned.edges), jnp.asarray(binned.attribs),
               jnp.asarray(binned.attribs[:, 0]),
               jnp.asarray(binned.tile_pids), jnp.asarray(binned.tile_xy))
        binned._dev_arrays = dev
    args = (render_state, texels) + dev + (fb_color, fb_ds,
                                           binned.tile_logsize)

    if deferrable(render_state):
        fbc, fbd, _ = _render_deferred_jit(*args)
        if info is not None:
            info["blend_k"] = 0
        return fbc, fbd

    max_k = binned.tile_pids.shape[1]          # cannot exceed prims/tile
    if blend_k is not None:
        k = min(max(int(blend_k), 1), max_k)
        fbc, fbd, max_cnt = _render_deferred_jit(
            *args, blend_slots=k)
        if overflow_out is not None:
            overflow_out.append((k, max_cnt))   # deferred verification
            if info is not None:
                info["blend_k"] = k
            return fbc, fbd
        m = int(max_cnt)
        if m <= k or k >= max_k:
            if info is not None:
                info["blend_k"] = k
                info["max_frag_count"] = m
            return fbc, fbd
        # stale hint: continue into the measuring retry loop from m
        k = min(_next_pow2(m), max_k)
    else:
        k = DEFAULT_BLEND_SLOTS
    while True:
        fbc, fbd, max_cnt = _render_deferred_jit(
            *args, blend_slots=min(k, max_k))
        m = int(max_cnt)
        if m <= k or k >= max_k:
            break
        k = min(_next_pow2(m), max_k)
    if info is not None:
        info["blend_k"] = min(k, max_k)
        info["max_frag_count"] = m
    return fbc, fbd
