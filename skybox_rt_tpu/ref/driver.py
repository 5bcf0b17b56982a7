"""Frame driver: the host render loop (draw3d/main.cpp:171-390 analog).

Walks a CGLTrace's drawcalls, bins each one, resolves the per-draw
RenderState (with the reference host's exact DCR programming quirks,
core/state.py), and invokes the tile renderer.  The z and color buffers
persist across drawcalls, exactly like the reference's device-resident
zbuf/cbuf (main.cpp:470-490 allocate-once + clear).
"""
from __future__ import annotations

import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np

from ..core import constants as C
from ..core import state as state_mod
from ..geom import binning, cgltrace
from ..texture import sampler as sampler_mod
from ..texture.mipmap import generate_mipmaps
from . import renderer

CLEAR_COLOR = np.uint32(0xFF000000)   # main.cpp:47
CLEAR_DEPTH = np.uint32(0xFFFFFFFF)   # main.cpp:48


def log2ceil(x: int) -> int:
    return max(int(math.ceil(math.log2(x))), 0) if x > 1 else 0


@dataclasses.dataclass
class FrameStats:
    drawcalls: int = 0
    prims_binned: int = 0
    tiles: int = 0
    # analytic per-unit traffic (runtime.perf.drawcall_traffic, the
    # raster/tex/om MPM-counter analog), summed over draws
    traffic: dict = dataclasses.field(default_factory=dict)

    def add_traffic(self, t: dict):
        for k, v in t.items():
            self.traffic[k] = self.traffic.get(k, 0) + v


def make_texture_binding(trace: cgltrace.CGLTrace, drawcall,
                         states) -> tuple:
    """Resolve the TEX DCR block for a drawcall (main.cpp:286-331),
    reproducing the host's quirks: the filter checks magfilter twice and
    wrap V uses addressU (main.cpp:304-308)."""
    texture = trace.textures[drawcall.texture_id]
    vx_format = C.CGL_TO_VX_FORMAT[texture.format]
    mip_chain, mip_offsets = generate_mipmaps(
        texture.pixels, vx_format, texture.width, texture.height
    )
    tex_filter = (states.texture_magfilter != C.CGL_FILTER_NEAREST)
    wrap_u = (C.TEX_WRAP_REPEAT if states.texture_addressU == C.CGL_ADDRESS_WRAP
              else C.TEX_WRAP_CLAMP)
    wrap_v = wrap_u  # host quirk: V uses addressU too (main.cpp:308)
    tex_state = sampler_mod.TextureState(
        format=vx_format,
        log_width=log2ceil(texture.width),
        log_height=log2ceil(texture.height),
        filter=(C.TEX_FILTER_BILINEAR if tex_filter else C.TEX_FILTER_POINT),
        wrap_u=wrap_u,
        wrap_v=wrap_v,
        mip_offsets=tuple(mip_offsets),
    )
    texels = sampler_mod.make_texel_array(vx_format, mip_chain)
    if (sampler_mod.quad_supported(tex_state)
            and os.environ.get("SKYBOX_QUAD", "1") == "1"):
        # 2x2 quad-table layout: one gather per bilinear sample instead
        # of four (exact; see sampler.quad_supported).  Opt out via
        # SKYBOX_QUAD=0.
        texels = sampler_mod.make_texel_quad_array(tex_state, texels)
        tex_state = dataclasses.replace(tex_state, quad=True)
    return tex_state, jnp.asarray(texels)


def render_trace(trace: cgltrace.CGLTrace, width: int, height: int,
                 tile_logsize: int = C.RASTER_TILE_LOGSIZE,
                 start_draw: int = 0, end_draw: int = 2**31,
                 stats: FrameStats | None = None,
                 mode: str = "immediate",
                 measure_traffic: bool = False) -> np.ndarray:
    """Render a full trace; returns the (H, W) uint32 ARGB framebuffer.

    mode: "immediate" (the ref oracle) or "deferred" (optimized exact path,
    ops.deferred; falls back per drawcall when not equivalence-safe).
    measure_traffic: with stats, run the exact fragment-counting pass per
    draw against the live ds buffer (ops.deferred.measure_drawcall_counts)
    so stats.traffic carries MEASURED tex/OM traffic instead of the
    coverage-area upper bound.

    Blended-draw slot counts are measured on the FIRST render of a
    (trace, size) and cached on the trace object; steady-state frames
    dispatch with the cached static K and verify the overflow counters
    only at frame end, where materializing the framebuffer has already
    paid the device sync — zero per-draw host syncs (VERDICT r3 #7).
    """
    deferred_mode = mode == "deferred"
    if deferred_mode:
        from ..ops import deferred as deferred_mod
        render_dc = deferred_mod.render_drawcall
        cache = getattr(trace, "_blend_k_cache", None)
        if cache is None:
            cache = {}
            trace._blend_k_cache = cache
        ks = cache.setdefault((width, height, tile_logsize), {})
        pending = []
    else:
        render_dc = renderer.render_drawcall
    fbc = np.full((height, width), CLEAR_COLOR, np.uint32)
    fbd = np.full((height, width), CLEAR_DEPTH, np.uint32)
    fbc = renderer.pad_framebuffer(fbc, tile_logsize)
    fbd = renderer.pad_framebuffer(fbd, tile_logsize)
    fbc = jnp.asarray(fbc)
    fbd = jnp.asarray(fbd)

    for d, dc in enumerate(trace.drawcalls):
        if d < start_draw or d > end_draw:
            continue
        binned = binning.bin_drawcall(
            dc.pos, dc.indices, dc.color, dc.texcoord,
            width, height, dc.near, dc.far, tile_logsize,
        )
        if binned is None:
            continue

        flags = state_mod.make_shader_flags(
            dc.states.depth_test, dc.states.color_enabled,
            dc.states.texture_enabled, dc.states.texture_envmode,
        )
        om_state = state_mod.make_om_state(dc.states)

        if dc.states.texture_enabled:
            tex_state, texels = make_texture_binding(trace, dc, dc.states)
        else:
            tex_state, texels = None, None

        render_state = state_mod.RenderState(
            flags=flags, om=om_state, tex=tex_state,
            scissor=(0, 0, width, height),  # main.cpp:220-221
        )
        counts = None
        if stats is not None and measure_traffic:
            from ..ops import deferred as deferred_mod

            counts = deferred_mod.measure_drawcall_counts(
                render_state, binned, fbd)
        if deferred_mode:
            info = {}
            hint = ks.get(d)
            fbc, fbd = render_dc(render_state, texels, binned, fbc, fbd,
                                 info=info, blend_k=hint or None,
                                 overflow_out=pending if hint else None)
            ks[d] = info["blend_k"]
        else:
            fbc, fbd = render_dc(render_state, texels, binned, fbc, fbd)
        if stats is not None:
            from ..runtime import perf as perf_mod

            stats.drawcalls += 1
            stats.prims_binned += binned.num_prims
            stats.tiles += binned.num_tiles
            stats.add_traffic(perf_mod.drawcall_traffic(
                binned, render_state, counts=counts))

    out = np.asarray(fbc)[:height, :width]
    if deferred_mode and pending:
        # frame already materialized above, so these scalar fetches are
        # free; overflow only happens if the trace content changed under
        # a cached K (re-measure once)
        if any(int(mc) > k for k, mc in pending):
            trace._blend_k_cache.pop((width, height, tile_logsize), None)
            return render_trace(trace, width, height, tile_logsize,
                                start_draw, end_draw, None, mode,
                                measure_traffic)
    return out


def render_scene(name: str, width: int, height: int, **kw) -> np.ndarray:
    trace = cgltrace.load_cached(cgltrace.trace_path(name))
    return render_trace(trace, width, height, **kw)


def prepare_drawcalls(trace: cgltrace.CGLTrace, width: int, height: int,
                      tile_logsize: int = C.RASTER_TILE_LOGSIZE):
    """Host-side frame setup: bin every drawcall and resolve its state.
    Returns a list of (RenderState, texels, BinnedDrawcall)."""
    draws = []
    for dc in trace.drawcalls:
        binned = binning.bin_drawcall(
            dc.pos, dc.indices, dc.color, dc.texcoord,
            width, height, dc.near, dc.far, tile_logsize,
        )
        if binned is None:
            continue
        flags = state_mod.make_shader_flags(
            dc.states.depth_test, dc.states.color_enabled,
            dc.states.texture_enabled, dc.states.texture_envmode,
        )
        om_state = state_mod.make_om_state(dc.states)
        if dc.states.texture_enabled:
            tex_state, texels = make_texture_binding(trace, dc, dc.states)
        else:
            tex_state, texels = None, jnp.zeros((1,), jnp.uint32)
        rs = state_mod.RenderState(flags=flags, om=om_state, tex=tex_state,
                                   scissor=(0, 0, width, height))
        draws.append((rs, texels, binned))
    return draws


def compile_frame(trace: cgltrace.CGLTrace, width: int, height: int,
                  tile_logsize: int = C.RASTER_TILE_LOGSIZE,
                  mode: str = "immediate"):
    """Build a single-dispatch whole-frame render function.

    All drawcalls are unrolled inside ONE jit (per-draw states are static),
    so a frame costs one device dispatch — the analog of the
    reference's single vx_start per draw amortized over the full frame.

    mode: "immediate" | "deferred" — the per-draw inner path.
    deferred is exact for every OM state: blended draws use the
    slotted deferred path, whose per-draw static slot count is measured
    here with one eager deferred frame (exact, since the compiled frame
    starts from the same cleared buffers and inputs).
    Returns (frame_fn, arrays): frame_fn(arrays) -> (H, W) uint32 ARGB.
    """
    import jax

    from ..ops import deferred as deferred_mod

    draws = prepare_drawcalls(trace, width, height, tile_logsize)
    statics = tuple((rs, b.tile_logsize) for rs, _, b in draws)
    arrays = tuple(
        (texels, jnp.asarray(b.edges), jnp.asarray(b.attribs),
         jnp.asarray(b.tile_pids), jnp.asarray(b.tile_xy))
        for _, texels, b in draws
    )
    ts = 1 << tile_logsize
    Hp = -(-height // ts) * ts
    Wp = -(-width // ts) * ts

    blend_ks = [0] * len(draws)
    if mode == "deferred":
        fbc = jnp.full((Hp, Wp), CLEAR_COLOR, jnp.uint32)
        fbd = jnp.full((Hp, Wp), CLEAR_DEPTH, jnp.uint32)
        for d, (rs, texels, b) in enumerate(draws):
            info = {}
            fbc, fbd = deferred_mod.render_drawcall(rs, texels, b, fbc, fbd,
                                                    info=info)
            blend_ks[d] = info["blend_k"]

    def one_draw(d, rs, tls, texels, e, a, tp, txy, fbc, fbd):
        if mode == "deferred":
            fbc, fbd, _ = deferred_mod._render_deferred_jit.__wrapped__(
                rs, texels, e, a, a[:, 0], tp, txy, fbc, fbd, tls,
                blend_slots=blend_ks[d])
            return fbc, fbd
        return renderer._render_drawcall_jit.__wrapped__(
            rs, texels, e, a, tp, txy, fbc, fbd, tls)

    @jax.jit
    def frame(arrays):
        fbc = jnp.full((Hp, Wp), CLEAR_COLOR, jnp.uint32)
        fbd = jnp.full((Hp, Wp), CLEAR_DEPTH, jnp.uint32)
        for d, ((rs, tls), (texels, e, a, tp, txy)) in enumerate(
                zip(statics, arrays)):
            fbc, fbd = one_draw(d, rs, tls, texels, e, a, tp, txy, fbc, fbd)
        return fbc[:height, :width]

    return frame, arrays


FRAME_LOOP_SENTINEL = np.uint32(0xDEADBEEF)


def compile_frame_loop(trace: cgltrace.CGLTrace, width: int, height: int,
                       frames: int,
                       tile_logsize: int = C.RASTER_TILE_LOGSIZE,
                       mode: str = "deferred"):
    """N-frame compiled render loop that XLA provably cannot hoist —
    a device-wall measurement protocol.

    A single-dispatch-per-frame timing includes host dispatch; a naive
    compiled N-frame loop is hoisted by XLA to one frame + copies.  Here
    frame n+1 DATA-DEPENDS on frame n: its clear colors and every draw
    input are XORed/added with z = count of pixels in frame n's output
    equal to FRAME_LOOP_SENTINEL — a color the scene provably never
    renders (the caller asserts this on the final framebuffer), so z is
    always 0 and the images are bit-identical, but XLA cannot prove it
    and must execute every frame.  Timing two loop lengths and taking
    the difference quotient cancels the dispatch+sync RTT exactly — the
    reference's in-window elapsed-cycles protocol
    (/root/reference/tests/regression/draw3d/main.cpp:349-378).

    Returns (loop_fn, arrays): loop_fn(arrays) -> final (H, W) u32 frame.
    """
    import jax

    from ..ops import deferred as deferred_mod

    # identical setup to compile_frame (shared protocol)
    draws = prepare_drawcalls(trace, width, height, tile_logsize)
    statics = tuple((rs, b.tile_logsize) for rs, _, b in draws)
    arrays = tuple(
        (texels, jnp.asarray(b.edges), jnp.asarray(b.attribs),
         jnp.asarray(b.tile_pids), jnp.asarray(b.tile_xy))
        for _, texels, b in draws
    )
    ts = 1 << tile_logsize
    Hp = -(-height // ts) * ts
    Wp = -(-width // ts) * ts
    blend_ks = [0] * len(draws)
    if mode == "deferred":
        fbc = jnp.full((Hp, Wp), CLEAR_COLOR, jnp.uint32)
        fbd = jnp.full((Hp, Wp), CLEAR_DEPTH, jnp.uint32)
        for d, (rs, texels, b) in enumerate(draws):
            info = {}
            fbc, fbd = deferred_mod.render_drawcall(rs, texels, b, fbc, fbd,
                                                    info=info)
            blend_ks[d] = info["blend_k"]

    def one_draw(d, rs, tls, texels, e, a, tp, txy, fbc, fbd):
        if mode == "deferred":
            fbc, fbd, _ = deferred_mod._render_deferred_jit.__wrapped__(
                rs, texels, e, a, a[:, 0], tp, txy, fbc, fbd, tls,
                blend_slots=blend_ks[d])
            return fbc, fbd
        return renderer._render_drawcall_jit.__wrapped__(
            rs, texels, e, a, tp, txy, fbc, fbd, tls)

    SEN = jnp.uint32(FRAME_LOOP_SENTINEL)

    @jax.jit
    def loop(arrays):
        def body(_, fb_prev):
            # z == 0 at runtime (sentinel never rendered), unprovable at
            # compile time: the whole frame re-executes every iteration
            z = jnp.sum((fb_prev == SEN).astype(jnp.uint32))
            fbc = jnp.full((Hp, Wp), CLEAR_COLOR, jnp.uint32) ^ z
            fbd = jnp.full((Hp, Wp), CLEAR_DEPTH, jnp.uint32) ^ z
            for d, ((rs, tls), (texels, e, a, tp, txy)) in enumerate(
                    zip(statics, arrays)):
                # thread the dependence through every draw INPUT too, so
                # the (fb-independent) visibility passes can't be
                # loop-invariant-hoisted either
                e = e + z.astype(e.dtype)
                a = a + z.astype(a.dtype)
                tp = tp + z.astype(tp.dtype)
                fbc, fbd = one_draw(d, rs, tls, texels, e, a, tp, txy,
                                    fbc, fbd)
            return fbc
        fb0 = jnp.full((Hp, Wp), CLEAR_COLOR, jnp.uint32)
        fb = jax.lax.fori_loop(0, frames, body, fb0)
        return fb[:height, :width]

    return loop, arrays
