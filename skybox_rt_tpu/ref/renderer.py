"""Pure-JAX tile renderer — the behavioral oracle (the role simx plays for
the reference RTL, SURVEY §4.2).

Architecture (array-first reformulation of the reference draw path,
call stack SURVEY §3.3-3.5):

  * binning (host) produces per-tile primitive lists in submission order
  * the framebuffer is viewed as a grid of tiles; each binned tile is
    processed independently (vmap) — the tile-parallel axis that stripes
    across raster units in the reference (raster_unit.cpp:224-227) and
    across devices in skybox_rt_tpu.parallel
  * within a tile, primitives are scanned sequentially (lax.scan), which
    preserves the reference's per-pixel primitive order for blending and
    depth ties; all pixels of the tile advance in lockstep
  * per primitive: edge evaluation + coverage -> barycentric gradients ->
    fixed24 attribute interpolation -> optional texture sample -> output
    merger masked update   (the vx_rast / vx_tex / vx_om pipeline fused
    into one pass, SURVEY §2.7 "pipeline parallelism" note)

Exact-int semantics throughout; gradients use float32 exactly where the
reference shader does (draw3d/kernel.cpp:25-44).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import fixed
from ..core.state import RenderState
from ..geom.binning import BinnedDrawcall
from ..om import merger as om_merger
from ..raster import edge as edge_mod
from ..raster import interp as interp_mod
from ..texture import sampler as sampler_mod

I32 = jnp.int32
U32 = jnp.uint32

FX24_ONE = 1 << 24


def shade_prim_tile(render_state: RenderState, texels, pid, valid,
                    edges, attribs, xs, ys, fb_color, fb_ds):
    """Rasterize + shade + merge one primitive over one tile.

    pid: scalar int32; valid: scalar bool; edges (P,3,3); attribs (P,7,3);
    xs, ys: (TH, TW) int32 global pixel coords; fb_*: (TH, TW) uint32;
    texels: uint32 texel array (dummy when texturing disabled).
    """
    flags = render_state.flags
    p = jnp.maximum(pid, 0)
    e = edges[p]
    at = attribs[p]

    evals = edge_mod.eval_edges(e, xs, ys)                    # (3, TH, TW)
    cov = edge_mod.coverage(evals, xs, ys, render_state.scissor) & valid

    dx, dy = interp_mod.gradients(evals)

    # DEFAULTS (kernel.cpp:16-23): z=0, rgba=1, uv=0 in fixed24
    if flags.depth_enabled:
        z = interp_mod.interpolate(at[0], dx, dy)             # ATTR_Z = 0
    else:
        z = jnp.zeros_like(dx)

    if flags.color_enabled:
        r = interp_mod.interpolate(at[1], dx, dy)
        g = interp_mod.interpolate(at[2], dx, dy)
        b = interp_mod.interpolate(at[3], dx, dy)
        a = interp_mod.interpolate(at[4], dx, dy)
    else:
        r = g = b = a = jnp.full_like(dx, FX24_ONE)

    if flags.tex_enabled:
        u = interp_mod.interpolate(at[5], dx, dy)
        v = interp_mod.interpolate(at[6], dx, dy)
        # fixed24 -> fixed23 (TFixed<TEX_FXD_FRAC>(TFixed<24>): data >> 1)
        tex_color = sampler_mod.sample(
            render_state.tex, texels,
            jnp.right_shift(u, 1), jnp.right_shift(v, 1), lod=0,
        )
        if flags.tex_modulate:
            out_color = interp_mod.modulate(r, g, b, a, tex_color)
        else:
            out_color = tex_color
    else:
        out_color = interp_mod.to_rgba8(r, g, b, a)

    depth = z.astype(U32)  # OUTPUT_i passes the raw fixed24 data as depth
    return om_merger.write(render_state.om, cov, out_color, depth,
                           fb_color, fb_ds)


def render_tiles(render_state: RenderState, texels, binned_arrays,
                 tile_fb_color, tile_fb_ds, tile_origin, tile_size: int):
    """Scan all primitives of each tile (vmapped over tiles).

    binned_arrays: (edges (P,3,3) i32, attribs (P,7,3) i32,
                    tile_pids (T, M) i32)
    tile_fb_*: (T, ts, ts) uint32 gathered framebuffer tiles
    tile_origin: (T, 2) int32 pixel coords of each tile's top-left
    """
    edges, attribs, tile_pids = binned_arrays

    def render_one_tile(pids, fbc, fbd, origin):
        ys_local = jax.lax.broadcasted_iota(I32, (tile_size, tile_size), 0)
        xs_local = jax.lax.broadcasted_iota(I32, (tile_size, tile_size), 1)
        xs = xs_local + origin[0]
        ys = ys_local + origin[1]

        def step(carry, pid):
            fbc, fbd = carry
            fbc, fbd = shade_prim_tile(
                render_state, texels, pid, pid >= 0,
                edges, attribs, xs, ys, fbc, fbd,
            )
            return (fbc, fbd), None

        (fbc, fbd), _ = jax.lax.scan(step, (fbc, fbd), pids)
        return fbc, fbd

    return jax.vmap(render_one_tile)(
        tile_pids, tile_fb_color, tile_fb_ds, tile_origin
    )


@functools.partial(jax.jit, static_argnames=("render_state", "tile_logsize"))
def _render_drawcall_jit(render_state, texels, edges, attribs, tile_pids,
                         tile_xy, fb_color, fb_ds, tile_logsize):
    """Gather fb tiles -> render -> scatter back.  fb shape (Hp, Wp) padded
    to tile multiples."""
    ts = 1 << tile_logsize
    Hp, Wp = fb_color.shape
    gh, gw = Hp // ts, Wp // ts

    # (Hp, Wp) -> (gh, gw, ts, ts)
    fbc_t = fb_color.reshape(gh, ts, gw, ts).transpose(0, 2, 1, 3)
    fbd_t = fb_ds.reshape(gh, ts, gw, ts).transpose(0, 2, 1, 3)

    tx = tile_xy[:, 0]
    ty = tile_xy[:, 1]
    sel_c = fbc_t[ty, tx]          # (T, ts, ts)
    sel_d = fbd_t[ty, tx]
    origin = jnp.stack([tx * ts, ty * ts], axis=-1)

    out_c, out_d = render_tiles(
        render_state, texels, (edges, attribs, tile_pids),
        sel_c, sel_d, origin, ts,
    )

    fbc_t = fbc_t.at[ty, tx].set(out_c)
    fbd_t = fbd_t.at[ty, tx].set(out_d)
    fb_color = fbc_t.transpose(0, 2, 1, 3).reshape(Hp, Wp)
    fb_ds = fbd_t.transpose(0, 2, 1, 3).reshape(Hp, Wp)
    return fb_color, fb_ds


def render_drawcall(render_state: RenderState, texels,
                    binned: BinnedDrawcall, fb_color, fb_ds):
    """Render one binned drawcall into the (padded) framebuffer arrays.

    texels: uint32 texel array for the bound texture stage (any 1-element
    dummy when texturing is disabled)."""
    if texels is None:
        texels = jnp.zeros((1,), jnp.uint32)
    return _render_drawcall_jit(
        render_state, texels,
        jnp.asarray(binned.edges), jnp.asarray(binned.attribs),
        jnp.asarray(binned.tile_pids), jnp.asarray(binned.tile_xy),
        fb_color, fb_ds, binned.tile_logsize,
    )


def pad_framebuffer(fb: np.ndarray, tile_logsize: int):
    """Pad an (H, W) buffer up to tile-size multiples."""
    ts = 1 << tile_logsize
    H, W = fb.shape
    Hp = -(-H // ts) * ts
    Wp = -(-W // ts) * ts
    if (Hp, Wp) == (H, W):
        return fb
    out = np.zeros((Hp, Wp), fb.dtype)
    out[:H, :W] = fb
    return out
