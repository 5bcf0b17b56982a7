"""Output merger: depth/stencil test -> blend -> masked framebuffer update.

Port of OutputMerger (sim/simx/om_unit.cpp:24-154) reformulated for JAX:
instead of per-pixel read-modify-write memory transactions, the merger is a
pure function on framebuffer *tiles* — each tile is owned by exactly one
program instance, so the reference's one-OM-unit-per-word ordering guarantee
holds by construction (race-free sharding, SURVEY §5 race-detection note).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..core import constants as C
from . import blend as blend_mod
from . import depth_stencil as ds_mod

U32 = jnp.uint32


@dataclasses.dataclass(frozen=True)
class OMState:
    """The OM DCR block, resolved (om_unit.cpp:28-49)."""
    ds: ds_mod.DepthStencilState
    blend: blend_mod.BlendState
    depth_writemask: bool
    stencil_front_writemask: int
    stencil_back_writemask: int
    cbuf_writemask4: int     # 4-bit per-byte mask

    @property
    def cbuf_writemask(self) -> int:
        m = self.cbuf_writemask4 & 0xF
        return (((m >> 0) & 1) * 0x000000FF
                | ((m >> 1) & 1) * 0x0000FF00
                | ((m >> 2) & 1) * 0x00FF0000
                | ((m >> 3) & 1) * 0xFF000000)

    @property
    def color_write(self) -> bool:
        return (self.cbuf_writemask4 & 0xF) != 0


def ds_carry_update(state: OMState, depth, cov, dsw):
    """The ds-word half of :func:`write` as a carry update (front face).

    Applies DepthTencil::test + the masked ds write (om_unit.cpp:85-127)
    to a carried depth-stencil word; used by the deferred visibility scan
    (ops.deferred) so it stays bit-identical to the immediate path.
    Returns
    (new dsw, contrib = cov & passed).
    """
    depth_en = state.ds.depth_enabled
    stencil_en = state.ds.stencil_enabled(False)
    if not (depth_en or stencil_en):
        return dsw, cov                      # ds never tested nor written

    passed, ds_result = ds_mod.test(state.ds, False, depth, dsw)

    if depth_en and state.depth_writemask:
        depth_mask = jnp.where(passed, jnp.uint32(C.OM_DEPTH_MASK),
                               jnp.uint32(0))
    else:
        depth_mask = jnp.zeros_like(dsw)
    swm = state.stencil_front_writemask
    stencil_mask = (jnp.uint32((swm & 0xFF) << C.OM_DEPTH_BITS)
                    if stencil_en else jnp.uint32(0))
    ds_writemask = jnp.bitwise_or(depth_mask, stencil_mask)
    new_ds = jnp.bitwise_or(jnp.bitwise_and(dsw, ~ds_writemask),
                            jnp.bitwise_and(ds_result, ds_writemask))
    dsw = jnp.where(cov & (ds_writemask != 0), new_ds, dsw)
    return dsw, cov & passed


def write(state: OMState, covered, color, depth, fb_color, fb_ds,
          is_backface: bool = False):
    """Masked OM update of a framebuffer tile.

    covered: (H, W) bool — pixels this primitive writes
    color:   (H, W) uint32 ARGB source color
    depth:   (H, W) uint32 source depth (low 24 bits used)
    fb_color, fb_ds: (H, W) uint32 destination tiles
    Returns updated (fb_color, fb_ds).
    """
    depth_en = state.ds.depth_enabled
    stencil_en = state.ds.stencil_enabled(is_backface)
    blend_en = state.blend.enabled

    fb_color = jnp.asarray(fb_color, U32)
    fb_ds = jnp.asarray(fb_ds, U32)
    color = jnp.asarray(color, U32)

    if depth_en or stencil_en:
        passed, ds_result = ds_mod.test(state.ds, is_backface, depth, fb_ds)
        ds_passed = passed
    else:
        ds_passed = jnp.ones_like(covered)
        ds_result = fb_ds  # never written (mask 0 below)

    if blend_en:
        blended = blend_mod.blend(state.blend, color, fb_color)
        color = jnp.where(ds_passed, blended, color)

    # depth-stencil write (om_unit.cpp:118-127)
    swm = (state.stencil_back_writemask if is_backface
           else state.stencil_front_writemask)
    if depth_en and state.depth_writemask:
        # per-pixel: depth bits written only where ds_passed
        depth_mask = jnp.where(ds_passed, jnp.uint32(C.OM_DEPTH_MASK),
                               jnp.uint32(0))
    else:
        depth_mask = jnp.zeros_like(fb_ds)
    stencil_mask = jnp.uint32((swm & 0xFF) << C.OM_DEPTH_BITS) if stencil_en \
        else jnp.uint32(0)
    ds_writemask = jnp.bitwise_or(depth_mask, stencil_mask)
    new_ds = jnp.bitwise_or(jnp.bitwise_and(fb_ds, ~ds_writemask),
                            jnp.bitwise_and(ds_result, ds_writemask))
    fb_ds = jnp.where(covered & (ds_writemask != 0), new_ds, fb_ds)

    # color write (om_unit.cpp:129-135)
    if state.color_write:
        cmask = jnp.uint32(state.cbuf_writemask)
        new_color = jnp.bitwise_or(jnp.bitwise_and(fb_color, ~cmask),
                                   jnp.bitwise_and(color, cmask))
        fb_color = jnp.where(covered & ds_passed, new_color, fb_color)

    return fb_color, fb_ds
