"""Per-draw render state — the JAX equivalent of the reference's DCR block.

The reference configures its fixed-function units through 32-bit device
configuration registers (vx_dcr_write -> per-unit DCRS tables,
sim/simx/dcrs.cpp:26-60; register map hw/rtl/VX_types.vh:332-460).  Here the
same state is a frozen dataclass tree: hashable, so it participates in
jax.jit static arguments and every unique state compiles a specialized
pipeline (the reference analog: DCRs are uniform for a whole draw).
"""
from __future__ import annotations

import dataclasses

from . import constants as C
from ..om.blend import BlendState
from ..om.depth_stencil import DepthStencilState
from ..om.merger import OMState
from ..texture.sampler import TextureState


@dataclasses.dataclass(frozen=True)
class ShaderFlags:
    """kernel_arg_t shader toggles (draw3d/common.h:18-34) after the host's
    inference rules (draw3d/main.cpp:336-344)."""
    depth_enabled: bool
    color_enabled: bool
    tex_enabled: bool
    tex_modulate: bool


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Everything uniform for one drawcall."""
    flags: ShaderFlags
    om: OMState
    tex: TextureState | None
    scissor: tuple  # (left, top, right, bottom)


def make_shader_flags(depth_test, color_enabled, texture_enabled,
                      envmode) -> ShaderFlags:
    """draw3d/main.cpp:336-344 including its mutual-exclusion rules."""
    tex_modulate = bool(texture_enabled) and envmode == C.CGL_ENVMODE_MODULATE
    color_en = bool(color_enabled)
    if tex_modulate and not color_en:
        tex_modulate = False
    if texture_enabled and color_en and not tex_modulate:
        color_en = False
    return ShaderFlags(
        depth_enabled=bool(depth_test),
        color_enabled=color_en,
        tex_enabled=bool(texture_enabled),
        tex_modulate=tex_modulate,
    )


def make_om_state(states, width=None, height=None) -> OMState:
    """Resolve the OM DCR block exactly as the draw3d host programs it
    (draw3d/main.cpp:224-284), including its quirks:

      * stencil ZFAIL register is never written (the host writes the zfail
        value into ZPASS a second time, main.cpp:251-252) -> effective
        zpass = trace zfail, zfail = KEEP(0)
      * when a state group is disabled the host writes the documented
        defaults rather than skipping the writes
    """
    if states.depth_test:
        depth_func = C.CGL_TO_VX_COMPARE[states.depth_func]
        depth_writemask = bool(states.depth_writemask & 1)
    else:
        depth_func = C.OM_DEPTH_FUNC_ALWAYS
        depth_writemask = False

    if states.stencil_test:
        s_func = C.CGL_TO_VX_COMPARE[states.stencil_func]
        s_zpass = C.CGL_TO_VX_STENCIL_OP[states.stencil_zfail]  # host quirk
        s_zfail = C.OM_STENCIL_OP_KEEP                          # never written
        s_fail = C.CGL_TO_VX_STENCIL_OP[states.stencil_fail]
        s_ref = states.stencil_ref
        s_mask = states.stencil_mask
        s_writemask = states.stencil_writemask
    else:
        s_func = C.OM_DEPTH_FUNC_ALWAYS
        s_zpass = C.OM_STENCIL_OP_KEEP
        s_zfail = C.OM_STENCIL_OP_KEEP
        s_fail = C.OM_STENCIL_OP_KEEP
        s_ref = 0
        s_mask = C.OM_STENCIL_MASK
        s_writemask = 0

    ds = DepthStencilState(
        depth_func=depth_func,
        depth_writemask=depth_writemask,
        stencil_front_func=s_func & 0xFFFF,
        stencil_front_zpass=s_zpass & 0xFFFF,
        stencil_front_zfail=s_zfail & 0xFFFF,
        stencil_front_fail=s_fail & 0xFFFF,
        stencil_front_ref=s_ref & 0xFFFF,
        stencil_front_mask=s_mask & 0xFFFF,
        stencil_back_func=(s_func >> 16) & 0xFFFF,
        stencil_back_zpass=(s_zpass >> 16) & 0xFFFF,
        stencil_back_zfail=(s_zfail >> 16) & 0xFFFF,
        stencil_back_fail=(s_fail >> 16) & 0xFFFF,
        stencil_back_ref=(s_ref >> 16) & 0xFFFF,
        stencil_back_mask=(s_mask >> 16) & 0xFFFF,
    )

    if states.blend_enabled:
        bsrc = C.CGL_TO_VX_BLEND_FUNC[states.blend_src]
        bdst = C.CGL_TO_VX_BLEND_FUNC[states.blend_dst]
    else:
        bsrc = C.OM_BLEND_FUNC_ONE
        bdst = C.OM_BLEND_FUNC_ZERO
    blend = BlendState(
        mode_rgb=C.OM_BLEND_MODE_ADD,
        mode_a=C.OM_BLEND_MODE_ADD,
        src_rgb=bsrc, src_a=bsrc,
        dst_rgb=bdst, dst_a=bdst,
        const_color=0,
        logic_op=0,
    )

    return OMState(
        ds=ds,
        blend=blend,
        depth_writemask=depth_writemask,
        stencil_front_writemask=s_writemask & 0xFFFF,
        stencil_back_writemask=(s_writemask >> 16) & 0xFFFF,
        cbuf_writemask4=states.color_writemask & 0xF,
    )
