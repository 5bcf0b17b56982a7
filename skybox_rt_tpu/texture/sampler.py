"""Texture sampling: wrap modes, addressing, formats, point/bilinear filter.

Exact vectorized port of the reference sampler (sim/common/graphics.cpp:36-314)
operating on fixed-point u/v with TEX_FXD_FRAC = 23 fraction bits.  The
texture memory model is a flat mip-chain buffer per stage (viewed at the
texel stride), the JAX equivalent of the reference's tcache reads — texel
fetches become XLA gathers over a device-resident array.

Differentiability note: the exact-int path is for golden parity; the
differentiable float path lives in skybox_rt_tpu.diff.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..core import constants as C

I32 = jnp.int32
U32 = jnp.uint32

FRAC = C.TEX_FXD_FRAC            # 23
ONE = 1 << FRAC
MASK = ONE - 1
HALF = ONE >> 1


@dataclasses.dataclass(frozen=True)
class TextureState:
    """Static per-stage sampler configuration (the TEX DCR block,
    VX_types.vh:332-343)."""
    format: int            # VX_TEX_FORMAT_*
    log_width: int
    log_height: int
    filter: int            # VX_TEX_FILTER_*
    wrap_u: int            # VX_TEX_WRAP_*
    wrap_v: int
    mip_offsets: tuple     # byte offsets per lod into the mip-chain buffer
    quad: bool = False     # texel array is the (N, 4) 2x2 quad table


def texture_wrap(data, wrap: int):
    """TextureWrap (graphics.cpp:36-53) on raw fixed23 int32 data."""
    data = jnp.asarray(data, I32)
    if wrap == C.TEX_WRAP_CLAMP:
        ret = jnp.where(data >= 0, data, 0)
        ret = jnp.where(ret > MASK, MASK, ret)
    elif wrap == C.TEX_WRAP_REPEAT:
        ret = data
    elif wrap == C.TEX_WRAP_MIRROR:
        # sign of (data << (31-F)) selects mirroring of the fraction
        m = jnp.right_shift(jnp.left_shift(data, 31 - FRAC), 31)
        ret = jnp.bitwise_xor(data, m)
    else:
        raise ValueError(f"bad wrap {wrap}")
    return jnp.bitwise_and(ret, MASK)


def unpack8888(fmt: int, texel):
    """Format decode to the (lo, hi) 16.16 channel pair layout
    lo = (r<<16)|b, hi = (a<<16)|g used by Lerp8888 (graphics.cpp:72-122)."""
    t = jnp.asarray(texel, U32)
    if fmt == C.TEX_FORMAT_A8R8G8B8:
        r = (t >> 16) & 0xFF
        g = (t >> 8) & 0xFF
        b = t & 0xFF
        a = t >> 24
    elif fmt == C.TEX_FORMAT_R5G6B5:
        r = ((t >> 8) & 0xF8) | ((t >> 13) & 0x07)
        g = ((t >> 3) & 0xFC) | ((t >> 9) & 0x03)
        b = ((t << 3) & 0xF8) | ((t >> 2) & 0x07)
        a = jnp.full_like(t, 0xFF)
    elif fmt == C.TEX_FORMAT_A1R5G5B5:
        r = ((t >> 7) & 0xF8) | ((t >> 12) & 0x07)
        g = ((t >> 2) & 0xF8) | ((t >> 7) & 0x07)
        b = ((t << 3) & 0xF8) | ((t >> 2) & 0x07)
        a = jnp.bitwise_and(
            jnp.right_shift(jnp.left_shift(t.astype(I32), 16), 31).astype(U32),
            0xFF,
        )
    elif fmt == C.TEX_FORMAT_A4R4G4B4:
        r = ((t >> 4) & 0xF0) | ((t >> 8) & 0x0F)
        g = (t & 0xF0) | ((t >> 4) & 0x0F)
        b = ((t << 4) & 0xF0) | (t & 0x0F)
        a = ((t >> 8) & 0xF0) | ((t >> 12) & 0x0F)
    elif fmt == C.TEX_FORMAT_A8L8:
        r = t & 0xFF
        g = r
        b = r
        a = (t >> 8) & 0xFF
    elif fmt == C.TEX_FORMAT_L8:
        r = t & 0xFF
        g = r
        b = r
        a = jnp.full_like(t, 0xFF)
    elif fmt == C.TEX_FORMAT_A8:
        r = jnp.full_like(t, 0xFF)
        g = r
        b = r
        a = t & 0xFF
    else:
        raise ValueError(f"bad format {fmt}")
    lo = (r << 16) + b
    hi = (a << 16) + g
    return lo, hi


def lerp8888(a, b, f):
    """Dual-channel lerp with the +0x00800080 rounding bias
    (graphics.h:82-86)."""
    a = jnp.asarray(a, U32)
    b = jnp.asarray(b, U32)
    f = jnp.asarray(f, U32)
    p = a * (0xFF - f) + b * f + 0x00800080
    q = (p >> 8) & 0x00FF00FF
    return ((p + q) >> 8) & 0x00FF00FF


def pack8888(lo, hi):
    return (hi << 8) | lo


def make_texel_array(fmt: int, mip_chain: np.ndarray) -> np.ndarray:
    """View a flat uint8 mip-chain byte buffer at the texel stride.

    Returns a uint32 array of texels (the device-memory analog; texel
    fetches become XLA gathers into it).  Mip offsets (bytes) divide the
    stride because every level is width*height*stride bytes.
    """
    stride = C.TEX_FORMAT_STRIDE[fmt]
    buf = np.asarray(mip_chain, np.uint8)
    if stride == 1:
        return buf.astype(np.uint32)
    if stride == 2:
        return buf.view("<u2").astype(np.uint32)
    return buf.view("<u4").copy()


def quad_supported(st: TextureState) -> bool:
    """True when the 2x2 quad-table fast path is exact for this state.

    Bilinear fetches the 4 texels at independently-wrapped (u±d, v±d);
    for REPEAT the +d neighbor index is always (x0+1) mod W, and for
    CLAMP it is min(x0+1, W-1) except in zero-weight corner cases (alpha
    or beta == 0, where the divergent texel contributes nothing to
    lerp8888) — so a precomputed per-texel 2x2 neighborhood row replaces
    the 4 gathers with ONE.  MIRROR reflects the sub-texel fraction at
    segment ends (graphics.cpp:44-49), where the +1-index rule breaks
    with nonzero weight, so mirror states keep the flat 4-gather path.
    """
    return (st.filter == C.TEX_FILTER_BILINEAR
            and st.wrap_u in (C.TEX_WRAP_CLAMP, C.TEX_WRAP_REPEAT)
            and st.wrap_v in (C.TEX_WRAP_CLAMP, C.TEX_WRAP_REPEAT))


def make_texel_quad_array(st: TextureState, texels: np.ndarray) -> np.ndarray:
    """(N,) uint32 flat mip chain -> (N, 4) uint32 quad table whose row i
    holds [t00, t01, t10, t11] = the 2x2 bilinear footprint anchored at
    texel i of its mip level (see quad_supported).  4x the HBM bytes for
    1/4 the gather rows (gathers are row-bound, HBM bytes are cheap next
    to them)."""
    stride = C.TEX_FORMAT_STRIDE[st.format]
    flat = np.asarray(texels, np.uint32)
    out = np.zeros((flat.shape[0], 4), np.uint32)

    def nbr(idx, n, wrap):
        if wrap == C.TEX_WRAP_REPEAT:
            return (idx + 1) % n
        return np.minimum(idx + 1, n - 1)

    for lod, off in enumerate(st.mip_offsets):
        base = off // stride
        w = 1 << max(st.log_width - lod, 0)
        h = 1 << max(st.log_height - lod, 0)
        if base + w * h > flat.shape[0]:
            break
        level = flat[base:base + w * h].reshape(h, w)
        x = np.arange(w)
        y = np.arange(h)
        x1 = nbr(x, w, st.wrap_u)
        y1 = nbr(y, h, st.wrap_v)
        out[base:base + w * h, 0] = level.ravel()
        out[base:base + w * h, 1] = level[:, x1].ravel()
        out[base:base + w * h, 2] = level[y1, :].ravel()
        out[base:base + w * h, 3] = level[np.ix_(y1, x1)].ravel()
        if w == 1 and h == 1:
            break
    return out


def _fetch(st: TextureState, texels, offset, lod: int):
    """Gather texels at per-lod texel offsets (any shape)."""
    stride = C.TEX_FORMAT_STRIDE[st.format]
    base = st.mip_offsets[lod] // stride
    return jnp.take(jnp.asarray(texels, jnp.uint32),
                    base + jnp.asarray(offset, I32), axis=0, mode="clip")


def sample(st: TextureState, texels, u, v, lod: int = 0):
    """TextureSampler::read (graphics.cpp:253-313); u, v raw fixed23 int32.

    st is static configuration; texels the traced uint32 texel array.
    lod is static (the draw3d shader always samples lod 0,
    draw3d/kernel.cpp:152-156).
    """
    log_w = max(st.log_width - lod, 0)
    log_h = max(st.log_height - lod, 0)

    if st.filter == C.TEX_FILTER_BILINEAR:
        delta_x = HALF >> log_w
        delta_y = HALF >> log_h
        u0 = texture_wrap(jnp.asarray(u, I32) - delta_x, st.wrap_u)
        u1 = texture_wrap(jnp.asarray(u, I32) + delta_x, st.wrap_u)
        v0 = texture_wrap(jnp.asarray(v, I32) - delta_y, st.wrap_v)
        v1 = texture_wrap(jnp.asarray(v, I32) + delta_y, st.wrap_v)

        shift_u = FRAC - log_w
        shift_v = FRAC - log_h
        x0s = jnp.right_shift(jnp.left_shift(u0, 8), shift_u)
        y0s = jnp.right_shift(jnp.left_shift(v0, 8), shift_v)
        x0 = jnp.right_shift(x0s, 8)
        y0 = jnp.right_shift(y0s, 8)

        if st.quad:
            # ONE gather of the precomputed 2x2 footprint row
            # (quad_supported proves exactness for these wrap modes)
            q = _fetch(st, texels, x0 + jnp.left_shift(y0, log_w), lod)
            t00 = q[..., 0]
            t01 = q[..., 1]
            t10 = q[..., 2]
            t11 = q[..., 3]
        else:
            x1 = jnp.right_shift(u1, shift_u)
            y1 = jnp.right_shift(v1, shift_v)
            t00 = _fetch(st, texels, x0 + jnp.left_shift(y0, log_w), lod)
            t01 = _fetch(st, texels, x1 + jnp.left_shift(y0, log_w), lod)
            t10 = _fetch(st, texels, x0 + jnp.left_shift(y1, log_w), lod)
            t11 = _fetch(st, texels, x1 + jnp.left_shift(y1, log_w), lod)

        alpha = jnp.bitwise_and(x0s, 0xFF).astype(U32)
        beta = jnp.bitwise_and(y0s, 0xFF).astype(U32)

        l00, h00 = unpack8888(st.format, t00)
        l01, h01 = unpack8888(st.format, t01)
        l10, h10 = unpack8888(st.format, t10)
        l11, h11 = unpack8888(st.format, t11)
        c01l = lerp8888(l00, l01, alpha)
        c01h = lerp8888(h00, h01, alpha)
        c23l = lerp8888(l10, l11, alpha)
        c23h = lerp8888(h10, h11, alpha)
        cl = lerp8888(c01l, c23l, beta)
        ch = lerp8888(c01h, c23h, beta)
        return pack8888(cl, ch)

    elif st.filter == C.TEX_FILTER_POINT:
        uu = texture_wrap(u, st.wrap_u)
        vv = texture_wrap(v, st.wrap_v)
        x = jnp.right_shift(uu, FRAC - log_w)
        y = jnp.right_shift(vv, FRAC - log_h)
        t = _fetch(st, texels, x + jnp.left_shift(y, log_w), lod)
        if st.quad:
            t = t[..., 0]
        lo, hi = unpack8888(st.format, t)
        return pack8888(lo, hi)
    else:
        raise ValueError(f"bad filter {st.filter}")
