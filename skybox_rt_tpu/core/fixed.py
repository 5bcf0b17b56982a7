"""Exact int32 fixed-point arithmetic, vectorized for JAX.

The reference rasterizer is built entirely on cocogfx ``TFixed<16>`` (edge
coefficients, ``FloatE``) and ``TFixed<24>`` (attributes / barycentrics,
``FloatA``) stored in int32 (graphics.h:24-33).  Its hot interpolation path
uses a 48-bit product ``imadd(a,b,c,3) = ((int64)a*b >> 24) + c``
(draw3d/kernel.cpp:48-54).  JAX runs with 64-bit types disabled, so we
emulate the wide product with 16-bit limbs — bit-exact, pure int32/uint32
ops.

All helpers operate on raw int32 "data" values (the fixed-point bit
patterns), never on wrapper objects: arrays-of-structs become
structs-of-arrays.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
U32 = jnp.uint32

EDGE_FRAC = 16  # FloatE = TFixed<16>
ATTR_FRAC = 24  # FloatA = TFixed<24>


def to_fixed_np(x, frac: int, dtype=np.int32):
    """float -> fixed-point data, C-cast semantics (truncation toward zero).

    Matches cocogfx ``TFixed<F>(float)``: ``static_cast<int32>(x * (1<<F))``.
    Host-side (numpy) variant used by binning.
    """
    scaled = np.asarray(x, np.float32) * np.float32(1 << frac)
    # C float->int cast truncates toward zero; np.trunc then cast does too.
    # Overflow in the C cast is UB; in practice x86 saturates to INT_MIN —
    # inputs here are normalized so |x| < 2^(31-F).
    return np.trunc(scaled).astype(np.int64).astype(dtype)


def to_fixed(x, frac: int):
    """float32 -> fixed data (int32), truncation toward zero (jnp variant)."""
    scaled = jnp.asarray(x, jnp.float32) * jnp.float32(1 << frac)
    return jnp.trunc(scaled).astype(I32)


def to_fixed_x86(x, frac: int):
    """float32 -> fixed data with x86 ``cvttss2si`` cast semantics.

    Truncate toward zero; NaN or out-of-int32-range results become
    0x80000000 (what the reference produces on x86 for the degenerate
    all-zero-barycentric case).
    """
    scaled = jnp.asarray(x, jnp.float32) * jnp.float32(1 << frac)
    tr = jnp.trunc(scaled)
    bad = jnp.isnan(tr) | (tr >= jnp.float32(2.0**31)) | (tr < jnp.float32(-(2.0**31)))
    safe = jnp.where(bad, jnp.float32(0), tr)
    return jnp.where(bad, jnp.int32(-(2**31)), safe.astype(I32))


def fixed_to_float(data, frac: int):
    """fixed data -> float32: ``static_cast<float>(TFixed<F>)`` = data / 2^F.

    The int32->float32 conversion rounds to nearest even for |data| >= 2^24,
    exactly as the C cast does; the 2^-F scale is an exact power of two.
    """
    return jnp.asarray(data, I32).astype(jnp.float32) * jnp.float32(2.0 ** -frac)


def _umul32_parts(a_u32, b_u32):
    """Unsigned 32x32 -> (hi, lo) uint32 pair, exact."""
    ah = jnp.right_shift(a_u32, 16)
    al = jnp.bitwise_and(a_u32, jnp.uint32(0xFFFF))
    bh = jnp.right_shift(b_u32, 16)
    bl = jnp.bitwise_and(b_u32, jnp.uint32(0xFFFF))
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    # P = hh<<32 + (lh+hl)<<16 + ll
    mid = lh + jnp.right_shift(ll, 16)        # <= (2^16-1)^2/2^16 + ... < 2^32
    mid2 = mid + jnp.bitwise_and(hl, jnp.uint32(0xFFFF))
    hi = hh + jnp.right_shift(hl, 16) + jnp.right_shift(mid2, 16)
    lo = jnp.bitwise_or(
        jnp.left_shift(jnp.bitwise_and(mid2, jnp.uint32(0xFFFF)), 16),
        jnp.bitwise_and(ll, jnp.uint32(0xFFFF)),
    )
    return hi, lo


def smul32_parts(a, b):
    """Signed 32x32 -> 64-bit product as (hi int32-pattern, lo) uint32 pair.

    hi:lo is the two's-complement 64-bit product.
    """
    a = jnp.asarray(a, I32)
    b = jnp.asarray(b, I32)
    au = a.astype(U32)
    bu = b.astype(U32)
    hi, lo = _umul32_parts(au, bu)
    # signed correction: hi_s = hi_u - (a<0 ? b : 0) - (b<0 ? a : 0)
    hi = hi - jnp.where(a < 0, bu, jnp.uint32(0)) - jnp.where(b < 0, au, jnp.uint32(0))
    return hi, lo


def mul_shift(a, b, shift: int):
    """Bit-exact int32 result of ``(int64)a * (int64)b >> shift`` (0<shift<32).

    Arithmetic shift of the 64-bit two's-complement product, truncated to the
    low 32 bits — exactly what the reference's ``imadd`` computes before the
    result is stored into an int32 (draw3d/kernel.cpp:48-51).
    """
    assert 0 < shift < 32
    hi, lo = smul32_parts(a, b)
    out = jnp.bitwise_or(
        jnp.right_shift(lo, jnp.uint32(shift)),
        jnp.left_shift(hi, jnp.uint32(32 - shift)),
    )
    return out.astype(I32)


def imadd24(a, b, c):
    """``((int64)a * b >> 24) + c`` in int32 — the attribute interpolator.

    Reference: draw3d/kernel.cpp:48-59 (``imadd``/``multadd_fx`` with s=3).
    """
    return mul_shift(a, b, 24) + jnp.asarray(c, I32)


def interpolate24(attr_x, attr_y, attr_z, dx, dy):
    """Fixed24 barycentric interpolation: ``(x*dx>>24 + z) + (y*dy>>24)``.

    attr_* are the per-primitive deltas (a0-a2, a1-a2, a2) in fixed24; dx/dy
    the fixed24 barycentric ratios.  Reference: INTERPOLATE_i,
    draw3d/kernel.cpp:56-59.
    """
    tmp = imadd24(attr_x, dx, attr_z)
    return imadd24(attr_y, dy, tmp)
