"""Ray-traced rendering of CGLTrace (draw3d) scenes.

The reference's raster pipeline and this framework's RT path meet here.
Two camera models are provided (`camera=` of render_trace_rt):

  * "screen" — every drawcall's clip-space geometry is mapped to screen
    space (geom/transform.clip_to_screen, the same viewport mapping
    binning uses) and rendered with orthographic per-pixel rays marching
    along depth; screen-space barycentrics reweighted by 1/w give
    perspective-correct attribute interpolation (the float analog of the
    draw3d kernel's edge-value interpolation,
    tests/regression/draw3d/kernel.cpp:16-229).
  * "perspective" — a REAL perspective eye: rays diverge from the origin
    of the space (x_clip, y_clip, w_clip), which is the application's
    view space up to an anisotropic linear scale (for any projection
    matrix with w_clip linear in view z).  A point projects to the pixel
    whose NDC is (x_c/w_c, y_c/w_c) — exactly the rasterizer's viewport
    mapping — so coverage matches the raster per pixel; and because the
    space is a LINEAR image of view space, plain 3D barycentrics on the
    hit triangle interpolate attributes perspective-correctly (no 1/w
    reweighting).  Depth for the z-buffer is z_ndc = z_clip/w_clip at the
    hit, viewport-mapped — identical to the raster's interpolated z.

This is deliberately a float renderer: it cross-validates the bit-exact
fixed-point raster path scene-by-scene (tests/test_raster_bridge.py
asserts per-pixel agreement within tolerance on the reference scenes) and
demonstrates that the RT engines handle arbitrary production geometry,
not just procedural meshes.

Depth-winner selection per drawcall:
  LESS/LEQUAL   -> closest hit (screen: on z; perspective: smallest w —
                   same winner whenever z_ndc is monotonic in view depth,
                   true of standard projection matrices)
  GREATER/GEQUAL-> farthest hit (screen: closest on -z; perspective: the
                   ray starts beyond the scene and marches back)
  ALWAYS/others -> last-submitted primitive wins (orthographic hit on
                   -prim_index), matching the raster's submission-order
                   semantics when the depth test can't order fragments;
                   the perspective camera falls back to the screen-space
                   machinery for these drawcalls (same coverage — both
                   cameras realize the identical viewport projection).

Exactness: drawcalls whose winner is NOT an ordering extreme —
depth func ALWAYS/EQUAL/NOTEQUAL/NEVER, depth test off, or blending
enabled (every passing fragment contributes) — run the SUBMISSION-ORDER
FRAGMENT SCAN `_scan_drawcall`: perspective rays are intersected against
each primitive in submission order with the evolving per-ray z/color
carry, i.e. the RT analog of the deferred blend slots with K = all
fragments (om_unit.cpp:24-154 semantics in float).  The perspective
camera therefore never falls back to the screen-space machinery, and
intra-draw multi-layer blending is exact (mod float rounding).

Stencil state is NOT modeled: drawcalls with stencil_test enabled raise
by default (`on_stencil="raise"`; no CGLTrace scene uses stencil) or are
skipped with a warning (`on_stencil="skip"`).
"""
from __future__ import annotations

import functools
import warnings

import numpy as np

import jax
import jax.numpy as jnp

from ..core import constants as C
from ..geom import cgltrace, transform
from ..texture import mipmap
from . import bvh as bvh_mod
from . import intersect

F32 = jnp.float32
#: barycentric interpolation stays in full float32 (no TF32 products)
_HIGHEST = jax.lax.Precision.HIGHEST


def _screen_triangles(dc, width: int, height: int):
    """Drawcall -> screen-space triangle soup + per-vertex attributes.

    Returns None when no primitive survives (behind the eye / degenerate).
    """
    pos = np.asarray(dc.pos, np.float32)
    keep_v = pos[:, 3] > 1e-20
    screen = np.zeros((pos.shape[0], 4), np.float32)
    safe = np.where(keep_v[:, None], pos, np.float32(1.0))
    screen[keep_v] = transform.clip_to_screen(
        safe, 0, width, 0, height, dc.near, dc.far)[keep_v]

    idx = np.asarray(dc.indices, np.int64)
    tri_ok = keep_v[idx].all(1)
    # degenerate screen-area reject (matches binning's det==0 reject)
    p = screen[idx]                      # (P, 3, 4)
    area = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
            - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    tri_ok &= np.abs(area) > 1e-12
    if not tri_ok.any():
        return None
    idx = idx[tri_ok]
    return {
        "xy_z": screen[:, :3],           # (V, 3) sx, sy, sz
        "rhw": screen[:, 3],             # (V,) 1/w
        "clip": pos,                     # (V, 4) clip-space positions
        "indices": idx.astype(np.int32),
        "color": np.asarray(dc.color, np.float32),
        "uv": np.asarray(dc.texcoord, np.float32),
    }


def _depth_key(geo, states):
    """Per-vertex 'depth' used for winner selection (see module doc)."""
    z = geo["xy_z"][:, 2]
    if not states.depth_test:
        return None                      # submission order decides
    f = states.depth_func
    if f in (C.CGL_COMPARE_LESS, C.CGL_COMPARE_LEQUAL):
        return z
    if f in (C.CGL_COMPARE_GREATER, C.CGL_COMPARE_GEQUAL):
        return -z
    return None


def _winner_tris(geo, key):
    """3D triangles whose ray-march order reproduces the depth winner.

    x, y are screen coords; the third coordinate is the selection key
    (depth, or -prim_index for submission order)."""
    idx = geo["indices"]
    if key is None:
        k = -np.arange(idx.shape[0], dtype=np.float32)
        kv = np.broadcast_to(k[:, None], idx.shape)
    else:
        kv = key[idx]
    v = geo["xy_z"][idx][:, :, :2]       # (P, 3, 2)
    tri = np.concatenate([v, kv[..., None]], -1)   # (P, 3, 3)
    return np.ascontiguousarray(tri.astype(np.float32))


_ENGINE_PREP_CACHE: dict = {}


def _engine_prep(tri, engine: str):
    """Host acceleration-structure build for one triangle soup, cached by
    content hash: repeated renders of the same trace (animation/bench
    loops) skip the per-draw SAH rebuild."""
    import hashlib

    key = (engine, tri.shape[0],
           hashlib.sha1(np.ascontiguousarray(tri).tobytes()).hexdigest())
    hit = _ENGINE_PREP_CACHE.get(key)
    if hit is not None:
        return hit
    v0 = jnp.asarray(tri[:, 0])
    e1 = jnp.asarray(tri[:, 1] - tri[:, 0])
    e2 = jnp.asarray(tri[:, 2] - tri[:, 0])
    prep = {"v0": v0, "e1": e1, "e2": e2}
    if engine != "brute":
        verts = tri.reshape(-1, 3)
        faces = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
        bvh = bvh_mod.build_sah(verts, faces)
        prep["stackless"] = bvh.as_stackless_arrays()
        prep["leaf_size"] = bvh.leaf_size
    if engine == "kernel":
        from ..ops import traverse
        prep["scene"] = traverse.prepare_scene(
            prep["stackless"], (v0, e1, e2), bvh.leaf_size)
    while len(_ENGINE_PREP_CACHE) >= 256:  # bound: evict oldest (FIFO),
        _ENGINE_PREP_CACHE.pop(            # not clear() — a >256-draw
            next(iter(_ENGINE_PREP_CACHE)))  # loop must not thrash
    _ENGINE_PREP_CACHE[key] = prep
    return prep


def _run_engine(tri, o, d, engine: str):
    """Closest hit of rays (o, d) against `tri` (P, 3, 3) float32."""
    if engine == "auto":
        from ..runtime import device
        engine = device.rt_engine()
    prep = _engine_prep(tri, engine)
    v0, e1, e2 = prep["v0"], prep["e1"], prep["e2"]
    if engine == "brute":
        prim, t, u, v = intersect.closest_hit_bruteforce(
            o, d, v0, e1, e2, t_min=1e-6)
    elif engine == "kernel":
        from ..ops import traverse
        prim, t, u, v = traverse.traverse(prep["scene"], o, d, t_min=1e-6)
    else:
        prim, t, u, v = bvh_mod.closest_hit_stackless(
            prep["stackless"], (v0, e1, e2), o, d,
            t_min=1e-6, leaf_size=prep["leaf_size"])
    return prim, u, v


def _closest_hit(tri, px, py, engine: str):
    """Orthographic rays through the pixel grid against `tri` (P, 3, 3).

    Rays start below every selection key and march along +key, so the
    first hit is the winner.  Returns (prim (R,), u, v)."""
    kmin = float(tri[..., 2].min()) - 1.0
    o = jnp.stack([px, py, jnp.full_like(px, kmin)], -1)
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], F32), o.shape)
    return _run_engine(tri, o, d, engine)


def _persp_hit(geo, nx, ny, farthest: bool, engine: str):
    """Perspective rays from the eye (origin of (x_c, y_c, w_c) space)
    through the pixel grid's NDC.  `farthest` starts the rays beyond the
    scene marching back toward the eye (GREATER/GEQUAL winner).
    Returns (prim (R,), u, v) with 3D barycentrics."""
    clip = geo["clip"]
    tri = clip[geo["indices"]][:, :, [0, 1, 3]]    # (P, 3, 3) x_c, y_c, w_c
    tri = np.ascontiguousarray(tri.astype(np.float32))
    dirs = jnp.stack([nx, ny, jnp.ones_like(nx)], -1)
    if farthest:
        D = float(tri[..., 2].max()) + 1.0
        o = dirs * D
        d = -dirs
    else:
        o = jnp.zeros_like(dirs)
        d = dirs
    return _run_engine(tri, o, d, engine)


def _interp_bary(attr, idx, prim, u, v):
    """Plain 3D-barycentric interpolation (perspective camera: the hit
    space is a linear image of view space, so this IS perspective-correct
    — no 1/w reweighting)."""
    p = jnp.maximum(prim, 0)
    tri_idx = idx[p]                      # (R, 3)
    w = jnp.stack([1.0 - u - v, u, v], -1)
    return jnp.sum(attr[tri_idx] * w[..., None], 1)


def _interp_pc(attr, idx, rhw, prim, u, v):
    """Perspective-correct interpolation: bary * rhw weights, renormalized
    (float analog of the draw3d kernel's edge-value interpolation)."""
    p = jnp.maximum(prim, 0)
    tri_idx = idx[p]                      # (R, 3)
    w = jnp.stack([1.0 - u - v, u, v], -1) * rhw[tri_idx]
    denom = jnp.maximum(jnp.sum(w, -1, keepdims=True), 1e-30)
    vals = attr[tri_idx]                  # (R, 3, K)
    return jnp.sum(vals * w[..., None], 1) / denom


_BLEND_FACTORS = {
    C.CGL_BLEND_ZERO: lambda s, d: jnp.zeros_like(s),
    C.CGL_BLEND_ONE: lambda s, d: jnp.ones_like(s),
    C.CGL_BLEND_SRC_COLOR: lambda s, d: s,
    C.CGL_BLEND_ONE_MINUS_SRC_COLOR: lambda s, d: 1.0 - s,
    C.CGL_BLEND_SRC_ALPHA: lambda s, d: s[..., 3:4].repeat(4, -1),
    C.CGL_BLEND_ONE_MINUS_SRC_ALPHA:
        lambda s, d: 1.0 - s[..., 3:4].repeat(4, -1),
    C.CGL_BLEND_DST_ALPHA: lambda s, d: d[..., 3:4].repeat(4, -1),
    C.CGL_BLEND_ONE_MINUS_DST_ALPHA:
        lambda s, d: 1.0 - d[..., 3:4].repeat(4, -1),
    C.CGL_BLEND_DST_COLOR: lambda s, d: d,
    C.CGL_BLEND_ONE_MINUS_DST_COLOR: lambda s, d: 1.0 - d,
    # alpha-saturate: min(src_a, 1-dst_a) on RGB, 1 on alpha
    # (graphics.cpp:471-475 ALPHA_SAT)
    C.CGL_BLEND_SRC_ALPHA_SATURATE: lambda s, d: jnp.concatenate(
        [jnp.minimum(s[..., 3:4], 1.0 - d[..., 3:4]).repeat(3, -1),
         jnp.ones_like(s[..., 3:4])], -1),
}


def _depth_pass(func, z, zbuf):
    table = {
        C.CGL_COMPARE_NEVER: lambda: jnp.zeros_like(zbuf, bool),
        C.CGL_COMPARE_LESS: lambda: z < zbuf,
        C.CGL_COMPARE_EQUAL: lambda: z == zbuf,
        C.CGL_COMPARE_LEQUAL: lambda: z <= zbuf,
        C.CGL_COMPARE_GREATER: lambda: z > zbuf,
        C.CGL_COMPARE_NOTEQUAL: lambda: z != zbuf,
        C.CGL_COMPARE_GEQUAL: lambda: z >= zbuf,
        C.CGL_COMPARE_ALWAYS: lambda: jnp.ones_like(zbuf, bool),
    }
    return table[func]()


def _sample_texture_wrap(tex, u, v, repeat: bool, bilinear: bool):
    """Texture fetch with repeat/clamp wrap: bilinear (half-texel
    centered like the fixed-point sampler, graphics.cpp:125-166) or point
    (graphics.cpp:168-186) per the draw state's magfilter, matching the
    driver's filter selection (ref/driver.py make_texture_binding)."""
    th, tw = tex.shape[0], tex.shape[1]
    if not bilinear:
        def wrap_pt(i, n):
            i = jnp.floor(i).astype(jnp.int32)
            return jnp.mod(i, n) if repeat else jnp.clip(i, 0, n - 1)
        return tex[wrap_pt(v * th, th), wrap_pt(u * tw, tw)]
    x = u * tw - 0.5
    y = v * th - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wrap(i, n):
        return jnp.mod(i, n).astype(jnp.int32) if repeat \
            else jnp.clip(i, 0, n - 1).astype(jnp.int32)

    x0i, x1i = wrap(x0, tw), wrap(x0 + 1, tw)
    y0i, y1i = wrap(y0, th), wrap(y0 + 1, th)
    t00 = tex[y0i, x0i]
    t01 = tex[y0i, x1i]
    t10 = tex[y1i, x0i]
    t11 = tex[y1i, x1i]
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def _scan_statics(st, dc):
    """Hashable per-draw state tuple — the jit cache key for the scan
    path (per-draw DCR state is static, main.cpp:216-331 analog)."""
    return (st.texture_enabled, st.texture_envmode,
            st.texture_addressU == C.CGL_ADDRESS_WRAP,
            st.texture_magfilter != C.CGL_FILTER_NEAREST,
            st.color_enabled, st.depth_test, st.depth_func,
            st.depth_writemask, st.blend_enabled, st.blend_src,
            st.blend_dst, int(st.color_writemask) & 0xFFFFFFFF,
            float(dc.near), float(dc.far))


def _scan_drawcall(geo, st, dc, trace, nx, ny, zbuf, color):
    """Submission-order fragment scan on perspective rays — the exact
    per-drawcall path (module docstring 'Exactness').

    Every primitive is intersected in submission order against the
    evolving per-ray (zbuf, color) carry, reproducing the OM's sequential
    fragment semantics (om_unit.cpp:24-154) in float: depth funcs that
    need the live zbuf (EQUAL/NOTEQUAL/ALWAYS), submission-order winners
    (depth test off), and intra-draw multi-fragment blending are all
    exact, unlike the single-winner closest-hit path.

    The whole scan runs as ONE jit (statics = the draw state) instead of
    one dispatch per op."""
    clip = geo["clip"]
    idx = np.asarray(geo["indices"])
    tri = clip[idx][:, :, [0, 1, 3]].astype(np.float32)    # (P,3,3) x,y,w
    v0 = jnp.asarray(tri[:, 0])
    e1 = jnp.asarray(tri[:, 1] - tri[:, 0])
    e2 = jnp.asarray(tri[:, 2] - tri[:, 0])
    zw = jnp.asarray(clip[idx][:, :, 2:4].astype(np.float32))  # (P,3,2)
    col = jnp.asarray(np.asarray(geo["color"], np.float32)[idx])
    uvv = jnp.asarray(np.asarray(geo["uv"], np.float32)[idx])

    if st.texture_enabled:
        tex = trace.textures[dc.texture_id]
        vx_fmt = C.CGL_TO_VX_FORMAT[tex.format]
        img = jnp.asarray(mipmap.texture_rgba_float(
            tex.pixels, vx_fmt, tex.width, tex.height))
    else:
        img = jnp.zeros((1, 1, 4), F32)
    return _scan_drawcall_jit(_scan_statics(st, dc), v0, e1, e2, zw, col,
                              uvv, img, nx, ny, zbuf, color)


@functools.partial(jax.jit, static_argnums=(0,))
def _scan_drawcall_jit(statics, v0, e1, e2, zw, col, uvv, img, nx, ny,
                       zbuf, color):
    (texture_enabled, envmode, repeat, bilinear, color_enabled,
     depth_test, depth_func, depth_writemask, blend_enabled, blend_src,
     blend_dst, wm, near, far) = statics

    class st:                         # attribute view of the statics
        pass

    st.texture_enabled = texture_enabled
    st.texture_envmode = envmode
    st.color_enabled = color_enabled
    st.depth_test = depth_test
    st.depth_func = depth_func
    st.depth_writemask = depth_writemask
    st.blend_enabled = blend_enabled
    st.blend_src = blend_src
    st.blend_dst = blend_dst

    o = jnp.zeros((nx.shape[0], 3), F32)
    d = jnp.stack([nx, ny, jnp.ones_like(nx)], -1)
    half_d = 0.5 * (far - near)
    zoff = near + half_d
    chan = jnp.asarray([bool(wm & 0x00FF0000), bool(wm & 0x0000FF00),
                        bool(wm & 0x000000FF), bool(wm & 0xFF000000)])

    def step(carry, xs):
        zbuf, color = carry
        tv0, te1, te2, tzw, tcol, tuv = xs
        # Möller–Trumbore, one triangle vs all rays
        px = d[:, 1] * te2[2] - d[:, 2] * te2[1]
        py = d[:, 2] * te2[0] - d[:, 0] * te2[2]
        pz = d[:, 0] * te2[1] - d[:, 1] * te2[0]
        det = te1[0] * px + te1[1] * py + te1[2] * pz
        inv = jnp.where(jnp.abs(det) > 1e-30, 1.0 / det, 0.0)
        tx = o[:, 0] - tv0[0]
        ty = o[:, 1] - tv0[1]
        tz = o[:, 2] - tv0[2]
        u = (tx * px + ty * py + tz * pz) * inv
        qx = ty * te1[2] - tz * te1[1]
        qy = tz * te1[0] - tx * te1[2]
        qz = tx * te1[1] - ty * te1[0]
        v = (d[:, 0] * qx + d[:, 1] * qy + d[:, 2] * qz) * inv
        t = (te2[0] * qx + te2[1] * qy + te2[2] * qz) * inv
        hit = ((jnp.abs(det) > 1e-30) & (u >= 0) & (v >= 0)
               & (u + v <= 1) & (t > 1e-6))

        w = jnp.stack([1.0 - u - v, u, v], -1)             # (R, 3)
        zwp = jnp.einsum("rk,kc->rc", w, tzw,
                             precision=_HIGHEST)
        z = (zwp[:, 0] / jnp.where(jnp.abs(zwp[:, 1]) > 1e-30,
                                   zwp[:, 1], 1.0)) * half_d + zoff

        if st.color_enabled:
            src = jnp.einsum("rk,kc->rc", w, tcol,
                             precision=_HIGHEST)
        else:
            src = jnp.ones((d.shape[0], 4), F32)
        if st.texture_enabled:
            uvp = jnp.einsum("rk,kc->rc", w, tuv,
                             precision=_HIGHEST)
            texel = _sample_texture_wrap(img, uvp[:, 0], uvp[:, 1],
                                         repeat, bilinear)
            if st.texture_envmode == C.CGL_ENVMODE_MODULATE:
                src = src * texel
            elif st.texture_envmode == C.CGL_ENVMODE_ADD:
                src = jnp.clip(src + texel, 0.0, 1.0)
            else:
                src = texel

        passed = hit
        if st.depth_test:
            passed = passed & _depth_pass(st.depth_func, z, zbuf)
            if st.depth_writemask:
                zbuf = jnp.where(passed, z, zbuf)

        out = src
        if st.blend_enabled:
            sf = _BLEND_FACTORS[st.blend_src](src, color)
            df = _BLEND_FACTORS[st.blend_dst](src, color)
            out = jnp.clip(src * sf + color * df, 0.0, 1.0)
        color = jnp.where(passed[:, None] & chan[None, :], out, color)
        return (zbuf, color), None

    (zbuf, color), _ = jax.lax.scan(step, (zbuf, color),
                                    (v0, e1, e2, zw, col, uvv))
    return zbuf, color


def render_trace_rt(trace: cgltrace.CGLTrace, width: int, height: int,
                    engine: str = "bvh", camera: str = "screen",
                    start_draw: int = 0, end_draw: int = 2 ** 31,
                    on_stencil: str = "raise"):
    """Ray-trace a CGLTrace scene -> (H, W, 4) float32 RGBA (row 0 = top,
    same layout as ref.driver framebuffers).

    camera: "screen" (orthographic screen-space rays) or "perspective"
    (rays diverging from the real eye implied by the clip-space
    vertices — see module docstring).
    engine: "bvh" | "brute" | "kernel" | "auto" (the device's route,
    runtime.device.rt_engine).  "auto" and "kernel" with the perspective
    camera render through the compiled single-dispatch frame (rt.frame).

    Cites: drawcall loop ≅ tests/regression/draw3d/main.cpp:171-373;
    per-drawcall state ≅ the DCR writes at main.cpp:216-331.
    """
    if camera == "perspective" and engine in ("auto", "kernel"):
        # the compiled single-dispatch frame (rt.frame): one closest-hit
        # walk for opaque winners, K-slot enumeration walks for
        # blended/ordering-free draws — replaces both the eager per-draw
        # loop and the O(rays x prims) submission-order scan
        from . import frame as frame_mod
        return frame_mod.render_trace_rt_fused(
            trace, width, height, start_draw=start_draw,
            end_draw=end_draw, on_stencil=on_stencil,
            engine=None if engine == "auto" else engine)

    ys, xs = np.mgrid[0:height, 0:width]
    px = jnp.asarray((xs + 0.5).astype(np.float32).ravel())
    py = jnp.asarray((ys + 0.5).astype(np.float32).ravel())
    # pixel-center NDC for the perspective eye (inverse of the viewport
    # mapping in geom/transform.clip_to_screen)
    nx = px * (2.0 / width) - 1.0
    ny = py * (2.0 / height) - 1.0

    color = jnp.zeros((height * width, 4), F32).at[:, 3].set(1.0)
    zbuf = jnp.full((height * width,), np.float32(np.inf), F32)

    for dc in trace.drawcalls[start_draw:end_draw]:
        st = dc.states
        if st.stencil_test:
            # asserted-absent (VERDICT r2 #7): no CGLTrace scene uses
            # stencil; modeling it here would duplicate om/depth_stencil
            if on_stencil == "raise":
                raise NotImplementedError(
                    "raster_bridge does not model stencil state; render "
                    "this trace through the raster path, or pass "
                    "on_stencil='skip'")
            warnings.warn("raster_bridge: skipping drawcall with stencil "
                          "enabled (not modeled; use the raster path)")
            continue
        geo = _screen_triangles(dc, width, height)
        if geo is None:
            continue
        idx = jnp.asarray(geo["indices"])
        rhw = jnp.asarray(geo["rhw"])
        key = _depth_key(geo, st)

        if camera == "perspective" and (key is None or st.blend_enabled):
            # exact submission-order fragment scan (see module docstring)
            zbuf, color = _scan_drawcall(geo, st, dc, trace, nx, ny,
                                         zbuf, color)
            continue

        if camera == "perspective":
            farthest = st.depth_func in (C.CGL_COMPARE_GREATER,
                                         C.CGL_COMPARE_GEQUAL)
            prim, u, v = _persp_hit(geo, nx, ny, farthest, engine)
            zattr = jnp.asarray(geo["clip"][:, 2:4].astype(np.float32))
        else:
            prim, u, v = _closest_hit(_winner_tris(geo, key),
                                      px, py, engine)
            zattr = jnp.asarray(geo["xy_z"][:, 2:3].astype(np.float32))
        if st.texture_enabled:
            tex = trace.textures[dc.texture_id]
            vx_fmt = C.CGL_TO_VX_FORMAT[tex.format]
            img = jnp.asarray(mipmap.texture_rgba_float(
                tex.pixels, vx_fmt, tex.width, tex.height))
        else:
            img = jnp.zeros((1, 1, 4), F32)
        # interpolation + depth + blend + masked write: one jit per draw
        # state instead of one dispatch per op
        zbuf, color = _winner_composite_jit(
            _scan_statics(st, dc), camera == "perspective", idx, rhw,
            zattr, jnp.asarray(np.asarray(geo["color"], np.float32)),
            jnp.asarray(np.asarray(geo["uv"], np.float32)), img,
            prim, u, v, zbuf, color)

    return np.asarray(color).reshape(height, width, 4)



@functools.partial(jax.jit, static_argnums=(0, 1))
def _winner_composite_jit(statics, perspective, idx, rhw, zattr, colattr,
                          uvattr, img, prim, u, v, zbuf, color):
    """Winner-path per-draw composite (interp -> texture -> depth ->
    blend -> masked write) compiled per draw-state tuple."""
    (texture_enabled, envmode, repeat, bilinear, color_enabled,
     depth_test, depth_func, depth_writemask, blend_enabled, blend_src,
     blend_dst, wm, near, far) = statics

    if perspective:
        def interp(attr):
            return _interp_bary(attr, idx, prim, u, v)
        zw = interp(zattr)
        half_d = 0.5 * (far - near)
        # z_ndc = z_c/w_c at the hit, viewport-mapped — identical to the
        # raster's perspective-correct z (clip_to_screen z)
        z = (zw[:, 0] / zw[:, 1]) * half_d + (near + half_d)
    else:
        def interp(attr):
            return _interp_pc(attr, idx, rhw, prim, u, v)
        z = interp(zattr)[:, 0]
    hit = prim >= 0

    # color_enabled gates vertex-color INTERPOLATION (the kernel's rgba
    # defaults to 1.0 otherwise, kernel.cpp:16-23); the framebuffer
    # write is gated by color_writemask below
    if color_enabled:
        src = interp(colattr)
    else:
        src = jnp.ones((prim.shape[0], 4), F32)

    if texture_enabled:
        uv_i = interp(uvattr)
        texel = _sample_texture_wrap(img, uv_i[:, 0], uv_i[:, 1], repeat,
                                     bilinear)
        if envmode == C.CGL_ENVMODE_MODULATE:
            src = src * texel
        elif envmode == C.CGL_ENVMODE_ADD:
            src = jnp.clip(src + texel, 0.0, 1.0)
        else:                        # REPLACE (and BLEND fallback)
            src = texel

    passed = hit
    if depth_test:
        passed = passed & _depth_pass(depth_func, z, zbuf)
        if depth_writemask:
            zbuf = jnp.where(passed, z, zbuf)

    out = src
    if blend_enabled:
        sf = _BLEND_FACTORS[blend_src](src, color)
        df = _BLEND_FACTORS[blend_dst](src, color)
        out = jnp.clip(src * sf + color * df, 0.0, 1.0)
    # per-channel write mask (ARGB bytes of cbuf_writemask)
    chan = jnp.asarray([bool(wm & 0x00FF0000), bool(wm & 0x0000FF00),
                        bool(wm & 0x000000FF), bool(wm & 0xFF000000)])
    color = jnp.where(passed[:, None] & chan[None, :], out, color)
    return zbuf, color


def render_scene_rt(name: str, width: int, height: int, **kw) -> np.ndarray:
    """Ray-trace one of the reference's checked-in scenes by name."""
    trace = cgltrace.load_cached(cgltrace.trace_path(name))
    return render_trace_rt(trace, width, height, **kw)


def framebuffer_to_float(fb: np.ndarray) -> np.ndarray:
    """(H, W) uint32 ARGB raster framebuffer -> (H, W, 4) float RGBA."""
    fb = np.asarray(fb, np.uint32)
    return np.stack([(fb >> 16) & 0xFF, (fb >> 8) & 0xFF, fb & 0xFF,
                     (fb >> 24) & 0xFF], -1).astype(np.float32) / 255.0
