"""Differentiable float32 render pipeline.

The exact-int path (skybox_rt_tpu.ref) reproduces the reference bit-for-bit
but is non-differentiable by construction.  This module is the gradient
twin: same architecture (host binning -> per-tile primitive scan -> output
merge), but all math in float32 with gradients flowing to

  * vertex positions   (through edge functions and barycentrics)
  * vertex colors      (through interpolation)
  * texture coordinates and texels (through bilinear sampling)

This covers the north-star inverse-rendering config (pixel grads w.r.t.
vertex pos / material+texture params, BASELINE.json configs[3]).  The
reference has no backward pass, so gradients are validated against finite
differences (tests/test_diff.py), per SURVEY §7 "differentiating discrete
steps".

Discrete-step policy (v1):
  * coverage: hard in forward; optional sigmoid edge softening contributes
    silhouette gradients when ``soft_edge_temp > 0`` (the classic
    soft-rasterizer trick, applied as a residual weight so the forward
    image stays hard when temp == 0)
  * depth test: hard winner; gradients flow through the winning fragment
    (straight-through)
"""
from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

F32 = jnp.float32
I32 = jnp.int32


def _env_chunk(name: str, default: int) -> int:
    """Validated integer env knob, read ONCE at import (reading it at
    trace time silently no-ops for already-cached jit shapes — ADVICE
    r3)."""
    raw = os.environ.get(name, str(default))
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None
    if v <= 0:
        raise ValueError(f"{name} must be positive, got {v}")
    return v


#: Prims advanced per sequential step of the hard-mode visibility
#: reduction (visibility_slots).  Larger = fewer scan steps but bigger
#: (CH, ts, ts) temporaries.
#: Override with env SKYBOX_VIS_CHUNK **before importing** this module.
VIS_CHUNK = _env_chunk("SKYBOX_VIS_CHUNK", 128)


@dataclasses.dataclass(frozen=True)
class DiffRenderConfig:
    width: int
    height: int
    tile_logsize: int = 5
    near: float = 0.0
    far: float = 1.0
    depth_test: bool = True
    alpha_blend: bool = False      # src*a + dst*(1-a) over-compositing
    textured: bool = False
    modulate: bool = False         # multiply texture by vertex color
    soft_edge_temp: float = 0.0    # 0 = hard coverage
    background: tuple = (0.0, 0.0, 0.0, 1.0)


def clip_to_hdc(pos, cfg: DiffRenderConfig):
    """Differentiable clip -> homogeneous device coords (transform.py twin)."""
    half_w = 0.5 * cfg.width
    half_h = 0.5 * cfg.height
    x = pos[..., 0] * half_w + pos[..., 3] * half_w
    y = pos[..., 1] * half_h + pos[..., 3] * half_h
    w = pos[..., 3]
    return x, y, w


def screen_z(pos, cfg: DiffRenderConfig):
    half_d = 0.5 * (cfg.far - cfg.near)
    return pos[..., 2] / pos[..., 3] * half_d + (cfg.near + half_d)


def edge_matrix(p0, p1, p2):
    """Edge equations from HDC positions (differentiable edge_equation twin).

    p*: tuples (x, y, w) of (P,) arrays.  Returns (P, 3, 3).
    """
    x0, y0, w0 = p0
    x1, y1, w1 = p1
    x2, y2, w2 = p2
    a0 = y1 * w2 - y2 * w1
    a1 = y2 * w0 - y0 * w2
    a2 = y0 * w1 - y1 * w0
    b0 = x2 * w1 - x1 * w2
    b1 = x0 * w2 - x2 * w0
    b2 = x1 * w0 - x0 * w1
    c0 = x1 * y2 - x2 * y1
    c1 = x2 * y0 - x0 * y2
    c2 = x0 * y1 - x1 * y0
    det = c0 * w0 + c1 * w1 + c2 * w2
    sign = jnp.where(det < 0, F32(-1.0), F32(1.0))
    edges = jnp.stack([
        jnp.stack([a0, b0, c0], -1),
        jnp.stack([a1, b1, c1], -1),
        jnp.stack([a2, b2, c2], -1),
    ], axis=1) * sign[:, None, None]
    # half-pixel offset: sample at pixel centers
    c_off = edges[:, :, 2] + 0.5 * (edges[:, :, 0] + edges[:, :, 1])
    return jnp.concatenate([edges[:, :, :2], c_off[:, :, None]], axis=-1)


def sample_texture_bilinear(tex, u, v):
    """Differentiable bilinear sample.  tex: (TH, TW, 4) float; u,v in [0,1]
    with repeat wrapping.  Gradients flow to texels and to u/v."""
    th, tw = tex.shape[0], tex.shape[1]
    uu = (u % 1.0) * tw - 0.5
    vv = (v % 1.0) * th - 0.5
    x0 = jnp.floor(uu)
    y0 = jnp.floor(vv)
    fx = uu - x0
    fy = vv - y0
    x0i = jnp.mod(x0.astype(I32), tw)
    x1i = jnp.mod(x0i + 1, tw)
    y0i = jnp.mod(y0.astype(I32), th)
    y1i = jnp.mod(y0i + 1, th)
    t00 = tex[y0i, x0i]
    t01 = tex[y0i, x1i]
    t10 = tex[y1i, x0i]
    t11 = tex[y1i, x1i]
    fx = fx[..., None]
    fy = fy[..., None]
    # fma-form lerps (a + f*(b-a)): 2 ops per lerp instead of 3; the quad
    # sampler (_quad_lerp) MUST use the identical form — the deferred
    # pipeline's exact-equality tests compare the two
    cx0 = t00 + fx * (t01 - t00)
    cx1 = t10 + fx * (t11 - t10)
    return cx0 + fy * (cx1 - cx0)


def prim_setup(params, indices, cfg: DiffRenderConfig):
    """Differentiable geometry processing: vertices -> per-prim raster data.

    The in-graph twin of host binning's math (gradients flow through edge
    coefficients back to positions).  Returns a dict of (P, ...) arrays.
    """
    pos = params["pos"]
    color = params["color"]
    P = indices.shape[0]
    # gather vertex ROWS once per corner (gather_rows routes the
    # transpose through the accumulation kernel instead of autodiff's
    # scatter), then run the elementwise clip math on the gathered copies
    # — same per-vertex float results, no per-element gathers
    iall = jnp.concatenate([indices[:, 0], indices[:, 1], indices[:, 2]])
    pos3 = gather_rows(pos, iall).reshape(3, P, 4)
    hdc0 = clip_to_hdc(pos3[0], cfg)
    hdc1 = clip_to_hdc(pos3[1], cfg)
    hdc2 = clip_to_hdc(pos3[2], cfg)
    edges = edge_matrix(hdc0, hdc1, hdc2)         # (P, 3, 3)
    color3 = gather_rows(color, iall).reshape(3, P, 4)
    setup = {
        "edges": edges,
        "z": jnp.stack([screen_z(pos3[0], cfg), screen_z(pos3[1], cfg),
                        screen_z(pos3[2], cfg)], 1),       # (P, 3)
        "color": jnp.stack([color3[0], color3[1], color3[2]], 1),  # (P,3,4)
    }
    if cfg.textured:
        uv3 = gather_rows(params["uv"], iall).reshape(3, P, 2)
        setup["uv"] = jnp.stack([uv3[0], uv3[1], uv3[2]], 1)       # (P,3,2)
        setup["tex"] = params["tex"]
    return setup


def _tile_coords(ts: int, origin):
    ys = (jax.lax.broadcasted_iota(I32, (ts, ts), 0) + origin[1]).astype(F32)
    xs = (jax.lax.broadcasted_iota(I32, (ts, ts), 1) + origin[0]).astype(F32)
    return xs, ys


def _barycentrics(e0, e1, e2):
    s = e0 + e1 + e2
    denom = jnp.where(jnp.abs(s) > 1e-20, s, 1e-20)
    b0 = e0 / denom
    b1 = e1 / denom
    b2 = 1.0 - b0 - b1
    return b0, b1, b2


def render_tile_set(setup, tile_pids, origins, cfg: DiffRenderConfig):
    """Render a set of tiles: (T, M) pid lists + (T, 2) pixel origins ->
    (T, ts, ts, 4) RGBA tiles.  This is the unit of tile-parallel sharding
    (each device renders its tile subset, skybox_rt_tpu.parallel)."""
    ts = 1 << cfg.tile_logsize
    edges = setup["edges"]
    z0, z1, z2 = setup["z"][:, 0], setup["z"][:, 1], setup["z"][:, 2]
    c0, c1, c2 = setup["color"][:, 0], setup["color"][:, 1], setup["color"][:, 2]
    if cfg.textured:
        t0, t1, t2 = setup["uv"][:, 0], setup["uv"][:, 1], setup["uv"][:, 2]
        tex = setup["tex"]

    def render_tile(pids, origin):
        xs, ys = _tile_coords(ts, origin)

        fb_rgba = jnp.broadcast_to(
            jnp.asarray(cfg.background, F32), (ts, ts, 4)
        ).astype(F32)
        fb_z = jnp.full((ts, ts), jnp.inf, F32)

        def step(carry, pid):
            fb_rgba, fb_z = carry
            valid = pid >= 0
            p = jnp.maximum(pid, 0)
            e = edges[p]
            e0 = e[0, 0] * xs + e[0, 1] * ys + e[0, 2]
            e1 = e[1, 0] * xs + e[1, 1] * ys + e[1, 2]
            e2 = e[2, 0] * xs + e[2, 1] * ys + e[2, 2]
            inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & valid
            b0, b1, b2 = _barycentrics(e0, e1, e2)

            zp = z0[p] * b0 + z1[p] * b1 + z2[p] * b2
            col = c0[p] * b0[..., None] + c1[p] * b1[..., None] + c2[p] * b2[..., None]

            if cfg.textured:
                uvp = (t0[p] * b0[..., None] + t1[p] * b1[..., None]
                       + t2[p] * b2[..., None])
                texel = sample_texture_bilinear(tex, uvp[..., 0], uvp[..., 1])
                col = col * texel if cfg.modulate else texel

            if cfg.soft_edge_temp > 0:
                # differentiable silhouette weight; == hard coverage in the
                # limit temp->0.  Weight multiplies the src contribution.
                temp = F32(cfg.soft_edge_temp)
                d = jnp.minimum(jnp.minimum(e0, e1), e2)
                w_soft = jax.nn.sigmoid(d / temp)
                cov_w = jnp.where(valid, w_soft, 0.0)
            else:
                cov_w = inside.astype(F32)

            if cfg.depth_test:
                zpass = zp < fb_z
                write = inside & zpass
                new_z = jnp.where(write, zp, fb_z)
            else:
                write = inside
                new_z = fb_z

            if cfg.alpha_blend:
                a = col[..., 3:4] * cov_w[..., None]
                blended = col * a + fb_rgba * (1.0 - a)
                new_rgba = jnp.where(write[..., None], blended, fb_rgba)
            else:
                src = col * cov_w[..., None] + fb_rgba * (1.0 - cov_w[..., None])
                new_rgba = jnp.where(write[..., None], src, fb_rgba)

            return (new_rgba, new_z), None

        (fb_rgba, fb_z), _ = jax.lax.scan(step, (fb_rgba, fb_z), pids)
        return fb_rgba

    return jax.vmap(render_tile)(tile_pids, origins)    # (T, ts, ts, 4)


def _is_hard(cfg: DiffRenderConfig) -> bool:
    return (not cfg.alpha_blend) and cfg.soft_edge_temp == 0


def _lex_min_comp(acc, x):
    """Associative lexicographic-(z, step) min for lax.reduce: smaller z
    wins, z ties take the smaller step."""
    az, asn = acc
    bz, bs = x
    take_b = bz < az
    tie = bz == az
    z = jnp.where(take_b, bz, az)
    s = jnp.where(take_b, bs, jnp.where(tie, jnp.minimum(asn, bs), asn))
    return z, s


def visibility_slots(setup, tile_pids, origins, cfg: DiffRenderConfig,
                     slots: int = 8):
    """K-slot visibility pass — NON-differentiable (the analog of the
    exact-int deferred pass 1, ops/deferred.py).

    For each pixel, records the scan-step indices (into the tile's pid
    list) of the fragments that WROTE the pixel under render_tile_set's
    exact rules (hard coverage + depth test), in submission order.  All
    inputs are stop_gradient'ed and all outputs are integers, so autodiff
    never traverses this scan — the whole backward pass runs over
    shade_slots' O(pixels*K) work instead of O(prims) sequential steps.

    Hard mode (no blend, no edge softening) needs only ONE slot maintained
    last-write-wins: the final write is the depth winner and fully
    determines the pixel, so the pass can never overflow.

    Returns (slot_steps (T, ts, ts, K) int32 with -1 = empty,
             max_writes () int32 — the observed per-pixel write count;
             exact iff max_writes <= K in non-hard modes).
    """
    ts = 1 << cfg.tile_logsize
    edges = jax.lax.stop_gradient(setup["edges"])
    z = jax.lax.stop_gradient(setup["z"])
    z0, z1, z2 = z[:, 0], z[:, 1], z[:, 2]
    hard = _is_hard(cfg)
    K = 1 if hard else slots

    if hard:
        # In hard mode the sequential write rule reduces to a pure
        # reduction: with depth test, the final write is the fragment with
        # the lexicographic-minimal (z, step) — strict `<` means the
        # earliest step wins ties; without, it's the max inside step.
        # Fully vectorized two-pass chunk reduction: zmin over the chunk,
        # then the min step attaining it — min/where only, NO argmin +
        # take_along_axis (per-element gathers).
        CH = VIS_CHUNK
        BIG = jnp.int32(2**30)

        def per_tile_hard(pids, origin):
            xs, ys = _tile_coords(ts, origin)
            M = pids.shape[0]
            Mp = -(-M // CH) * CH
            pids_p = jnp.pad(pids, (0, Mp - M), constant_values=-1)
            chunks_p = pids_p.reshape(Mp // CH, CH)
            steps_p = jnp.arange(Mp, dtype=I32).reshape(Mp // CH, CH)

            def chunk_step(carry, c):
                best_z, best_s = carry
                pc, sc = c
                valid = pc >= 0
                p = jnp.maximum(pc, 0)
                e = edges[p]                            # (CH, 3, 3)
                e0 = (e[:, 0, 0, None, None] * xs + e[:, 0, 1, None, None]
                      * ys + e[:, 0, 2, None, None])
                e1 = (e[:, 1, 0, None, None] * xs + e[:, 1, 1, None, None]
                      * ys + e[:, 1, 2, None, None])
                e2 = (e[:, 2, 0, None, None] * xs + e[:, 2, 1, None, None]
                      * ys + e[:, 2, 2, None, None])
                inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)
                          & valid[:, None, None])
                if cfg.depth_test:
                    b0, b1, b2 = _barycentrics(e0, e1, e2)
                    zp = (z0[p][:, None, None] * b0
                          + z1[p][:, None, None] * b1
                          + z2[p][:, None, None] * b2)
                    # z=inf/NaN never wins a `<` test in the sequential
                    # oracle — such fragments carry no step
                    ok = inside & jnp.isfinite(zp)
                    zi = jnp.where(ok, zp, jnp.inf)
                    si = jnp.where(ok, sc[:, None, None], BIG)
                    # ONE variadic lexicographic-(z, step) min over the
                    # chunk (zi computed once, no second pass)
                    czmin, csmin = jax.lax.reduce(
                        (zi, si), (F32(jnp.inf), BIG), _lex_min_comp,
                        (0,))
                    # lexicographic (z, step) merge with the carry
                    take = czmin < best_z
                    tie = czmin == best_z
                    best_s = jnp.where(
                        take, csmin,
                        jnp.where(tie, jnp.minimum(best_s, csmin), best_s))
                    best_z = jnp.where(take, czmin, best_z)
                else:
                    # last inside write wins: max step inside this chunk
                    si = jnp.where(inside, sc[:, None, None], -1)
                    smax = jnp.max(si, axis=0)
                    best_s = jnp.maximum(best_s, smax)
                return (best_z, best_s), None

            s0 = BIG if cfg.depth_test else jnp.int32(-1)
            carry = (jnp.full((ts, ts), jnp.inf, F32),
                     jnp.full((ts, ts), s0, I32))
            (_, best_s), _ = jax.lax.scan(chunk_step, carry,
                                          (chunks_p, steps_p))
            if cfg.depth_test:
                best_s = jnp.where(best_s == BIG, -1, best_s)
            return best_s[..., None], (best_s >= 0).astype(I32).max()

        slot_steps, maxw = jax.vmap(per_tile_hard)(tile_pids, origins)
        return slot_steps, maxw.max()

    # K-slot path, chunk-vectorized: the sequential per-pixel rules
    # become prefix scans along the chunk's prim axis —
    #   * running depth min = exclusive cummin of the chunk's inside-z
    #     (a rejected fragment's z can never lower the running min, so
    #     the inside-prefix min equals the written-prefix min)
    #   * slot index = carry count + exclusive cumsum of writes
    # CH2 prims advance per sequential step instead of one.
    CH2 = 32

    def per_tile(pids, origin):
        xs, ys = _tile_coords(ts, origin)
        M = pids.shape[0]
        Mp = -(-M // CH2) * CH2
        pids_p = jnp.pad(pids, (0, Mp - M), constant_values=-1)
        chunks_p = pids_p.reshape(Mp // CH2, CH2)
        steps_p = jnp.arange(Mp, dtype=I32).reshape(Mp // CH2, CH2)

        def chunk_step(carry, c):
            fb_z, slot_steps, count = carry
            pc, sc = c
            valid = pc >= 0
            p = jnp.maximum(pc, 0)
            e = edges[p]                            # (CH2, 3, 3)
            e0 = (e[:, 0, 0, None, None] * xs + e[:, 0, 1, None, None]
                  * ys + e[:, 0, 2, None, None])
            e1 = (e[:, 1, 0, None, None] * xs + e[:, 1, 1, None, None]
                  * ys + e[:, 1, 2, None, None])
            e2 = (e[:, 2, 0, None, None] * xs + e[:, 2, 1, None, None]
                  * ys + e[:, 2, 2, None, None])
            inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)
                      & valid[:, None, None])
            if cfg.depth_test:
                b0, b1, b2 = _barycentrics(e0, e1, e2)
                zp = (z0[p][:, None, None] * b0
                      + z1[p][:, None, None] * b1
                      + z2[p][:, None, None] * b2)
                # NaN z never writes and never moves the running min
                zi = jnp.where(inside & ~jnp.isnan(zp), zp, jnp.inf)
                cm = jax.lax.cummin(zi, axis=0)
                runmin = jnp.minimum(
                    fb_z[None],
                    jnp.concatenate([jnp.full_like(zi[:1], jnp.inf),
                                     cm[:-1]], axis=0))
                write = inside & (zp < runmin)
                fb_z = jnp.minimum(fb_z, cm[-1])
            else:
                write = inside
            wi = write.astype(I32)
            slot = (count[None] + jnp.cumsum(wi, axis=0) - wi)  # exclusive
            for k in range(K):
                cand = jnp.max(jnp.where(write & (slot == k),
                                         sc[:, None, None], -1), axis=0)
                slot_steps = slot_steps.at[..., k].set(
                    jnp.where(cand >= 0, cand, slot_steps[..., k]))
            count = count + wi.sum(axis=0)
            return (fb_z, slot_steps, count), None

        carry = (jnp.full((ts, ts), jnp.inf, F32),
                 jnp.full((ts, ts, K), -1, I32),
                 jnp.zeros((ts, ts), I32))
        (fb_z, slot_steps, count), _ = jax.lax.scan(
            chunk_step, carry, (chunks_p, steps_p))
        return slot_steps, count.max()

    slot_steps, maxw = jax.vmap(per_tile)(tile_pids, origins)
    return slot_steps, maxw.max()


def _quad_texture(tex):
    """(TH, TW, 4) -> (TH, TW, 4, 4): the 2x2 bilinear footprint anchored
    at each texel, built from rolls (repeat wrap), so sampling needs ONE
    row gather instead of four and its backward ONE scatter-add instead
    of four (rolls transpose to rolls — no extra scatters).  The float
    twin of texture.sampler.make_texel_quad_array."""
    tx = jnp.roll(tex, -1, axis=1)
    ty = jnp.roll(tex, -1, axis=0)
    txy = jnp.roll(tx, -1, axis=0)
    return jnp.stack([tex, tx, ty, txy], axis=2)


def _quad_sample_prep(tex_quad, u, v):
    th, tw = tex_quad.shape[0], tex_quad.shape[1]
    uu = (u % 1.0) * tw - 0.5
    vv = (v % 1.0) * th - 0.5
    x0 = jnp.floor(uu)
    y0 = jnp.floor(vv)
    fx = uu - x0
    fy = vv - y0
    x0i = jnp.mod(x0.astype(I32), tw)
    y0i = jnp.mod(y0.astype(I32), th)
    idx = y0i * tw + x0i
    q = tex_quad.reshape(th * tw, 4, 4)[idx]
    return q, idx, fx, fy


def _quad_lerp(q, fx, fy):
    fxe = fx[..., None]
    fye = fy[..., None]
    # same fma-form as sample_texture_bilinear (exact-equality contract)
    cx0 = q[..., 0, :] + fxe * (q[..., 1, :] - q[..., 0, :])
    cx1 = q[..., 2, :] + fxe * (q[..., 3, :] - q[..., 2, :])
    return cx0 + fye * (cx1 - cx0)


def _accumulate_rows(idx, val, num_rows: int):
    """Scatter-add transpose Σ val[n] -> row idx[n] (an atomic scatter-add
    on the GPU)."""
    return jnp.zeros((num_rows, val.shape[-1]), F32).at[idx].add(val)


@jax.custom_vjp
def gather_rows(table, idx):
    """table[(P, C)][idx] with the gather transpose routed through
    _accumulate_rows."""
    return table[idx]


def _gather_rows_fwd(table, idx):
    return table[idx], (table, idx)


def _gather_rows_bwd(res, g):
    table, idx = res
    R, C = table.shape
    d = _accumulate_rows(idx.reshape(-1), g.reshape(-1, C), R)
    return d, np.zeros(idx.shape, jax.dtypes.float0)


gather_rows.defvjp(_gather_rows_fwd, _gather_rows_bwd)


@jax.custom_vjp
def gather_tile_rows(table, idx):
    """Per-tile row gather: table (T, M, C)[t, idx[t, ...]] -> (T, ..., C).

    The transpose accumulates pixels into the SMALL per-tile prim axis M
    — two-level accumulation: pixels -> tile slots here, tile slots ->
    global prim rows via gather_rows."""
    T, M, C = table.shape
    return jnp.take_along_axis(
        table, idx.reshape(T, -1)[..., None], axis=1
    ).reshape(*idx.shape, C)


def _gather_tile_rows_fwd(table, idx):
    return gather_tile_rows(table, idx), (table, idx)


def _gather_tile_rows_bwd(res, g):
    """Scatter-add of the pixel cotangents into the tile's prim slots —
    measured faster than a float32 one-hot einsum over the prim axis
    (PERF.md, diff step on the H100)."""
    table, idx = res
    T, M, C = table.shape
    t = jnp.arange(T, dtype=idx.dtype)[:, None]
    d = jnp.zeros((T, M, C), g.dtype).at[t, idx.reshape(T, -1)].add(
        g.reshape(T, -1, C))
    return d, np.zeros(idx.shape, jax.dtypes.float0)


gather_tile_rows.defvjp(_gather_tile_rows_fwd, _gather_tile_rows_bwd)


@jax.custom_vjp
def sample_texture_bilinear_quad(tex_quad, u, v):
    """sample_texture_bilinear on a _quad_texture table — identical values
    (t01/t10/t11 rows ARE the wrapped +1 neighbors), one gather.  The
    hand-written VJP routes the texel-table gradient through
    _accumulate_rows instead of autodiff's serialized scatter-add."""
    q, _, fx, fy = _quad_sample_prep(tex_quad, u, v)
    return _quad_lerp(q, fx, fy)


def _quad_sample_fwd(tex_quad, u, v):
    q, idx, fx, fy = _quad_sample_prep(tex_quad, u, v)
    return _quad_lerp(q, fx, fy), (tex_quad, idx, fx, fy)


def _quad_sample_bwd(res, g):
    tex_quad, idx, fx, fy = res
    th, tw = tex_quad.shape[0], tex_quad.shape[1]
    q = tex_quad.reshape(th * tw, 4, 4)[idx]         # regather (cheap)
    fxe = fx[..., None]
    fye = fy[..., None]
    t00, t01 = q[..., 0, :], q[..., 1, :]
    t10, t11 = q[..., 2, :], q[..., 3, :]
    # d/dfx, d/dfy of the lerp; chain through fx = frac((u%1)*tw - .5)
    # (d frac/d u = tw a.e., floor/mod contribute identity — the same
    # almost-everywhere rule autodiff applies to the original sampler)
    dfx = jnp.sum(g * ((t01 - t00) * (1 - fye) + (t11 - t10) * fye), -1)
    dfy = jnp.sum(g * ((t10 - t00) * (1 - fxe) + (t11 - t01) * fxe), -1)
    du = dfx * tw
    dv = dfy * th
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    V = jnp.concatenate([w[..., None] * g
                         for w in (w00, w01, w10, w11)], axis=-1)
    dtq = _accumulate_rows(idx.reshape(-1), V.reshape(-1, 16), th * tw)
    return dtq.reshape(th, tw, 4, 4), du, dv


sample_texture_bilinear_quad.defvjp(_quad_sample_fwd, _quad_sample_bwd)


def shade_slots(setup, tile_pids, slot_steps, origins,
                cfg: DiffRenderConfig):
    """Differentiable slot shading/composite — pass 2 of the deferred
    pipeline.  Per pixel, folds render_tile_set's exact composite rule over
    the K recorded fragments in submission order; all interpolation,
    texture sampling and (soft) coverage weights are recomputed here from
    the *differentiable* setup, so gradients flow to pos/color/uv/texels
    with O(pixels*K) work and no sequential prim scan in the backward.

    Per-prim data is packed into ONE (P, C) record array so each pixel
    does a single gather row (and the backward a single scatter row)
    instead of seven, and texels come from the rolled quad table
    (_quad_texture) — one texel gather per bilinear sample.
    """
    ts = 1 << cfg.tile_logsize
    edges = setup["edges"]
    P = edges.shape[0]
    parts = [edges.reshape(P, 9),
             setup["color"].reshape(P, 12)]
    if cfg.textured:
        parts.append(setup["uv"].reshape(P, 6))
        tex_quad = _quad_texture(setup["tex"])
    rec = jnp.concatenate(parts, axis=1)            # (P, 21 | 27)

    # batched over tiles WITHOUT vmap: every op below is a plain batched
    # gather/elementwise, and the custom-vjp texture sampler must see the
    # full (T, ts, ts) batch so its backward runs the accumulation kernel
    # once (not per-tile under a vmap batching rule)
    T = tile_pids.shape[0]
    # two-level record access: global rows -> per-tile table (its
    # transpose is a tiny 17k-row accumulation), then slot-index gather
    # per pixel (transpose = batched one-hot matmul over M)
    rec_tile = gather_rows(rec, jnp.maximum(tile_pids, 0))  # (T, M, C)
    ys = (jax.lax.broadcasted_iota(I32, (1, ts, ts), 1)
          + origins[:, 1][:, None, None]).astype(F32)
    xs = (jax.lax.broadcasted_iota(I32, (1, ts, ts), 2)
          + origins[:, 0][:, None, None]).astype(F32)
    fb_rgba = jnp.broadcast_to(
        jnp.asarray(cfg.background, F32), (T, ts, ts, 4)).astype(F32)
    K = slot_steps.shape[-1]
    # Per-slot loop, NOT a K-batched gather: batching the K slots into
    # one gather interleaves the slot streams per pixel — consecutive
    # gather indices then come from DIFFERENT prims, which destroys the
    # uv/row coherence XLA's gather fast path needs.  The K-cost lever
    # is the SLOT COUNT instead:
    # measure_max_writes/auto_slots picks the scene's true K (shade work
    # is K-proportional).
    for k in range(K):
        s = slot_steps[..., k]                      # (T, ts, ts)
        live = s >= 0
        r = gather_tile_rows(rec_tile, jnp.maximum(s, 0))  # 1 row/pixel
        p = s                                       # shapes only below
        e = r[..., :9].reshape(*p.shape, 3, 3)
        e0 = e[..., 0, 0] * xs + e[..., 0, 1] * ys + e[..., 0, 2]
        e1 = e[..., 1, 0] * xs + e[..., 1, 1] * ys + e[..., 1, 2]
        e2 = e[..., 2, 0] * xs + e[..., 2, 1] * ys + e[..., 2, 2]
        b0, b1, b2 = _barycentrics(e0, e1, e2)
        c = r[..., 9:21].reshape(*p.shape, 3, 4)
        col = (c[..., 0, :] * b0[..., None] + c[..., 1, :] * b1[..., None]
               + c[..., 2, :] * b2[..., None])
        if cfg.textured:
            t = r[..., 21:27].reshape(*p.shape, 3, 2)
            uvp = (t[..., 0, :] * b0[..., None]
                   + t[..., 1, :] * b1[..., None]
                   + t[..., 2, :] * b2[..., None])
            texel = sample_texture_bilinear_quad(
                tex_quad, uvp[..., 0], uvp[..., 1])
            col = col * texel if cfg.modulate else texel
        if cfg.soft_edge_temp > 0:
            temp = F32(cfg.soft_edge_temp)
            d = jnp.minimum(jnp.minimum(e0, e1), e2)
            cov_w = jnp.where(live, jax.nn.sigmoid(d / temp), 0.0)
        else:
            cov_w = live.astype(F32)
        if cfg.alpha_blend:
            a = col[..., 3:4] * cov_w[..., None]
            new_rgba = col * a + fb_rgba * (1.0 - a)
        else:
            new_rgba = (col * cov_w[..., None]
                        + fb_rgba * (1.0 - cov_w[..., None]))
        fb_rgba = jnp.where(live[..., None], new_rgba, fb_rgba)
    return fb_rgba


def render_tile_set_deferred(setup, tile_pids, origins,
                             cfg: DiffRenderConfig, slots: int = 8):
    """Deferred differentiable tile render: visibility + slot shading.

    Exact-equal to render_tile_set when slots >= the scene's max per-pixel
    write count (hard mode: always, with one slot).  Returns
    (tiles (T, ts, ts, 4), max_writes () i32 for overflow monitoring).
    """
    slot_steps, maxw = visibility_slots(setup, tile_pids, origins, cfg,
                                        slots)
    return shade_slots(setup, tile_pids, slot_steps, origins, cfg), maxw


def render(params, static, cfg: DiffRenderConfig):
    """Differentiable forward render.

    params: dict of traced leaves:
        'pos'    (V, 4) clip-space positions
        'color'  (V, 4) vertex colors
        'uv'     (V, 2) texcoords
        'tex'    (TH, TW, 4) texture (when cfg.textured)
    static: dict of static-shape integer arrays (host binning output):
        'indices'   (P, 3)  vertex indices
        'tile_pids' (T, M)  per-tile prim lists, -1 padded
        'tile_xy'   (T, 2)  tile coords
    Returns (Hp, Wp, 4) float32 RGBA image (padded to tile multiples).
    """
    setup = prim_setup(params, static["indices"], cfg)
    tiles = render_tile_set(setup, static["tile_pids"],
                            static["tile_xy"] * (1 << cfg.tile_logsize), cfg)
    return _assemble(tiles, static["tile_xy"], cfg)


def _assemble(tiles, tile_xy, cfg: DiffRenderConfig):
    """Scatter (T, ts, ts, 4) tiles into the padded (Hp, Wp, 4) canvas."""
    ts = 1 << cfg.tile_logsize
    Hp = -(-cfg.height // ts) * ts
    Wp = -(-cfg.width // ts) * ts
    gh, gw = Hp // ts, Wp // ts
    canvas = jnp.broadcast_to(
        jnp.asarray(cfg.background, F32), (gh, gw, ts, ts, 4)
    ).astype(F32)
    canvas = canvas.at[tile_xy[:, 1], tile_xy[:, 0]].set(tiles)
    return canvas.transpose(0, 2, 1, 3, 4).reshape(Hp, Wp, 4)


def render_deferred(params, static, cfg: DiffRenderConfig, slots: int = 8):
    """Fast differentiable render (same contract as render()).

    Two-pass: non-differentiable K-slot visibility (visibility_slots)
    + differentiable slot shading (shade_slots).  Matches render()
    exactly when slots covers the scene's per-pixel write count; hard
    mode (no alpha blend, no edge softening) is always exact with its
    single winner slot.  Returns (image, max_writes).
    """
    ts = 1 << cfg.tile_logsize
    setup = prim_setup(params, static["indices"], cfg)
    tiles, maxw = render_tile_set_deferred(
        setup, static["tile_pids"], static["tile_xy"] * ts, cfg, slots)
    return _assemble(tiles, static["tile_xy"], cfg), maxw


def measure_max_writes(params, static, cfg: DiffRenderConfig) -> int:
    """The scene's per-pixel write-count ceiling under cfg's exact write
    rules — ONE eager visibility pass (the K-slot `count` carry tallies
    every write regardless of the slot capacity, so slots=1 suffices).

    The diff twin of the int path's measured blend_k (ops.deferred):
    K-slot shade work is K-proportional, so pick
    ``slots = next_pow2(measure_max_writes(...))`` instead of a static 8
    and render_deferred stays exact at a fraction of the cost.  Re-check
    against render_deferred's max_writes output if the geometry moves
    far during optimization.
    """
    if _is_hard(cfg):
        return 1
    ts = 1 << cfg.tile_logsize
    setup = prim_setup(params, static["indices"], cfg)
    _, maxw = visibility_slots(setup, static["tile_pids"],
                               static["tile_xy"] * ts, cfg, slots=1)
    return max(int(maxw), 1)


def auto_slots(params, static, cfg: DiffRenderConfig,
               headroom: int = 0) -> int:
    """next-pow2 slot count for render_deferred (>= measured writes +
    headroom), minimum 2 in non-hard modes."""
    m = measure_max_writes(params, static, cfg) + headroom
    k = 2
    while k < m:
        k *= 2
    return k


def render_cropped(params, static, cfg: DiffRenderConfig):
    return render(params, static, cfg)[: cfg.height, : cfg.width]
