"""Ray tracer: camera, shading loop, multi-bounce path tracing.

The shading stages reuse the raster pipeline's material model (barycentric
attribute interpolation, bilinear texture lookup, over-compositing), so the
RT and raster paths share behavior the way the reference's SW/HW paths
share graphics.cpp (SURVEY §2.1 B9).

Parallelism: rays are a flat (R, ...) batch — the "long context" axis
(SURVEY §5): shard over devices in skybox_rt_tpu.parallel.  Bounces
iterate with lax.scan over a fixed depth with active-lane masks
(divergence -> predication, the ipdom-stack analog).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..diff.pipeline import sample_texture_bilinear
from . import bvh as bvh_mod
from . import intersect

F32 = jnp.float32
I32 = jnp.int32

#: traversal engines: 'kernel' (the GPU traversal kernel, ops.traverse),
#: 'bvh' (the XLA stackless lockstep walk — its plain reference) and
#: 'brute' (all-pairs oracle); 'auto' asks runtime.device.rt_engine()
ENGINES = ("kernel", "bvh", "brute")


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera."""
    eye: tuple
    look_at: tuple
    up: tuple = (0.0, 1.0, 0.0)
    fov_y_deg: float = 45.0

    def basis(self):
        eye = jnp.asarray(self.eye, F32)
        fwd = jnp.asarray(self.look_at, F32) - eye
        fwd = fwd / jnp.linalg.norm(fwd)
        right = jnp.cross(fwd, jnp.asarray(self.up, F32))
        right = right / jnp.linalg.norm(right)
        up = jnp.cross(right, fwd)
        return eye, fwd, right, up


@dataclasses.dataclass(frozen=True)
class RTConfig:
    width: int
    height: int
    bounces: int = 0              # extra reflection bounces after primary
    shadows: bool = False
    textured: bool = False
    use_bvh: bool = True          # legacy toggle: False forces engine=brute
    # engine: 'auto' (the device's route, runtime.device.rt_engine) or
    # one of ENGINES
    engine: str = "auto"
    # run the 'kernel' engine in the Pallas interpreter (CPU tests only)
    interpret: bool = False
    # re-compact surviving rays to the front before each bounce (SURVEY §5
    # long-context analog: multi-bounce = loop with re-compaction).  Dead
    # rays are parked at a far origin and grouped into contiguous blocks,
    # so whole blocks of lanes leave the traversal loop at once.
    compact_bounces: bool = True
    # compaction permutation: 'argsort' (octant+Morton full sort),
    # 'argsort_om' (origin-major key — coarse origin bits above the
    # octant, see _compact_key), 'octant' (counting sort, no Morton —
    # see _compact_perm), or 'partition' (active-first only)
    compact_method: str = "argsort"
    # stay in compacted order across bounces (one packed row gather per
    # bounce + one final scatter) instead of unsorting every bounce's
    # outputs (4 row gathers + an inverse-permutation scatter per
    # bounce).  Pure scheduling change — identical image
    # (tests/test_rt.py identity tests run both).
    compact_stay: bool = True
    # number of width halvings for the bounce shape ladder: each bounce's
    # closest+shade runs at width R, R/2, ... R>>n picked at RUNTIME by
    # the live-ray count (nested lax.cond).  Compacted live rays are a
    # prefix and every per-ray result is independent of launch width, so
    # this is exact; rows past the chosen width are dead (weight 0) and
    # get parked outputs.  Trades compile time (one body per rung) for
    # skipping the full-width shade gathers/math on late bounces.
    # Requires compact_stay.  0 = off.  Default 2 (image bit-identical);
    # bounce-2+ compactions also prefix-sort at the laddered width.
    bounce_width_ladder: int = 2
    background: tuple = (0.0, 0.0, 0.0, 1.0)
    ambient: float = 0.1
    light_dir: tuple = (0.4, 0.8, 0.45)   # directional light (to light)
    light_color: tuple = (1.0, 1.0, 1.0)


@dataclasses.dataclass
class RTScene:
    """Host-side scene: geometry + per-vertex attributes + materials."""
    verts: np.ndarray          # (V, 3)
    faces: np.ndarray          # (P, 3)
    colors: np.ndarray         # (V, 4) vertex albedo
    normals: np.ndarray = None # (V, 3) vertex normals (computed if None)
    uvs: np.ndarray = None     # (V, 2)
    texture: np.ndarray = None # (TH, TW, 4) float
    reflectivity: float = 0.0  # uniform mirror weight for bounce demo
    bvh: bvh_mod.BVH = None
    # BVH builder: 'sah' (binned surface-area heuristic, best traversal),
    # 'median', or 'lbvh' (near-linear Morton build for animated geometry)
    bvh_method: str = "sah"

    def finalize(self):
        if self.normals is None:
            self.normals = vertex_normals(self.verts, self.faces)
        if self.bvh is None:
            self.bvh = bvh_mod.build(self.verts, self.faces,
                                     method=self.bvh_method)
        return self


def vertex_normals(verts, faces):
    """Area-weighted smooth vertex normals (host)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(norm, 1e-20)).astype(np.float32)


def camera_rays(cam: Camera, width: int, height: int):
    """Primary rays through pixel centers; row 0 = bottom (GL convention,
    matching the raster framebuffer orientation)."""
    eye, fwd, right, up = cam.basis()
    aspect = width / height
    tan_h = jnp.tan(jnp.deg2rad(cam.fov_y_deg) * 0.5)
    ys = (jnp.arange(height, dtype=F32) + 0.5) / height * 2.0 - 1.0
    xs = (jnp.arange(width, dtype=F32) + 0.5) / width * 2.0 - 1.0
    px = xs[None, :] * tan_h * aspect
    py = ys[:, None] * tan_h
    d = (fwd[None, None]
         + right[None, None] * px[..., None]
         + up[None, None] * py[..., None])
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(eye, d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _interp(attr_per_vertex, faces, prim, u, v):
    """Barycentric interpolation of vertex attributes at hit points."""
    p = jnp.maximum(prim, 0)
    a0 = attr_per_vertex[faces[p, 0]]
    a1 = attr_per_vertex[faces[p, 1]]
    a2 = attr_per_vertex[faces[p, 2]]
    w = (1.0 - u - v)[..., None]
    return a0 * w + a1 * u[..., None] + a2 * v[..., None]


def _part1by2_i32(x):
    """Spread 9 bits of x to every 3rd bit (int32 Morton helper)."""
    x = x & 0x1FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _compact_key(active, o, d, origin_major: bool = False):
    """Bounce re-compaction sort key: inactive rays last; active rays
    grouped by direction OCTANT (sign-consistent bundles — the
    conservative interval test can then cull on every axis) and ordered
    by a 27-bit Morton code of the origin within the active bbox (bundle
    origins stay local).  Reflected/shadow bundles formed from
    consecutive sorted rays get tight (origin, direction) boxes, which
    is what the worklist prepass culls with.

    origin_major puts the top 6 Morton bits (two octree levels of the
    origin) ABOVE the octant bits: octant-major sweeps the scene once
    per octant, origin-major keeps bundle origins tight and lets the
    octant split only within a coarse cell."""
    oct_ = ((d[:, 0] > 0).astype(I32)
            | ((d[:, 1] > 0).astype(I32) << 1)
            | ((d[:, 2] > 0).astype(I32) << 2))
    BIG = jnp.float32(3e38)
    lo = jnp.min(jnp.where(active[:, None], o, BIG), axis=0)
    hi = jnp.max(jnp.where(active[:, None], o, -BIG), axis=0)
    scale = 512.0 / jnp.maximum(hi - lo, 1e-20)
    q = jnp.clip(((o - lo) * scale), 0.0, 511.0).astype(I32)
    m = (_part1by2_i32(q[:, 0]) << 2) | (_part1by2_i32(q[:, 1]) << 1) \
        | _part1by2_i32(q[:, 2])
    if origin_major:
        key = ((m >> 21) << 24) | (oct_ << 21) | (m & 0x1FFFFF)
    else:
        key = (oct_ << 27) | m
    return jnp.where(active, key, jnp.int32(1) << 30)


def _bucket_perm(key, num_buckets: int):
    """Stable counting-sort permutation for a SMALL integer key — no
    argsort: rank-within-bucket via a (R, B) cumsum of one-hots plus
    bucket offsets.  Returns (perm, inv) with out[i] = in[perm[i]]; a few
    (R, B) passes at memory rate instead of a full sort."""
    B = num_buckets
    onehot = (key[:, None] == jnp.arange(B, dtype=key.dtype)[None]
              ).astype(I32)                          # (R, B)
    ranks = jnp.cumsum(onehot, axis=0) - 1           # (R, B) in-bucket rank
    counts = ranks[-1] + 1
    offsets = jnp.concatenate([jnp.zeros(1, I32),
                               jnp.cumsum(counts)[:-1]])
    pos = offsets[key] + jnp.take_along_axis(
        ranks, key[:, None].astype(I32), 1)[:, 0]    # destination of ray i
    perm = jnp.zeros_like(pos).at[pos].set(
        jnp.arange(pos.shape[0], dtype=pos.dtype), unique_indices=True)
    return perm, pos


def _compact_perm(active, o, d, method: str, want_inv: bool = True):
    """Bounce-compaction permutation (perm, inv): surviving rays to the
    front, dead rays last.  method:
      'argsort'   — (octant, origin-Morton) full sort (_compact_key)
      'octant'    — counting sort by direction octant only; within an
                    octant rays keep their previous (pixel-tile) order,
                    so origins stay spatially local without the Morton
                    key or the 1M-row sort
      'partition' — active-first 2-bucket split only
    want_inv=False skips the inverse-permutation scatter (the
    stay-compacted bounce loop never unsorts, so it never needs it).
    """
    if method in ("argsort", "argsort_om"):
        perm = jnp.argsort(_compact_key(active, o, d,
                                        origin_major=method == "argsort_om"),
                           stable=True)
        if not want_inv:
            return perm, None
        inv = jnp.zeros_like(perm).at[perm].set(
            jnp.arange(perm.shape[0], dtype=perm.dtype),
            unique_indices=True)
        return perm, inv
    if method == "octant":
        oct_ = ((d[:, 0] > 0).astype(I32)
                | ((d[:, 1] > 0).astype(I32) << 1)
                | ((d[:, 2] > 0).astype(I32) << 2))
        key = jnp.where(active, oct_, jnp.int32(8))
        return _bucket_perm(key, 9)
    if method == "partition":
        key = jnp.where(active, jnp.int32(0), jnp.int32(1))
        return _bucket_perm(key, 2)
    raise ValueError(f"unknown compact_method {method!r}")


def _interp3(rows3, u, v):
    """Barycentric interp of a (R, 3, C) per-corner slice (same math as
    _interp on pre-gathered rows)."""
    w = (1.0 - u - v)[..., None]
    return rows3[:, 0] * w + rows3[:, 1] * u[..., None] \
        + rows3[:, 2] * v[..., None]


def resolve_engine(cfg: RTConfig) -> str:
    """The traversal engine cfg runs: 'auto' becomes the device's route."""
    if not cfg.use_bvh:
        return "brute"
    if cfg.engine == "auto":
        from ..runtime import device
        return device.rt_engine()
    if cfg.engine not in ENGINES:
        raise ValueError(f"unknown RT engine {cfg.engine!r}")
    return cfg.engine


def make_intersectors(scene: RTScene, cfg: RTConfig):
    tri = intersect.triangle_arrays(jnp.asarray(scene.verts),
                                    jnp.asarray(scene.faces))
    engine = resolve_engine(cfg)
    if engine == "kernel":
        from ..ops import traverse

        prep = traverse.prepare_scene(scene.bvh.as_stackless_arrays(), tri,
                                      scene.bvh.leaf_size)

        def closest(o, d, t_max=jnp.inf):
            tm = None if t_max is jnp.inf else t_max
            return traverse.traverse(prep, o, d, t_max=tm,
                                     interpret=cfg.interpret)

        def occluded(o, d, t_max):
            return traverse.traverse(prep, o, d, mode="any", t_max=t_max,
                                     interpret=cfg.interpret)
    elif engine == "bvh":
        bvh_arr = scene.bvh.as_stackless_arrays()
        ls = scene.bvh.leaf_size

        def closest(o, d, t_max=jnp.inf):
            return bvh_mod.closest_hit_stackless(bvh_arr, tri, o, d,
                                                 t_max=t_max, leaf_size=ls)

        def occluded(o, d, t_max):
            return bvh_mod.any_hit_stackless(bvh_arr, tri, o, d,
                                             t_max=t_max, leaf_size=ls)
    else:
        def closest(o, d, t_max=jnp.inf):
            return intersect.closest_hit_bruteforce(*((o, d) + tri),
                                                    t_max=t_max)

        def occluded(o, d, t_max):
            return intersect.any_hit_bruteforce(*((o, d) + tri), t_max=t_max)
    return closest, occluded


def shade_hits(scene_arrays, cfg: RTConfig, occluded, o, d, prim, t, u, v):
    """Lambert + optional texture + optional shadow for a hit batch.

    Returns (rgb (R,3), hit_mask (R,), hit_point, normal)."""
    hit = prim >= 0
    pt = o + d * jnp.where(hit, t, 0.0)[..., None]
    # ONE packed record row per hit instead of six per-corner vertex
    # gathers (normals + colors [+ uvs] x 3 corners): the row count of
    # 1M-ray gathers dominated the shade stage — the same packed-row
    # lesson as the diff pipeline's (P, 27) record
    # (diff/pipeline.shade_slots)
    rec = scene_arrays["rec"]
    r = rec[jnp.maximum(prim, 0)]                  # (R, 21 | 27)
    R = r.shape[0]
    n = _interp3(r[:, 0:9].reshape(R, 3, 3), u, v)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    # two-sided shading: flip normal against the incoming ray
    n = jnp.where(jnp.sum(n * d, -1, keepdims=True) > 0, -n, n)

    albedo = _interp3(r[:, 9:21].reshape(R, 3, 4), u, v)[..., :3]
    if cfg.textured:
        uv = _interp3(r[:, 21:27].reshape(R, 3, 2), u, v)
        texel = sample_texture_bilinear(scene_arrays["texture"],
                                        uv[..., 0], uv[..., 1])
        albedo = albedo * texel[..., :3]

    ldir = jnp.asarray(cfg.light_dir, F32)
    ldir = ldir / jnp.linalg.norm(ldir)
    ndotl = jnp.maximum(jnp.sum(n * ldir, -1), 0.0)

    if cfg.shadows:
        # park shadow rays of non-hit pixels AND of terminator points
        # (ndotl <= 0: occlusion cannot change their shading — the
        # Lambert clamp already zeroed them).  A parked ray misses the
        # root box and leaves the walk at once; on the north-star sphere
        # field roughly half the lit surface faces away from the light,
        # so this halves the live shadow rays exactly.
        need = hit & (ndotl > 0.0)
        park_o = jnp.asarray([3e7, 3e7, 3e7], F32)
        sh_o = jnp.where(need[..., None], pt + n * 1e-3, park_o)
        sh_d = jnp.broadcast_to(ldir, sh_o.shape)
        blocked = occluded(sh_o, sh_d, 1e8)
        ndotl = jnp.where(blocked, 0.0, ndotl)

    lc = jnp.asarray(cfg.light_color, F32)
    rgb = albedo * (cfg.ambient + ndotl[..., None] * lc)
    return rgb, hit, pt, n


def scene_shade_arrays(scene: RTScene, cfg: RTConfig) -> dict:
    """The replicated per-scene arrays shade_hits consumes: per-prim
    packed attribute records [n0 n1 n2 | c0 c1 c2 | (uv0 uv1 uv2)] so
    shading costs one row gather per ray."""
    faces = np.asarray(scene.faces, np.int64)
    P = faces.shape[0]
    normals = np.asarray(scene.normals, np.float32)
    colors = np.asarray(scene.colors, np.float32)
    parts = [normals[faces].reshape(P, 9), colors[faces].reshape(P, 12)]
    if cfg.textured:
        parts.append(np.asarray(scene.uvs, np.float32)[faces]
                     .reshape(P, 6))
    scene_arrays = {"rec": jnp.asarray(np.concatenate(parts, axis=1))}
    if cfg.textured:
        scene_arrays["texture"] = jnp.asarray(scene.texture)
    return scene_arrays


def trace_rays(scene_arrays, cfg: RTConfig, closest, occluded,
               reflectivity: float, o, d):
    """Trace + shade one ray batch -> (R, 4) RGBA.  The per-batch body of
    render(), shared with the mesh-sharded path (parallel.ray_shard)."""
    prim, t, u, v = closest(o, d)
    rgb, hit, pt, n = shade_hits(scene_arrays, cfg, occluded,
                                 o, d, prim, t, u, v)

    # mirror bounces: active-mask iteration (divergence as predication)
    if cfg.bounces > 0 and reflectivity > 0:
        refl = F32(reflectivity)
        weight = jnp.where(hit, refl, 0.0)[..., None]
        cur_o, cur_d, cur_n = pt, d, n
        if cfg.compact_bounces and cfg.compact_stay:
            # Stay-compacted bounce loop: state lives in the compacted
            # order of the LATEST bounce; `orig` maps each slot back to
            # launch order and ONE final scatter restores it.  Replaces
            # the per-bounce unsort (4 row gathers + an
            # inverse-permutation scatter) with one packed row gather —
            # 1M-row gathers are row-count-bound, so gather COUNT is
            # the cost.  Per-ray arithmetic is identical: pure
            # scheduling.
            park_o = jnp.asarray([3e7, 3e7, 3e7], F32)
            park_d = jnp.asarray([0.57735, 0.57735, 0.57735], F32)
            bg3 = jnp.asarray(cfg.background[:3], F32)
            orig = jnp.arange(rgb.shape[0], dtype=I32)
            hitf = hit.astype(F32)[:, None]
            prev_live = None
            for b in range(cfg.bounces):
                rd = cur_d - 2.0 * jnp.sum(cur_d * cur_n, -1,
                                           keepdims=True) * cur_n
                ro = cur_o + cur_n * 1e-3
                active = weight[..., 0] > 0
                packed = jnp.concatenate(
                    [jnp.where(active[..., None], ro, park_o),
                     jnp.where(active[..., None], rd, park_d),
                     rgb, weight, hitf], axis=1)      # (R, 11)
                ladder = (cfg.bounce_width_ladder
                          if cfg.compact_method.startswith("argsort")
                          else 0)
                if b > 0 and ladder:
                    # Compaction ladder: bounce b's live rays all sit in
                    # bounce b-1's live prefix (hits ⊆ previous actives,
                    # which compaction moved to the front), so the
                    # argsort + packed gather only need the first
                    # R >> k rows — the stable sort gives the live rays
                    # the SAME order as a full-width sort (dead keys are
                    # all the max sentinel; only the dead tail's order
                    # differs, which nothing observes).
                    key = _compact_key(
                        active, ro, rd,
                        origin_major=cfg.compact_method == "argsort_om")

                    def compact_at(w):
                        def f(args):
                            pk, og = args
                            pw = jnp.argsort(key[:w], stable=True)
                            return (jnp.concatenate([pk[:w][pw], pk[w:]]),
                                    jnp.concatenate([og[:w][pw], og[w:]]))
                        return f

                    fc = compact_at(packed.shape[0])
                    for k in range(1, ladder + 1):
                        w = packed.shape[0] >> k
                        if w < 512:
                            break
                        fc = (lambda fw, ff, w=w: lambda args:
                              jax.lax.cond(prev_live <= w, fw, ff, args)
                              )(compact_at(w), fc)
                    pc, orig = fc((packed, orig))
                else:
                    perm, _ = _compact_perm(active, ro, rd,
                                            cfg.compact_method,
                                            want_inv=False)
                    pc = packed[perm]                 # ONE row gather
                    orig = orig[perm]
                prev_live = jnp.sum(active.astype(I32))
                ro_c, rd_c = pc[:, 0:3], pc[:, 3:6]
                rgb, weight, hitf = pc[:, 6:9], pc[:, 9:10], pc[:, 10:11]

                def run_at(w, R=rgb.shape[0]):
                    def f(args):
                        ro_s, rd_s = args[0][:w], args[1][:w]
                        p2, t2, u2, v2 = closest(ro_s, rd_s)
                        rgb2, hit2, pt2, n2 = shade_hits(
                            scene_arrays, cfg, occluded, ro_s, rd_s,
                            p2, t2, u2, v2)
                        pad = R - w
                        if pad:
                            z3 = jnp.zeros((pad, 3), F32)
                            rgb2 = jnp.concatenate([rgb2, z3])
                            hit2 = jnp.concatenate(
                                [hit2, jnp.zeros((pad,), bool)])
                            pt2 = jnp.concatenate([pt2, z3 + park_o])
                            n2 = jnp.concatenate(
                                [n2, z3 + jnp.asarray([0., 0., 1.], F32)])
                        return rgb2, hit2, pt2, n2
                    return f

                R = rgb.shape[0]
                if cfg.bounce_width_ladder:
                    live = jnp.sum(active.astype(I32))
                    f = run_at(R)
                    for k in range(1, cfg.bounce_width_ladder + 1):
                        w = R >> k
                        if w < 512:   # not worth a rung below one bundle
                            break
                        f = (lambda fw, ff, w=w: lambda args:
                             jax.lax.cond(live <= w, fw, ff, args)
                             )(run_at(w), f)
                else:
                    f = run_at(R)
                rgb2, hit2, pt2, n2 = f((ro_c, rd_c))
                contrib = jnp.where(hit2[..., None], rgb2, bg3)
                rgb = rgb * (1.0 - weight) + contrib * weight
                weight = weight * jnp.where(hit2, refl, 0.0)[..., None]
                cur_o, cur_d, cur_n = pt2, rd_c, n2
            out = jnp.concatenate([rgb, jnp.ones_like(rgb[..., :1])], -1)
            rgba = jnp.where(hitf > 0.5, out,
                             jnp.asarray(cfg.background, F32))
            return jnp.zeros_like(rgba).at[orig].set(
                rgba, unique_indices=True)
        for _ in range(cfg.bounces):
            rd = cur_d - 2.0 * jnp.sum(cur_d * cur_n, -1, keepdims=True) * cur_n
            ro = cur_o + cur_n * 1e-3
            if cfg.compact_bounces:
                # re-compaction between bounces: sort surviving rays to
                # the front BY (direction octant, origin Morton) — see
                # _compact_key — and park dead rays at a far origin.
                # Contiguous dead blocks leave the traversal at once,
                # coherent live blocks walk similar paths, and traversal
                # cost tracks the SURVIVING ray count, not the launch
                # width.  Shading (incl. the shadow launch)
                # runs in the compacted order too, so shadow bundles
                # inherit the same locality; outputs unsort at the end.
                active = weight[..., 0] > 0
                perm, inv_perm = _compact_perm(active, ro, rd,
                                               cfg.compact_method)
                # park beyond any scene, heading away: every slab/triangle
                # test fails with t_far < 0, so dead tiles skip wholesale
                park_o = jnp.asarray([3e7, 3e7, 3e7], F32)
                park_d = jnp.asarray([0.57735, 0.57735, 0.57735], F32)
                ro_c = jnp.where(active[..., None], ro, park_o)[perm]
                rd_c = jnp.where(active[..., None], rd, park_d)[perm]
                p2, t2, u2, v2 = closest(ro_c, rd_c)
                rgb2, hit2, pt2, n2 = shade_hits(
                    scene_arrays, cfg, occluded, ro_c, rd_c, p2, t2, u2, v2)
                rgb2, pt2, n2 = rgb2[inv_perm], pt2[inv_perm], n2[inv_perm]
                hit2 = hit2[inv_perm]
            else:
                p2, t2, u2, v2 = closest(ro, rd)
                rgb2, hit2, pt2, n2 = shade_hits(
                    scene_arrays, cfg, occluded, ro, rd, p2, t2, u2, v2)
            bg = jnp.asarray(cfg.background[:3], F32)
            contrib = jnp.where(hit2[..., None], rgb2, bg)
            rgb = rgb * (1.0 - weight) + contrib * weight
            weight = weight * jnp.where(hit2, refl, 0.0)[..., None]
            cur_o, cur_d, cur_n = pt2, rd, n2

    bg = jnp.asarray(cfg.background, F32)
    out = jnp.concatenate([rgb, jnp.ones_like(rgb[..., :1])], -1)
    return jnp.where(hit[..., None], out, bg)


def make_frame_fn(scene: RTScene, cam: Camera, cfg: RTConfig):
    """Compile the whole frame into ONE jitted dispatch.

    Returns (frame, (o, d)): frame(o, d) -> (H, W, 4).  Eagerly composing
    the stages pays per-op dispatch latency.  Hold on to `frame` for
    animation/bench loops; render() rebuilds (and retraces) it every
    call.
    """
    from . import wavefront

    scene = scene.finalize()
    scene_arrays = scene_shade_arrays(scene, cfg)
    closest, occluded = make_intersectors(scene, cfg)
    o, d = camera_rays(cam, cfg.width, cfg.height)

    # pixel-tile ray ordering (static permutation) makes every kernel ray
    # block a compact screen tile, so the lanes of a warp walk similar
    # paths through the tree; unsort only the final image
    inv_j = None
    if resolve_engine(cfg) == "kernel":
        perm, inv = wavefront.tile_order_perm(cfg.width, cfg.height, 32)
        o, d = o[perm], d[perm]
        inv_j = jnp.asarray(inv)

    import jax

    @jax.jit
    def frame(o, d):
        img = trace_rays(scene_arrays, cfg, closest, occluded,
                         scene.reflectivity, o, d)
        if inv_j is not None:
            img = img[inv_j]
        return img.reshape(cfg.height, cfg.width, 4)

    return frame, (o, d)


def render(scene: RTScene, cam: Camera, cfg: RTConfig):
    """Full RT render -> (H, W, 4) float32 image (row 0 = bottom)."""
    frame, (o, d) = make_frame_fn(scene, cam, cfg)
    return frame(o, d)
