"""Standalone per-layer timings on one GPU, at chip_smoke.py's sizes.

    python scripts/layer_probe.py [--out FILE]

Sections (each line of output is one JSON object naming the card):

  traverse  the north-star scene (sphere_field(copies=9, subdiv=5), 1024^2
            camera): the GPU kernel (ops/traverse.py) against the XLA
            stackless walk (rt/bvh.py) on three ray sets —
              primary  closest hit of every camera ray
              shadow   any hit toward the light from every primary hit
              second   "closest after" the primary hit, every camera ray
            then the kernel's closest and any modes at 32/64/128 rays per
            program (one warp per 32 rays), timed interleaved
  raster    per draw of chip_smoke.py's 1024^2 trace: the whole deferred
            draw against its visibility pass alone, from cleared buffers
  diff      the 512^2 hard train step against its visibility pass alone

Times are medians of several calls after a first (compiling) call, each
ended with jax.block_until_ready.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def emit(out, **fields):
    line = json.dumps({**fields, "card": chip_smoke.card()})
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def ms(fn, *args, reps=7):
    return chip_smoke.timed(fn, *args, reps=reps)[1]


def probe_traverse(out):
    import jax
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import traverse
    from skybox_rt_tpu.rt import bvh as bvh_mod
    from skybox_rt_tpu.rt import intersect, tracer

    scene, cam, cfg, _ = chip_smoke._northstar()
    _, (o, d) = tracer.make_frame_fn(scene, cam, cfg)
    tri = intersect.triangle_arrays(jnp.asarray(scene.verts),
                                    jnp.asarray(scene.faces))
    sl = scene.bvh.as_stackless_arrays()
    leaf = scene.bvh.leaf_size
    prep = traverse.prepare_scene(sl, tri, leaf)

    k_closest = jax.jit(lambda o, d: traverse.traverse(prep, o, d))
    x_closest = jax.jit(lambda o, d: bvh_mod.closest_hit_stackless(
        sl, tri, o, d, leaf_size=leaf))
    prim, t, _, _ = k_closest(o, d)
    hit = np.asarray(prim) >= 0
    light = np.asarray(cfg.light_dir, np.float32)
    light /= np.linalg.norm(light)
    pts = (np.asarray(o) + np.asarray(t)[:, None] * np.asarray(d))[hit]
    so = jnp.asarray(pts + 1e-3 * light)
    sd = jnp.asarray(np.broadcast_to(light, pts.shape).copy())

    k_any = jax.jit(lambda o, d: traverse.traverse(
        prep, o, d, mode="any", t_max=1e30))
    x_any = jax.jit(lambda o, d: bvh_mod.any_hit_stackless(
        sl, tri, o, d, t_max=1e30, leaf_size=leaf))
    k_after = jax.jit(lambda o, d, tl, pl: traverse.traverse(
        prep, o, d, mode="after", t_lo=tl, prim_lo=pl))
    x_after = jax.jit(lambda o, d, tl, pl: bvh_mod.closest_hit_stackless(
        sl, tri, o, d, leaf_size=leaf, t_lo=tl, p_lo=pl))

    rows = [
        ("primary", "closest", (o, d), k_closest, x_closest),
        ("shadow", "any", (so, sd), k_any, x_any),
        ("second", "after", (o, d, t, prim), k_after, x_after),
    ]
    for ray_set, mode, args, kf, xf in rows:
        emit(out, section="traverse", ray_set=ray_set, mode=mode,
             rays=int(args[0].shape[0]), triangles=int(scene.faces.shape[0]),
             kernel_ms=ms(kf, *args), xla_walk_ms=ms(xf, *args, reps=3))

    # rays per program: each variant is compiled with the module constants
    # set, then all are timed interleaved
    base = (traverse.BLOCK, traverse.NUM_WARPS)
    variants = {}
    for block in (32, 64, 128):
        traverse.BLOCK, traverse.NUM_WARPS = block, block // 32
        traverse._traverse_call.clear_cache()
        fc = jax.jit(lambda o, d: traverse.traverse(prep, o, d)[0])
        fa = jax.jit(lambda o, d: traverse.traverse(
            prep, o, d, mode="any", t_max=1e30))
        jax.block_until_ready((fc(o, d), fa(so, sd)))
        variants[block] = (fc, fa)
    traverse.BLOCK, traverse.NUM_WARPS = base
    traverse._traverse_call.clear_cache()
    times = {b: ([], []) for b in variants}
    for _ in range(3):
        for b, (fc, fa) in variants.items():
            times[b][0].append(ms(fc, o, d, reps=5))
            times[b][1].append(ms(fa, so, sd, reps=5))
    for b, (tc, ta) in times.items():
        emit(out, section="traverse_block", rays_per_program=b,
             num_warps=b // 32, primary_closest_ms=tc, shadow_any_ms=ta)


def probe_raster(out):
    import jax
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import deferred
    from skybox_rt_tpu.ref import driver

    S = chip_smoke.RASTER_SIZE
    draws = driver.prepare_drawcalls(chip_smoke.make_raster_trace(), S, S)
    for i, (rs, texels, b) in enumerate(draws):
        ts = 1 << b.tile_logsize
        Hp, Wp = -(-S // ts) * ts, -(-S // ts) * ts
        fbc = jnp.full((Hp, Wp), driver.CLEAR_COLOR, jnp.uint32)
        fbd = jnp.full((Hp, Wp), driver.CLEAR_DEPTH, jnp.uint32)
        info = {}
        deferred.render_drawcall(rs, texels, b, fbc, fbd, info=info)
        k = info["blend_k"]
        e, a = jnp.asarray(b.edges), jnp.asarray(b.attribs)
        tp, txy = jnp.asarray(b.tile_pids), jnp.asarray(b.tile_xy)

        def draw(fbc, fbd):
            return deferred._render_deferred_jit(
                rs, texels, e, a, a[:, 0], tp, txy, fbc, fbd,
                b.tile_logsize, blend_slots=k)[:2]

        @jax.jit
        def vis(fbd):
            t = fbd.reshape(Hp // ts, ts, Wp // ts, ts).transpose(0, 2, 1, 3)
            return deferred._visibility_tiles(
                rs, e, a[:, 0], tp, txy, t[txy[:, 1], txy[:, 0]],
                b.tile_logsize, blend_slots=k)

        emit(out, section="raster", draw=i, blend_slots=k,
             triangles=int(b.edges.shape[0]), tiles=int(tp.shape[0]),
             draw_ms=ms(draw, fbc, fbd), visibility_ms=ms(vis, fbd))


def probe_diff(out):
    import jax

    from skybox_rt_tpu.diff import pipeline

    S = chip_smoke.TRAIN_SIZE
    params, truth, static, cfg, jnp = chip_smoke.train_setup(S, "hard")
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = {k: jnp.asarray(v) for k, v in static.items()}
    ts = 1 << cfg.tile_logsize
    target = jax.jit(lambda p, s: pipeline.render_deferred(p, s, cfg)[0])(
        {k: jnp.asarray(v) for k, v in truth.items()}, st)

    def loss(p, s, target):
        return jnp.mean((pipeline.render_deferred(p, s, cfg)[0] - target)
                        ** 2)

    step = jax.jit(jax.value_and_grad(loss))
    vis = jax.jit(lambda p, s: pipeline.visibility_slots(
        pipeline.prim_setup(p, s["indices"], cfg), s["tile_pids"],
        s["tile_xy"] * ts, cfg)[0])
    emit(out, section="diff", size=S, mode="hard",
         step_ms=ms(step, p, st, target, reps=9),
         visibility_ms=ms(vis, p, st, reps=9))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--sections", default="traverse,raster,diff")
    args = ap.parse_args()
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"no GPU: JAX runs on {jax.devices()[0].platform}")
        return 1
    probes = {"traverse": probe_traverse, "raster": probe_raster,
              "diff": probe_diff}
    for name in args.sections.split(","):
        probes[name](args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
