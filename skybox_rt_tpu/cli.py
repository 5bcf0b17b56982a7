"""Framework CLI — the simx/draw3d host analog (SURVEY §2.4 S12, §2.2 H6).

The reference ships a standalone simulator CLI (sim/simx/main.cpp:77-126)
and per-app hosts with getopt flags (tests/regression/draw3d/main.cpp:84-136:
-t trace -w width -h height -o output.png -r reference.png -k tilelogsize).
This module provides the same surface:

  python -m skybox_rt_tpu render -t tekkaman -w 256 -H 256 -o out.png \
      [-r golden.png] [-k 5] [--mode immediate|deferred] [--perf]
  python -m skybox_rt_tpu bench  [-t tekkaman] [-w 1024] [--frames 20]
  python -m skybox_rt_tpu info

`render` prints the reference's frame report ("Total elapsed time ..."
draw3d/main.cpp:360-378) and PASSED/FAILED on golden compare (main.cpp:505-514).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_render(args) -> int:
    import jax

    from .core import constants as C
    from .geom import cgltrace
    from .ref import driver
    from .runtime.device import Device
    from .runtime import perf as perf_mod
    from .utils import image

    path = args.trace if args.trace.endswith(".cgltrace") \
        else cgltrace.trace_path(args.trace)
    trace = cgltrace.load_cached(path)

    dev = Device()
    stats = driver.FrameStats()

    t0 = time.perf_counter()
    fb = driver.render_trace(
        trace, args.width, args.height,
        tile_logsize=args.tile_logsize, stats=stats, mode=args.mode,
        measure_traffic=args.perf)
    jax.block_until_ready(fb)
    elapsed_ms = (time.perf_counter() - t0) * 1e3

    # the reference's per-frame report (draw3d/main.cpp:360-378);
    # cycles/instrs don't exist under XLA, so report draw/prim/tile counts
    print(f"Total elapsed time: {elapsed_ms:.0f} ms")
    print(f"drawcalls={stats.drawcalls}, prims={stats.prims_binned}, "
          f"tiles={stats.tiles}")

    if args.perf:
        dev.perf.count("drawcalls", stats.drawcalls)
        dev.perf.count("prims_binned", stats.prims_binned)
        dev.perf.count("tiles", stats.tiles)
        for k, v in stats.traffic.items():
            if k in ("tiles", "prims"):      # already counted above
                continue
            dev.perf.count(k, int(v))
        dev.perf.add_time("frame_ms", elapsed_ms)
        dev.dump_perf()

        # roofline placement of the compiled single-dispatch frame
        # against the device's published peaks — bytes from the MEASURED
        # per-unit traffic model above (≅ the reference's per-unit
        # counter report; XLA's own bytes-accessed is a pre-fusion upper
        # bound, perf.roofline_of_fn caveat)
        try:
            peaks = perf_mod.device_peaks(jax.devices()[0].device_kind)
            mode = args.mode if args.mode != "immediate" else "deferred"
            frame, arrays = driver.compile_frame(
                trace, args.width, args.height,
                tile_logsize=args.tile_logsize, mode=mode)
            out = jax.block_until_ready(frame(arrays))
            t0 = time.perf_counter()
            n = 10
            for _ in range(n):
                out = frame(arrays)
            jax.block_until_ready(out)
            dt = (time.perf_counter() - t0) / n
            r = perf_mod.roofline_from_traffic(stats.traffic, seconds=dt,
                                               peaks=peaks)
            print(perf_mod.format_roofline_table(
                {f"frame[{mode}] {args.width}x{args.height}": r}))
        except Exception as e:   # roofline is advisory, never fatal
            print(f"roofline unavailable: {type(e).__name__}: {e}")

    if args.output:
        image.save_framebuffer_png(args.output, fb)

    if args.reference:
        errors, maxdiff = image.compare_to_golden(fb, args.reference)
        if errors == 0:
            print("PASSED!")
            return 0
        print(f"FAILED! - {errors} errors (max channel diff {maxdiff})")
        return 1
    return 0


def _cmd_bench(args) -> int:
    import jax

    from .geom import cgltrace
    from .ref import driver

    trace = cgltrace.load_cached(cgltrace.trace_path(args.trace))
    frame, arrays = driver.compile_frame(trace, args.width, args.width,
                                         tile_logsize=args.tile_logsize,
                                         mode=args.mode)
    fb = frame(arrays)
    jax.block_until_ready(fb)

    t0 = time.perf_counter()
    for _ in range(args.frames):
        fb = frame(arrays)
    jax.block_until_ready(fb)
    elapsed = time.perf_counter() - t0

    pixels = args.width * args.width * len(arrays) * args.frames
    mpix_s = pixels / elapsed / 1e6
    print(json.dumps({
        "scene": args.trace, "size": args.width, "frames": args.frames,
        "tile_logsize": args.tile_logsize, "mode": args.mode,
        "ms_per_frame": elapsed / args.frames * 1e3,
        "mpix_s": mpix_s,
    }))
    return 0


def _cmd_info(args) -> int:
    from .runtime.device import Device

    caps = Device().caps
    print(json.dumps({
        "platform": caps.platform,
        "num_devices": caps.num_devices,
        "device_kind": caps.device_kind,
        "memory_per_device": caps.memory_per_device,
        "isa": {  # VX_ISA_EXT_RASTER/TEX/OM analog (vortex.h:44-52)
            "raster": caps.has_raster, "tex": caps.has_tex,
            "om": caps.has_om, "rt": caps.has_rt,
        },
    }))
    return 0


def tracer_engines() -> tuple:
    from .rt import tracer
    return tracer.ENGINES


def build_parser() -> argparse.ArgumentParser:
    from .core import constants as C
    p = argparse.ArgumentParser(prog="skybox_rt_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a cgltrace scene")
    r.add_argument("-t", "--trace", required=True,
                   help="scene name (tekkaman) or path to .cgltrace")
    r.add_argument("-w", "--width", type=int, default=256)
    r.add_argument("-H", "--height", type=int, default=256)
    r.add_argument("-o", "--output", default=None, help="output PNG")
    r.add_argument("-r", "--reference", default=None,
                   help="golden PNG to compare against (tolerance 1)")
    r.add_argument("-k", "--tile-logsize", type=int, default=5)
    r.add_argument("--mode", choices=("immediate", "deferred"),
                   default="deferred",
                   help="deferred is the exact-equivalent fast path; "
                        "immediate is the oracle")
    r.add_argument("--perf", action="store_true",
                   help="dump perf counters (vx_dump_perf analog)")
    r.set_defaults(fn=_cmd_render)

    b = sub.add_parser("bench", help="throughput benchmark")
    b.add_argument("-t", "--trace", default="tekkaman")
    b.add_argument("-w", "--width", type=int, default=512)
    b.add_argument("--frames", type=int, default=20)
    b.add_argument("--tile-logsize", type=int,
                   default=C.RASTER_TILE_LOGSIZE, choices=range(3, 8),
                   help="raster tile log2 size (the reference sweep's "
                        "rtile axis, perf/graphics/run.sh)")
    b.add_argument("--mode", default="deferred",
                   choices=("immediate", "deferred"))
    b.set_defaults(fn=_cmd_bench)

    i = sub.add_parser("info", help="device capabilities (vx_dev_caps)")
    i.set_defaults(fn=_cmd_info)

    s = sub.add_parser("scale", help="mesh scaling-efficiency sweep "
                                     "(perf/graphics/run.sh analog)")
    s.add_argument("-w", "--width", type=int, default=256)
    s.add_argument("--iters", type=int, default=10)
    s.add_argument("--artifact", default=None, metavar="PATH",
                   help="also append driver-shaped JSON lines "
                        "({metric, value, unit, vs_baseline} per mesh "
                        "size) so a multi-chip run records turnkey")
    s.set_defaults(fn=_cmd_scale)

    t = sub.add_parser("rt", help="ray-trace a procedural scene")
    t.add_argument("-w", "--width", type=int, default=256)
    t.add_argument("-H", "--height", type=int, default=256)
    t.add_argument("-o", "--output", default="rt_out.png")
    t.add_argument("--scene", choices=("sphere", "sphere-plane",
                                       "sphere-field"),
                   default="sphere-plane",
                   help="sphere-field = the north-star 185k-tri "
                        "multi-object scene (BASELINE.md scaling row)")
    t.add_argument("--bounces", type=int, default=1)
    t.add_argument("--no-shadows", action="store_true")
    t.add_argument("--engine", choices=("auto",) + tracer_engines(),
                   default="auto",
                   help="auto = the device's route (the GPU traversal "
                        "kernel on a GPU, the XLA walk elsewhere)")
    t.set_defaults(fn=_cmd_rt)

    f = sub.add_parser("fit", help="inverse-rendering demo: recover vertex "
                                   "colors/positions from a target image")
    f.add_argument("-w", "--width", type=int, default=64)
    f.add_argument("--steps", type=int, default=200)
    f.add_argument("--lr", type=float, default=2e-2)
    f.add_argument("-o", "--out-prefix", default="fit")
    f.add_argument("--checkpoint-dir", default=None)
    f.set_defaults(fn=_cmd_fit)
    return p


def _cmd_fit(args) -> int:
    import jax.numpy as jnp
    import numpy as np
    from PIL import Image

    from .diff import binning as dbin
    from .diff import optim, pipeline
    from .models import scenes

    size = args.width
    params, indices = scenes.triangle()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    cfg = pipeline.DiffRenderConfig(width=size, height=size, tile_logsize=4)
    static = {k: jnp.asarray(v) for k, v in dbin.bin_static(
        np.asarray(params["pos"]), indices, size, size,
        tile_logsize=4).items()}

    # ground truth: shifted + recolored triangle
    truth = dict(params)
    truth["color"] = params["color"] * jnp.asarray([[0.2, 0.9, 0.4, 1.0]])
    target = pipeline.render_cropped(truth, static, cfg)

    start = {"color": params["color"] * 0.5}

    def loss_fn(p, static, target):
        img = pipeline.render_cropped({**params, **p}, static, cfg)
        return jnp.mean((img - target) ** 2)

    def save(img, name):
        arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(arr[::-1], "RGBA").save(f"{args.out_prefix}_{name}.png")

    save(target, "target")
    save(pipeline.render_cropped({**params, **start}, static, cfg), "before")

    res = optim.fit(loss_fn, start, static, target, steps=args.steps,
                    lr=args.lr, checkpoint_dir=args.checkpoint_dir)
    save(pipeline.render_cropped({**params, **res.params}, static, cfg),
         "after")
    print(json.dumps({
        "loss_first": res.losses[0] if res.losses else None,
        "loss_last": res.losses[-1] if res.losses else None,
        "bad_steps": res.bad_steps,
        "resumed_from": res.resumed_from,
        "outputs": [f"{args.out_prefix}_{n}.png"
                    for n in ("target", "before", "after")],
    }))
    return 0


def _cmd_rt(args) -> int:
    import jax
    import numpy as np
    from PIL import Image

    from .models import scenes as scn
    from .rt import tracer

    if args.scene == "sphere-field":
        verts, faces, colors = scn.sphere_field(copies=9, subdiv=5)
        scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                               reflectivity=0.35)
        cam = tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                            fov_y_deg=55.0)
        return _run_rt(args, scene, cam)
    verts, faces = scn.icosphere(subdiv=3)
    colors = np.tile(np.array([[0.8, 0.3, 0.25, 1.0]], np.float32),
                     (verts.shape[0], 1))
    if args.scene == "sphere-plane":
        pv, pf = scn.mesh_grid_plane(n=8, y=-1.0, half=4.0)
        pc = np.tile(np.array([[0.55, 0.6, 0.65, 1.0]], np.float32),
                     (pv.shape[0], 1))
        faces = np.concatenate([faces, pf + verts.shape[0]])
        verts = np.concatenate([verts, pv])
        colors = np.concatenate([colors, pc])

    scene = tracer.RTScene(verts=verts.astype(np.float32),
                           faces=faces.astype(np.int32),
                           colors=colors, reflectivity=0.3)
    cam = tracer.Camera(eye=(0.0, 0.6, 3.2), look_at=(0.0, -0.1, 0.0))
    return _run_rt(args, scene, cam)


def _run_rt(args, scene, cam) -> int:
    import jax
    import numpy as np
    from PIL import Image

    from .rt import tracer

    cfg = tracer.RTConfig(width=args.width, height=args.height,
                          bounces=args.bounces,
                          shadows=not args.no_shadows, engine=args.engine,
                          background=(0.05, 0.07, 0.1, 1.0))
    t0 = time.perf_counter()
    frame, (o, d) = tracer.make_frame_fn(scene, cam, cfg)
    img = frame(o, d)
    jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    img = frame(o, d)             # steady state: one jitted dispatch
    jax.block_until_ready(img)
    dt2 = time.perf_counter() - t0 - dt
    rays = args.width * args.height * (
        1 + (1 if cfg.shadows else 0) + args.bounces)
    print(f"rendered in {dt*1e3:.1f} ms (incl. compile); steady-state "
          f"{dt2*1e3:.1f} ms/frame, ~{rays/1e6:.2f}M rays/frame")

    out = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(out[::-1], "RGBA").save(args.output)
    print(f"wrote {args.output}")
    return 0


def _cmd_scale(args) -> int:
    from .parallel import scaling

    results = scaling.measure(size=args.width, iters=args.iters)
    print(json.dumps({str(k): v for k, v in results.items()}, indent=1))
    if args.artifact:
        # BENCH_r*.json-shaped lines (one per mesh size): vs_baseline is
        # scaling efficiency vs the 1-device arm — the north-star >=0.8
        # acceptance reads straight off the artifact
        with open(args.artifact, "a") as f:
            for n, r in results.items():
                f.write(json.dumps({
                    "metric": f"train_step_{args.width}x{args.width}"
                              f"_mesh{n}",
                    "value": round(r["ms"], 3),
                    "unit": "ms/step",
                    "vs_baseline": round(r["efficiency"], 3),
                }) + "\n")
        print(f"wrote {args.artifact}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
