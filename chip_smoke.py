"""Smoke run of the three render paths on one NVIDIA GPU.

    python chip_smoke.py            # one card: the phases below
    python chip_smoke.py --four     # four cards: the sharded paths only

Phases (one card), each compared with its plain reference on the card:

  gpu_tests  the card-only tests (tests/test_gpu.py) in a subprocess,
             before this process touches JAX
  rt         the north-star RT frame: sphere_field(copies=9, subdiv=5)
             (184k sphere triangles + ground), 1024^2, 2 bounces,
             shadows, through rt.tracer.make_frame_fn on the device's
             route (the GPU traversal kernel), against the same frame on
             engine "bvh" (the XLA stackless walk); primary hits of 4096
             rays against rt.intersect's brute force
  raster     a 1024^2 exact-int frame built from procedural geometry (one
             opaque, depth-tested, textured drawcall and one alpha-blended
             drawcall) through ref.driver.compile_frame(mode="deferred"),
             bit-exact against mode="immediate"
  train      the 512^2 inverse-rendering step (diff.pipeline.render_deferred
             under jax.value_and_grad) in hard and alpha mode against the
             same step on the host CPU device, then a few diff.optim.fit
             steps whose loss must fall

With --four: the ray-sharded north-star frame (parallel.ray_shard) and the
tile-sharded 512^2 train step (parallel.tile_shard) over four cards, each
against one card.

Exits non-zero when JAX finds no GPU, when the RT frame resolves to any
route but the GPU kernel, or when any phase fails.  The last line of
standard output is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
#: phase sizes (the sizes users run; a rehearsal may shrink them)
RT_SIZE = 1024
FIELD = dict(copies=9, subdiv=5)
RASTER_SIZE = 1024
TRAIN_SIZE = 512


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except OSError:
        return "nvidia-smi unavailable"
    return out.splitlines()[0] if out else "no GPU listed by nvidia-smi"


class PhaseFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def timed(fn, *args, reps: int = 7):
    """(first-call seconds incl. compile, median steady ms, output)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return compile_s, float(np.median(ts)), out


def report(phase: str, ctx: dict, **fields) -> None:
    fields = {"phase": phase, **fields, "card": ctx["card"],
              "matmul_precision": ctx["precision"]}
    log("  " + json.dumps(fields))


# ---------------------------------------------------------------------------
# phase 0: card-only tests, in a subprocess, before this process uses JAX
# ---------------------------------------------------------------------------

def phase_gpu_tests(ctx: dict) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        xml_path = os.path.join(tmp, "gpu_tests.xml")
        env = dict(os.environ, SKYBOX_TEST_PLATFORM="cuda")
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
             "-p", "no:cacheprovider", f"--junitxml={xml_path}",
             "tests/test_gpu.py"],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=900)
        log(proc.stdout.strip()[-2000:])
        check(os.path.exists(xml_path),
              f"pytest wrote no report (exit {proc.returncode}): "
              f"{proc.stderr.strip()[-500:]}")
        suite = ET.parse(xml_path).getroot().find("testsuite")
        counts = {k: int(suite.get(k)) for k in
                  ("tests", "failures", "errors", "skipped")}
    report("gpu_tests", ctx, compared="tests/test_gpu.py (kernel compiled "
           "for the card vs the XLA stackless walk)", **counts,
           exit_code=proc.returncode)
    check(proc.returncode == 0 and counts["tests"] > 0
          and counts["skipped"] == 0, f"card-only tests: {counts}")


# ---------------------------------------------------------------------------
# phase rt: the north-star frame
# ---------------------------------------------------------------------------

def _northstar():
    from skybox_rt_tpu.models import scenes
    from skybox_rt_tpu.rt import tracer

    verts, faces, colors = scenes.sphere_field(**FIELD)
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                           reflectivity=0.35)
    t0 = time.perf_counter()
    scene.finalize()
    build_s = time.perf_counter() - t0
    cam = tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                        fov_y_deg=55.0)
    cfg = tracer.RTConfig(width=RT_SIZE, height=RT_SIZE, bounces=2,
                          shadows=True)
    return scene, cam, cfg, build_s


#: image tolerance of kernel vs "bvh" frames: both walks run the same
#: arithmetic in the same (t, prim) order, so pixels agree to float
#: contraction noise; at most this fraction of pixels may differ by more
#: than PIXEL_ATOL (a near-tie ray may pick the other of two triangles)
PIXEL_ATOL = 1e-4
PIXEL_FRAC = 1e-5


def phase_rt(ctx: dict) -> None:
    import jax
    import jax.numpy as jnp

    from skybox_rt_tpu.ops import traverse
    from skybox_rt_tpu.rt import intersect, tracer

    scene, cam, cfg, build_s = _northstar()
    engine = tracer.resolve_engine(cfg)
    log(f"  rt route: {engine} (BVH build {build_s:.2f} s on the host, "
        f"{scene.faces.shape[0]} triangles)")
    check(engine == "kernel",
          f"the RT frame resolved to {engine!r}, not the GPU kernel")

    frame_k, (o, d) = tracer.make_frame_fn(scene, cam, cfg)
    ck, mk, img_k = timed(frame_k, o, d, reps=7)
    cfg_b = dataclasses.replace(cfg, engine="bvh")
    frame_b, (ob, db) = tracer.make_frame_fn(scene, cam, cfg_b)
    cb, mb, img_b = timed(frame_b, ob, db, reps=5)
    img_k, img_b = np.asarray(img_k), np.asarray(img_b)
    check(img_k.shape == (RT_SIZE, RT_SIZE, 4)
          and np.isfinite(img_k).all(),
          "kernel frame is not a finite (H, W, 4) image")
    diff = np.abs(img_k - img_b).max(-1)
    frac = float((diff > PIXEL_ATOL).mean())
    rays = cfg.width * cfg.height * (2 + 2 * cfg.bounces)
    report("rt_frame", ctx,
           compared=f"kernel frame vs engine 'bvh' frame, {RT_SIZE}^2, "
                    "2 bounces, shadows",
           tolerance=f"|diff| <= {PIXEL_ATOL} on all but "
                     f"{PIXEL_FRAC:.0e} of pixels",
           max_abs_err=float(diff.max()), frac_pixels_over_atol=frac,
           kernel_compile_s=round(ck, 3), kernel_ms=mk,
           bvh_compile_s=round(cb, 3), bvh_ms=mb,
           kernel_mrays_s=rays / mk / 1e3)
    check(frac <= PIXEL_FRAC, f"kernel vs bvh frame: {frac} of pixels "
          f"differ by more than {PIXEL_ATOL}")

    # primary hits of a 4096-ray subset against brute force (all-pairs
    # over 185k triangles, chunked)
    tri = intersect.triangle_arrays(jnp.asarray(scene.verts),
                                    jnp.asarray(scene.faces))
    prep = traverse.prepare_scene(scene.bvh.as_stackless_arrays(), tri,
                                  scene.bvh.leaf_size)
    sub = np.linspace(0, o.shape[0] - 1, 4096).astype(np.int64)
    o_s, d_s = o[sub], d[sub]
    kp, kt, _, _ = jax.jit(lambda o, d: traverse.traverse(prep, o, d))(
        o_s, d_s)

    def brute(o, d):
        def one(od):
            return intersect.closest_hit_bruteforce(od[0], od[1], *tri)[:2]
        p, t = jax.lax.map(one, (o.reshape(-1, 64, 3),
                                 d.reshape(-1, 64, 3)))
        return p.reshape(-1), t.reshape(-1)

    bp, bt = jax.jit(brute)(o_s, d_s)
    kp, kt, bp, bt = map(np.asarray, (kp, kt, bp, bt))
    hit = bp >= 0
    mism = int((kp != bp).sum())
    t_err = float(np.abs(kt[hit] - bt[hit]).max() / max(
        np.abs(bt[hit]).max(), 1e-30)) if hit.any() else 0.0
    report("rt_primary_bruteforce", ctx,
           compared="kernel closest hit vs intersect.closest_hit_bruteforce"
                    " on 4096 primary rays",
           tolerance="prim ids equal on every ray (same MT formula; "
                     "lexicographic (t, prim) = argmin's lowest-index "
                     "rule); t within rtol 1e-5",
           prim_mismatches=mism, hits=int(hit.sum()),
           max_rel_t_err=t_err)
    check(mism == 0 and t_err <= 1e-5,
          f"kernel vs brute force: {mism} prim mismatches, t err {t_err}")


# ---------------------------------------------------------------------------
# phase raster: the exact-int frame
# ---------------------------------------------------------------------------

def make_raster_trace(seed: int = 0):
    """A two-drawcall CGLTrace made from a seed: an opaque, depth-tested,
    textured icosphere and an alpha-blended sphere in front of it."""
    from skybox_rt_tpu.core import constants as C
    from skybox_rt_tpu.geom import cgltrace
    from skybox_rt_tpu.models import scenes
    from skybox_rt_tpu.texture import convert

    rng = np.random.default_rng(seed)

    def states(**kw):
        base = dict(
            color_enabled=True, color_writemask=0xFFFFFFFF,
            depth_test=True, depth_writemask=1,
            depth_func=C.CGL_COMPARE_LESS, stencil_test=False,
            stencil_func=C.CGL_COMPARE_ALWAYS, stencil_zpass=0,
            stencil_zfail=0, stencil_fail=0, stencil_ref=0,
            stencil_mask=0xFF, stencil_writemask=0xFF,
            texture_enabled=False, texture_envmode=C.CGL_ENVMODE_MODULATE,
            texture_minfilter=C.CGL_FILTER_LINEAR,
            texture_magfilter=C.CGL_FILTER_LINEAR,
            texture_addressU=C.CGL_ADDRESS_WRAP,
            texture_addressV=C.CGL_ADDRESS_WRAP,
            blend_enabled=False, blend_src=C.CGL_BLEND_ONE,
            blend_dst=C.CGL_BLEND_ZERO)
        base.update(kw)
        return cgltrace.RenderStates(**base)

    def sphere(subdiv, scale, center, alpha):
        v, f = scenes.icosphere(subdiv=subdiv)
        pos = np.concatenate([v * scale[None] + center[None],
                              np.ones((v.shape[0], 1))], 1)
        col = np.concatenate([rng.uniform(0.3, 1.0, (v.shape[0], 3)),
                              np.full((v.shape[0], 1), alpha)], 1)
        uv = np.stack([0.5 + np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi),
                       0.5 + np.arcsin(np.clip(v[:, 1], -1, 1)) / np.pi],
                      -1)
        return (pos.astype(np.float32), col.astype(np.float32),
                uv.astype(np.float32), f.astype(np.int32))

    tex = scenes.checkerboard_texture(64, 8)
    rgba8 = np.clip(tex * 255.0 + 0.5, 0, 255).astype(np.uint8)
    pixels = convert.texels_to_bytes(
        convert.rgba_to_texels(rgba8, C.TEX_FORMAT_A8R8G8B8),
        C.TEX_FORMAT_A8R8G8B8)
    textures = {0: cgltrace.Texture(format=C.CGL_FORMAT_A8R8G8B8,
                                    width=64, height=64, pixels=pixels)}
    p0, c0, u0, f0 = sphere(4, np.array([0.8, 0.8, 0.4]),
                            np.array([-0.1, 0.0, 0.5]), 1.0)
    p1, c1, u1, f1 = sphere(3, np.array([0.45, 0.45, 0.2]),
                            np.array([0.3, 0.2, 0.25]), 0.5)
    draws = [
        cgltrace.DrawCall(states=states(texture_enabled=True),
                          texture_id=0, pos=p0, color=c0, texcoord=u0,
                          indices=f0, near=0.0, far=1.0),
        cgltrace.DrawCall(states=states(
            depth_writemask=0, blend_enabled=True,
            blend_src=C.CGL_BLEND_SRC_ALPHA,
            blend_dst=C.CGL_BLEND_ONE_MINUS_SRC_ALPHA),
            texture_id=-1, pos=p1, color=c1, texcoord=u1, indices=f1,
            near=0.0, far=1.0),
    ]
    return cgltrace.CGLTrace(drawcalls=draws, textures=textures)


def phase_raster(ctx: dict) -> None:
    from skybox_rt_tpu.geom import native
    from skybox_rt_tpu.ref import driver

    trace = make_raster_trace()
    binning = "native (native/binning.cpp)" if native.available() \
        else "numpy (geom/binning.py)"
    log(f"  binning engine: {binning}")
    S = RASTER_SIZE
    fd, ad = driver.compile_frame(trace, S, S, mode="deferred")
    cd, md, img_d = timed(fd, ad, reps=7)
    fi, ai = driver.compile_frame(trace, S, S, mode="immediate")
    ci, mi, img_i = timed(fi, ai, reps=3)
    img_d, img_i = np.asarray(img_d), np.asarray(img_i)
    differing = int((img_d != img_i).sum())
    covered = float((img_i != driver.CLEAR_COLOR).mean())
    report("raster_frame", ctx,
           compared=f"compile_frame deferred vs immediate, {S}^2, "
                    "textured opaque draw + alpha-blended draw",
           tolerance="bit-exact (uint32 ARGB)", differing_pixels=differing,
           covered_frac=covered, binning=binning,
           deferred_compile_s=round(cd, 3), deferred_ms=md,
           immediate_compile_s=round(ci, 3), immediate_ms=mi)
    check(img_d.shape == (S, S) and differing == 0 and covered > 0.1,
          f"raster: {differing} pixels differ (covered {covered})")


# ---------------------------------------------------------------------------
# phase train: the inverse-rendering step
# ---------------------------------------------------------------------------

def train_setup(size: int, mode: str, seed: int = 0):
    """The bench fwd+bwd scene: icosphere subdiv 4, 64^2 texture; the
    target is the same mesh with shifted colors."""
    import jax.numpy as jnp

    from skybox_rt_tpu.diff import binning as dbin
    from skybox_rt_tpu.diff import pipeline
    from skybox_rt_tpu.models import scenes

    verts, faces = scenes.icosphere(subdiv=4, radius=0.85)
    V = verts.shape[0]
    pos = np.concatenate([verts.astype(np.float32),
                          np.ones((V, 1), np.float32)], axis=1)
    pos[:, 2] = pos[:, 2] * 0.4 + 0.5
    rng = np.random.default_rng(seed)
    params = {
        "pos": pos,
        "color": rng.uniform(0.2, 1.0, (V, 4)).astype(np.float32),
        "uv": rng.uniform(0.0, 1.0, (V, 2)).astype(np.float32),
        "tex": scenes.checkerboard_texture(64, 8),
    }
    cfg = pipeline.DiffRenderConfig(
        width=size, height=size, tile_logsize=5, depth_test=True,
        textured=True, modulate=True, alpha_blend=(mode == "alpha"))
    static = dbin.bin_static(pos, faces.astype(np.int32), size, size,
                             tile_logsize=5)
    truth = dict(params, color=np.clip(params["color"][:, [1, 2, 0, 3]],
                                       0, 1))
    return params, truth, static, cfg, jnp


#: train-step comparison, GPU vs CPU.  Hard coverage and the depth test
#: are discontinuous: where an edge function or a depth lands within
#: rounding of zero or of a tie, a pixel may get another visibility winner.
#: Such pixels are found from the winners themselves
#: (diff.pipeline.visibility_slots): those that differ between the GPU and
#: the CPU, or between the CPU and the CPU with the vertex positions nudged
#: by one ulp, are counted and left out of the compared loss.  The GPU's
#: count is bounded by WINNER_FRAC.
#:
#: On the remaining pixels the gradients are still sensitive to rounding:
#: the bilinear filter of the checker texture is piecewise linear in the
#: per-vertex random UVs, so the position and UV gradients jump where a
#: rounding moves a sample across a texel center.  The limit for the loss
#: and every gradient is therefore the problem's own sensitivity, measured
#: in the same run: the GPU may differ from the CPU by no more than the
#: median, over NUDGES seeded nudges, of what one ulp of the vertex
#: positions changes on the CPU.
WINNER_FRAC = 1e-3
NUDGES = 3


def _winner_image(steps, tile_xy, ts, shape):
    """(T, ts, ts) per-tile pixel mask -> the (Hp, Wp) image mask."""
    Hp, Wp = shape
    canvas = np.zeros((Hp // ts, Wp // ts, ts, ts), bool)
    xy = np.asarray(tile_xy)
    canvas[xy[:, 1], xy[:, 0]] = steps
    return canvas.transpose(0, 2, 1, 3).reshape(Hp, Wp)


def nudge_ulp(x, seed: int):
    """x with every element moved one float32 ulp up or down (seeded)."""
    x = np.asarray(x, np.float32)
    up = np.random.default_rng(seed).random(x.shape) < 0.5
    return np.nextafter(x, np.where(up, np.inf, -np.inf).astype(np.float32))


def _rel_errs(a, b):
    """{'loss': rel err, param: rel L2 err} of step result a vs b."""
    (la, ga), (lb, gb) = a, b
    out = {"loss": abs(float(la) - float(lb)) / max(abs(float(lb)), 1e-30)}
    for k in gb:
        x = np.asarray(ga[k], np.float64).ravel()
        y = np.asarray(gb[k], np.float64).ravel()
        out[k] = float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))
    return out


def phase_train(ctx: dict) -> None:
    import jax

    from skybox_rt_tpu.diff import optim, pipeline

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    for mode in ("hard", "alpha"):
        params, truth, static, cfg, jnp = train_setup(TRAIN_SIZE, mode)
        ts = 1 << cfg.tile_logsize
        put = (lambda tree, dev: jax.tree_util.tree_map(
            lambda x: jax.device_put(jnp.asarray(x), dev), tree))
        st_g, st_c = put(static, gpu), put(static, cpu)
        slots = 8 if mode == "hard" else pipeline.auto_slots(
            put(params, gpu), st_g, cfg)
        render = jax.jit(lambda p, s: pipeline.render_deferred(
            p, s, cfg, slots=slots)[0])
        winners = jax.jit(lambda p, s: pipeline.visibility_slots(
            pipeline.prim_setup(p, s["indices"], cfg), s["tile_pids"],
            s["tile_xy"] * ts, cfg, slots)[0])
        target = render(put(truth, gpu), st_g)
        target_c = jax.device_put(np.asarray(target), cpu)
        nudged = [dict(params, pos=nudge_ulp(params["pos"], seed))
                  for seed in range(1, NUDGES + 1)]
        w_c = np.asarray(winners(put(params, cpu), st_c))
        moved_g = (np.asarray(winners(put(params, gpu), st_g)) != w_c).any(-1)
        moved = moved_g.copy()
        for q in nudged:
            moved |= (np.asarray(winners(put(q, cpu), st_c)) != w_c).any(-1)
        img_shape = (render(put(params, gpu), st_g).shape[:2])
        moved_g = _winner_image(moved_g, static["tile_xy"], ts, img_shape)
        moved = _winner_image(moved, static["tile_xy"], ts, img_shape)
        keep = (~moved).astype(np.float32)[..., None]

        def loss_fn(p, s, target, keep):
            img, _ = pipeline.render_deferred(p, s, cfg, slots=slots)
            return jnp.mean(keep * (img - target) ** 2)

        step = jax.jit(jax.value_and_grad(loss_fn))
        keep_g, keep_c = jax.device_put(keep, gpu), jax.device_put(keep, cpu)
        cs, ms, res_g = timed(step, put(params, gpu), st_g, target, keep_g,
                              reps=9)
        res_c = step(put(params, cpu), st_c, target_c, keep_c)
        err = _rel_errs(res_g, res_c)
        witness = [_rel_errs(step(put(q, cpu), st_c, target_c, keep_c),
                             res_c) for q in nudged]
        limit = {k: float(np.median([w[k] for w in witness])) for k in err}
        # the same GPU step with every float32 product forced to HIGHEST:
        # any gap it closes would be a TF32 product left at its default
        with jax.default_matmul_precision("highest"):
            _, grads_h = jax.jit(jax.value_and_grad(loss_fn))(
                put(params, gpu), st_g, target, keep_g)
        tf32_gap = max(float(np.abs(np.asarray(grads_h[k])
                                    - np.asarray(res_g[1][k])).max())
                       for k in grads_h)
        loss_g = float(res_g[0])
        report(f"train_{mode}", ctx,
               compared="value_and_grad(render_deferred loss) on the GPU "
                        f"vs the host CPU device, {TRAIN_SIZE}^2, on the "
                        "pixels whose visibility winners agree",
               tolerance=f"pixels with other winners on the GPU <= "
                         f"{WINNER_FRAC:.0e} of the image; loss and each "
                         "gradient within the median change of "
                         f"{NUDGES} one-ulp position nudges on the CPU",
               slots=slots, winner_moved_pixels_gpu=int(moved_g.sum()),
               pixels_left_out=int(moved.sum()),
               loss=loss_g, rel_err=err, limit=limit,
               nudge_rel_err=witness,
               max_grad_change_under_highest=tf32_gap,
               step_compile_s=round(cs, 3),
               step_ms=ms)
        check(np.isfinite(loss_g) and moved_g.mean() <= WINNER_FRAC
              and all(err[k] <= limit[k] for k in err),
              f"train {mode}: {int(moved_g.sum())} pixels with other "
              f"winners, errors {err}, limits {limit}")

        # a few optimizer steps through the user entry point
        trainable = {"color": put(params, gpu)["color"]}
        fixed = {k: v for k, v in put(params, gpu).items()
                 if k != "color"}

        def fit_loss(p, s, target):
            return loss_fn({**fixed, **p}, s, target, 1.0)

        res = optim.fit(fit_loss, trainable, st_g, target, steps=6, lr=0.05)
        losses = [float(x) for x in res.losses]
        report(f"fit_{mode}", ctx, compared="diff.optim.fit, 6 adam steps "
               "on the vertex colors", losses=losses,
               bad_steps=res.bad_steps)
        check(len(losses) == 6 and np.isfinite(losses).all()
              and losses[-1] < losses[0] and res.bad_steps == 0,
              f"fit {mode}: losses {losses}")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four_rt(ctx: dict) -> None:
    import jax

    from skybox_rt_tpu.parallel import mesh as mesh_mod
    from skybox_rt_tpu.parallel import ray_shard
    from skybox_rt_tpu.rt import tracer

    scene, cam, cfg, _ = _northstar()
    check(tracer.resolve_engine(cfg) == "kernel", "RT route is not the "
          "GPU kernel")
    frame, (o, d) = tracer.make_frame_fn(scene, cam, cfg)
    c1, m1, one = timed(frame, o, d, reps=5)
    mesh = mesh_mod.make_mesh(4)
    # render_sharded traces and compiles its shard_map on every call (it
    # is not a compiled frame), so one call is timed, compile included
    t0 = time.perf_counter()
    four = jax.block_until_ready(
        ray_shard.render_sharded(scene, cam, cfg, mesh))
    first_s = time.perf_counter() - t0
    diff = np.abs(np.asarray(four) - np.asarray(one)).max(-1)
    frac = float((diff > PIXEL_ATOL).mean())
    report("four_rt_frame", ctx,
           compared="ray_shard.render_sharded over 4 cards vs the "
                    f"one-card frame, {RT_SIZE}^2, 2 bounces, shadows",
           tolerance=f"|diff| <= {PIXEL_ATOL} on all but {PIXEL_FRAC:.0e}"
                     " of pixels (per-ray results are independent of the "
                     "launch width)",
           max_abs_err=float(diff.max()), frac_pixels_over_atol=frac,
           one_card_compile_s=round(c1, 3), one_card_ms=m1,
           four_card_call_s_incl_compile=round(first_s, 3),
           devices=[str(x) for x in mesh.devices.ravel()])
    check(frac <= PIXEL_FRAC, f"four-card frame: {frac} of pixels differ")


#: parameter updates (the psum-reduced gradients at lr = 1), four cards vs
#: one, relative to the one-card update.  The psum adds four partial sums
#: in another order than one card's reduction, so the two differ by
#: float32 reassociation, which cancellation in the position gradient
#: amplifies.  The limit is SHARD_UPDATE_RTOL, or, where reordering the
#: tiles on one card (NUDGES seeded permutations, measured in the same
#: run) moves the update more, REASSOC_FACTOR times that median change.
#: A step that lost the psum (each card updating with its own tiles'
#: gradient) is off by O(1); the phase checks that such a step does fail
#: the limit.
SHARD_UPDATE_RTOL = 1e-5
REASSOC_FACTOR = 10
SHARD_LOSS_RTOL = 1e-5
TILE_KEYS = ("tile_pids", "tile_xy", "tile_valid")


def phase_four_train(ctx: dict) -> None:
    from skybox_rt_tpu.parallel import mesh as mesh_mod
    from skybox_rt_tpu.parallel import tile_shard

    params, truth, static, cfg, jnp = train_setup(TRAIN_SIZE, "hard")
    target_img = np.zeros((TRAIN_SIZE, TRAIN_SIZE, 4), np.float32)
    p = {k: jnp.asarray(v) for k, v in params.items()}

    def arrays_for(n, order=None):
        sharded = tile_shard.shard_tiles(static, n)
        if order is not None:
            sharded = dict(sharded, **{k: sharded[k][order]
                                       for k in TILE_KEYS})
        target = jnp.asarray(tile_shard.gather_target_tiles(
            target_img, sharded["tile_xy"], cfg.tile_logsize))
        return {k: jnp.asarray(v) for k, v in sharded.items()}, target

    def update(newp):
        return {k: np.asarray(p[k], np.float64) - np.asarray(newp[k],
                                                             np.float64)
                for k in p}

    def rel(u, ref):
        return {k: float(np.linalg.norm(u[k] - ref[k])
                         / max(np.linalg.norm(ref[k]), 1e-30)) for k in ref}

    out = {}
    for n in (1, 4):
        arrays, target = arrays_for(n)
        step = tile_shard.make_train_step(mesh_mod.make_mesh(n), cfg,
                                          lr=1.0)
        c, m, (newp, loss, _) = timed(step, p, arrays, target, reps=7)
        out[n] = (c, m, float(loss), update(newp), step)
    loss_err = abs(out[4][2] - out[1][2]) / max(abs(out[1][2]), 1e-30)
    uerr = rel(out[4][3], out[1][3])

    # reassociation witness: the one-card step over reordered tiles
    step1, T = out[1][4], static["tile_xy"].shape[0]
    reorder = []
    for seed in range(1, NUDGES + 1):
        order = np.random.default_rng(seed).permutation(T)
        newp, _, _ = step1(p, *arrays_for(1, order))
        reorder.append(rel(update(newp), out[1][3]))
    limit = {k: max(SHARD_UPDATE_RTOL, REASSOC_FACTOR * float(
        np.median([r[k] for r in reorder]))) for k in p}

    # missing-psum witness: one card's step on the first card's tiles only
    arrays, target = arrays_for(4)
    arrays["tile_valid"] = arrays["tile_valid"].at[
        arrays["tile_valid"].shape[0] // 4:].set(0.0)
    newp, _, _ = step1(p, arrays, target)
    werr = rel(update(newp), out[1][3])
    report("four_train_step", ctx,
           compared="tile_shard.make_train_step over 4 cards vs 1 card, "
                    f"{TRAIN_SIZE}^2 hard mode (loss and parameter update "
                    "at lr 1)",
           tolerance=f"loss rel <= {SHARD_LOSS_RTOL}; each parameter's "
                     f"update rel L2 within {SHARD_UPDATE_RTOL} of the "
                     f"one-card update, or {REASSOC_FACTOR}x the median "
                     f"change of {NUDGES} tile reorderings on one card if "
                     "larger; the update from one card's tiles only must "
                     "exceed it",
           loss=out[1][2], loss_rel_err=loss_err, update_rel_l2_err=uerr,
           limit=limit, reorder_rel_l2_err=reorder,
           no_psum_update_rel_l2_err=werr,
           one_card_compile_s=round(out[1][0], 3), one_card_ms=out[1][1],
           four_card_compile_s=round(out[4][0], 3), four_card_ms=out[4][1])
    check(loss_err <= SHARD_LOSS_RTOL
          and all(uerr[k] <= limit[k] for k in p),
          f"four-card train step: loss err {loss_err}, updates {uerr}, "
          f"limits {limit}")
    check(all(werr[k] > limit[k] for k in p),
          f"the limit does not catch a missing psum: {werr}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args()

    ctx = {"card": card()}
    log(f"card (name, power limit): {ctx['card']}")
    if not os.path.isdir(os.path.join(REPO, "skybox_rt_tpu")):
        log("chip_smoke.py must run from a checkout of the repository")
        return 2
    sys.path.insert(0, REPO)
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; d = jax.devices(); print(d); "
         "print(d[0].platform, len(d))"],
        capture_output=True, text=True, timeout=300)
    lines = probe.stdout.strip().splitlines()
    log(f"jax.devices(): {lines[0] if lines else probe.stderr[-500:]}")
    platform, count = (lines[-1].split() if len(lines) >= 2
                       else ("none", "0"))
    if platform != "gpu":
        log(f"no GPU: JAX runs on {platform}")
        return 1
    need = 4 if args.four else 1
    if int(count) < need:
        log(f"needs {need} GPUs, JAX sees {count}")
        return 1

    try:
        if not args.four:
            log("phase gpu_tests")
            ctx["precision"] = "per test"
            phase_gpu_tests(ctx)

        import jax
        # every float32 product on these paths sets precision=HIGHEST at
        # its call site (no TF32); the default is left as JAX ships it
        ctx["precision"] = (
            "HIGHEST at each float32 dot/einsum site; default "
            f"{jax.config.jax_default_matmul_precision}")
        devs = jax.devices()
        if args.four:
            phases = (("four_rt", phase_four_rt),
                      ("four_train", phase_four_train))
        else:
            phases = (("rt", phase_rt), ("raster", phase_raster),
                      ("train", phase_train))
        for name, fn in phases:
            log(f"phase {name}")
            fn(ctx)
    except PhaseFailed as e:
        log(f"FAILED: {e}")
        return 1
    log(f"card (name, power limit): {ctx['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
