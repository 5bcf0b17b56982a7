"""Benchmark: the render paths' throughput on one GPU.

Protocol mirrors the reference's measurement window (draw3d/main.cpp:349-360):
host-side binning is done once up front; the timed region is device render
only (vx_start .. vx_ready_wait analog), ended by jax.block_until_ready.

Prints ONE JSON line: the headline {"metric", "value", "unit"}, the device
it ran on {"device": platform, kind, count, card name and power limit}, and
an "extra" blob with the per-path stages — the 256^2 frame (dispatch and
device-wall loops), the 1024^2 single draw, the 512^2/1024^2 training
steps, the 1024^2 multi-bounce RT frame and the config-3 RT frame — so
regressions are attributable per path.

The headline VALUE is the DEVICE-WALL metric: an N-frame compiled loop
whose frame n+1 data-depends on frame n (ref.driver.compile_frame_loop;
XLA provably cannot hoist it), timed at two loop lengths with the
difference quotient cancelling dispatch and sync costs.

Every stage runs in its OWN subprocess, one at a time, so a stage that
fails records an error field instead of killing the artifact.  The
benchmark needs a GPU: on any other platform it exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SCENE = "tekkaman"
SIZE = 256
FRAMES = 20
REPS = 9
DEVICE_LOOP_N1 = 100
DEVICE_LOOP_N2 = 500
DEVICE_REPS = 5


def _peaks(jax):
    from skybox_rt_tpu.runtime import perf as perf_mod
    return perf_mod.device_peaks(jax.devices()[0].device_kind)


def _headline(jax):
    from skybox_rt_tpu.geom import cgltrace
    from skybox_rt_tpu.ref import driver as ref_driver

    trace = cgltrace.load_cached(cgltrace.trace_path(SCENE))

    # --- host-side setup (untimed, like the reference's binning) ---
    # the deferred path first; the exact-equivalent immediate path if it
    # ever fails to compile — a slower number beats no number
    frame = None
    for mode in ("deferred", "immediate"):
        try:
            frame, arrays = ref_driver.compile_frame(trace, SIZE, SIZE,
                                                     mode=mode)
            fb = frame(arrays)
            jax.block_until_ready(fb)      # warmup (compile)
            break
        except Exception:
            frame = None
    assert frame is not None, "no render mode compiled"
    num_draws = len(arrays)

    # REPS short runs (each the 20-dispatched-frame reference window
    # analog): host dispatch included, unlike the device-wall stage
    runs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            fb = frame(arrays)
        jax.block_until_ready(fb)
        elapsed = time.perf_counter() - t0
        mpix = SIZE * SIZE * num_draws * FRAMES / elapsed / 1e6
        runs.append(round(mpix, 1))
    med = float(np.median(runs))
    # roofline of the frame at the median rate: bytes from the
    # MEASURED unit-traffic model (XLA's bytes-accessed
    # is a pre-fusion upper bound — orders of magnitude high on fused
    # graphs; see perf.roofline_of_fn caveat)
    roof = None
    try:
        from skybox_rt_tpu.runtime import perf as perf_mod
        stats = ref_driver.FrameStats()
        ref_driver.render_trace(trace, SIZE, SIZE, stats=stats,
                                mode="deferred", measure_traffic=True)
        sec = SIZE * SIZE * num_draws / (med * 1e6)
        r = perf_mod.roofline_from_traffic(stats.traffic, seconds=sec,
                                           peaks=_peaks(jax))
        roof = {"bound_by": r["bound_by"],
                "pct_of_roofline": round(r["pct_of_roofline"], 2),
                "achieved_gb_per_s": round(r["achieved_gb_per_s"], 1)}
    except Exception:
        pass
    return med, max(runs), mode, runs, roof


def _draw1024(jax):
    """Single textured drawcall at 1024^2."""
    import jax.numpy as jnp

    from skybox_rt_tpu.core import constants as C
    from skybox_rt_tpu.core import state as state_mod
    from skybox_rt_tpu.geom import binning, cgltrace
    from skybox_rt_tpu.ops import deferred as deferred_mod
    from skybox_rt_tpu.ref import driver, renderer

    W = H = 1024
    trace = cgltrace.load_cached(cgltrace.trace_path(SCENE))
    dc = trace.drawcalls[0]
    binned = binning.bin_drawcall(dc.pos, dc.indices, dc.color, dc.texcoord,
                                  W, H, dc.near, dc.far,
                                  C.RASTER_TILE_LOGSIZE)
    flags = state_mod.make_shader_flags(
        dc.states.depth_test, dc.states.color_enabled,
        dc.states.texture_enabled, dc.states.texture_envmode)
    rs = state_mod.RenderState(
        flags=flags, om=state_mod.make_om_state(dc.states),
        tex=None, scissor=(0, 0, W, H))
    tex_state, texels = driver.make_texture_binding(trace, dc, dc.states)
    rs = state_mod.RenderState(flags=flags, om=rs.om, tex=tex_state,
                               scissor=(0, 0, W, H))
    fbc = jnp.asarray(renderer.pad_framebuffer(
        np.full((H, W), driver.CLEAR_COLOR, np.uint32),
        C.RASTER_TILE_LOGSIZE))
    fbd = jnp.asarray(renderer.pad_framebuffer(
        np.full((H, W), driver.CLEAR_DEPTH, np.uint32),
        C.RASTER_TILE_LOGSIZE))

    # DEVICE-WALL protocol: an N-draw compiled loop whose draw n+1
    # data-depends on draw n's framebuffer through the sentinel count
    # (the headline_device trick), timed at two lengths
    e = jnp.asarray(binned.edges)
    a = jnp.asarray(binned.attribs)
    tp = jnp.asarray(binned.tile_pids)
    txy = jnp.asarray(binned.tile_xy)
    tls = binned.tile_logsize
    SEN = jnp.uint32(0xDEADBEEF)

    def make_loop(n):
        @jax.jit
        def loop(fbc, fbd):
            def body(_, carry):
                fbc, fbd = carry
                z = jnp.sum((fbc == SEN).astype(jnp.uint32))
                e2 = e + z.astype(e.dtype)
                a2 = a + z.astype(a.dtype)
                tp2 = tp + z.astype(tp.dtype)
                fbc, fbd, _ = deferred_mod._render_deferred_jit.__wrapped__(
                    rs, texels, e2, a2, a2[:, 0], tp2, txy, fbc, fbd, tls,
                    blend_slots=0)
                return fbc, fbd
            return jax.lax.fori_loop(0, n, body, (fbc, fbd))
        return loop

    NA, NB = 6, 30
    la, lb = make_loop(NA), make_loop(NB)
    jax.block_until_ready(la(fbc, fbd))
    jax.block_until_ready(lb(fbc, fbd))
    dt = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(la(fbc, fbd))
        t1 = time.perf_counter()
        jax.block_until_ready(lb(fbc, fbd))
        t2 = time.perf_counter()
        dt = min(dt, ((t2 - t1) - (t1 - t0)) / (NB - NA))
    out = {"draw1024_mpix_s": round(W * H / dt / 1e6, 1)}
    try:
        from skybox_rt_tpu.runtime import perf as perf_mod
        counts = deferred_mod.measure_drawcall_counts(rs, binned, fbd)
        traffic = perf_mod.drawcall_traffic(binned, rs, counts=counts)
        r = perf_mod.roofline_from_traffic(traffic, seconds=dt,
                                           peaks=_peaks(jax))
        out["draw1024_roofline"] = {
            "bound_by": r["bound_by"],
            "pct_of_roofline": round(r["pct_of_roofline"], 2),
            "achieved_gb_per_s": round(r["achieved_gb_per_s"], 1)}
    except Exception:
        pass
    return out


def _fwd_bwd(jax, mode="hard", probe_slots_only=False, size=512):
    """Deferred diff pipeline train step, compiled 10-step loop.  mode: hard | alpha | soft —
    the differentiable-coverage modes use auto-measured slot counts
    (pipeline.auto_slots).  probe_slots_only: return (auto_k, None)
    without timing (run in a throwaway subprocess).  size: 512 (standing
    artifact) or 1024 (the north star's gradient resolution)."""
    import jax.numpy as jnp

    from skybox_rt_tpu.diff import binning as dbin
    from skybox_rt_tpu.diff import pipeline
    from skybox_rt_tpu.models import scenes

    SZ, STEPS, TL = size, 10, 5
    verts, faces = scenes.icosphere(subdiv=4, radius=0.85)
    V = verts.shape[0]
    pos = np.concatenate([verts.astype(np.float32),
                          np.ones((V, 1), np.float32)], axis=1)
    pos[:, 2] = pos[:, 2] * 0.4 + 0.5
    rng = np.random.default_rng(0)
    params = {
        "pos": jnp.asarray(pos),
        "color": jnp.asarray(rng.uniform(0.2, 1.0, (V, 4)).astype(np.float32)),
        "uv": jnp.asarray(rng.uniform(0.0, 1.0, (V, 2)).astype(np.float32)),
        "tex": jnp.asarray(scenes.checkerboard_texture(64, 8)),
    }
    cfg = pipeline.DiffRenderConfig(
        width=SZ, height=SZ, tile_logsize=TL, depth_test=True,
        textured=True, modulate=True,
        alpha_blend=(mode == "alpha"),
        soft_edge_temp=0.7 if mode == "soft" else 0.0)
    static = dbin.bin_static(pos, faces.astype(np.int32), SZ, SZ,
                             tile_logsize=TL)
    static = {k: jnp.asarray(v) for k, v in static.items()}
    target = jnp.zeros((SZ, SZ, 4), jnp.float32)
    if mode == "hard":
        slots = 8
    else:
        # main() probes K in a separate subprocess and passes it
        # through env, so the timed process does no readback first
        if probe_slots_only:
            return pipeline.auto_slots(params, static, cfg), None
        import os
        slots = int(os.environ.get("SKYBOX_BENCH_SLOTS", "0")) \
            or pipeline.auto_slots(params, static, cfg)

    def loss_fn(params):
        img, _ = pipeline.render_deferred(params, static, cfg, slots=slots)
        return jnp.sum((img[:SZ, :SZ] - target) ** 2)

    grad_fn = jax.value_and_grad(loss_fn)

    def make_loop(n):
        @jax.jit
        def loop(params):
            def body(_, carry):
                params, acc = carry
                loss, g = grad_fn(params)
                params = {k: v - 1e-6 * g[k] if k in g else v
                          for k, v in params.items()}
                return params, acc + loss
            return jax.lax.fori_loop(0, n, body, (params, 0.0))
        return loop

    # two loop lengths, STEPS = the difference
    la, lb = make_loop(5), make_loop(5 + STEPS)
    jax.block_until_ready(la(params))
    jax.block_until_ready(lb(params))
    wall = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(la(params))
        t1 = time.perf_counter()
        jax.block_until_ready(lb(params))
        t2 = time.perf_counter()
        wall = min(wall, (t2 - t1) - (t1 - t0))
    roof = None
    try:
        # MEASURED unit-traffic model: the diff pipeline's streams are dense/static-shaped, so the model is
        # exact; XLA's cost_analysis pre-fusion bytes overstate by
        # orders of magnitude (runtime/perf.roofline_of_fn caveat)
        from skybox_rt_tpu.runtime import perf as perf_mod
        t = perf_mod.diff_step_traffic(params, static, cfg, slots)
        r = perf_mod.roofline_from_traffic(t, seconds=wall / STEPS,
                                           peaks=_peaks(jax))
        streams = {k: v for k, v in t.items()
                   if k.endswith("_bytes") and v > 0}
        roof = {"bound_by": r["bound_by"],
                "pct_of_roofline": round(r["pct_of_roofline"], 2),
                "bytes_model": r["bytes_model"],
                "modeled_mb_per_step": round(t["bytes_total"] / 1e6, 1),
                "top_stream": max(streams, key=streams.get)}
    except Exception:
        pass
    return SZ * SZ * STEPS / wall / 1e6, roof


def _rt_config3(jax):
    """BASELINE.json configs[2] standing artifact: vase (textured meshes
    + translucent blended layers) at 512^2 through the COMPILED
    single-dispatch RT frame (rt.frame): opaque draws run one closest-hit
    walk, blended draws the K-slot enumeration walks + submission-order
    OM replay.  Protocol: one
    render_trace_rt_fused converges the K hints (overflow retry,
    readbacks allowed), then the timed region is the compiled frame
    dispatch only (vx_start..ready_wait analog); overflow is re-verified
    from the timed run's own output AFTER the loop.  Returns ms/frame."""
    from skybox_rt_tpu.geom import cgltrace
    from skybox_rt_tpu.rt import frame as frame_mod

    trace = cgltrace.load_cached(cgltrace.trace_path("vase"))
    img = frame_mod.render_trace_rt_fused(trace, 512, 512)  # hint warmup
    assert np.isfinite(img).all()
    fn, arrays, rays, metas = frame_mod.make_frame_fn(trace, 512, 512)
    out = jax.block_until_ready(fn(arrays, *rays))     # compile
    dt = 1e9
    for _ in range(5):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(arrays, *rays))
        dt = min(dt, time.perf_counter() - t0)
    _, _, ovf = out
    assert not np.asarray(ovf).any(), "K-slot overflow in timed frame"
    return dt * 1e3


def _rt_northstar(jax):
    """1024^2 multi-bounce RT over the >=100k-tri sphere field in ONE
    frame dispatch (BASELINE.md scaling-row scene class).  e2e Mrays/s
    over all launches (primary + shadow + bounces*(closest + shadow))."""
    from skybox_rt_tpu.models import scenes
    from skybox_rt_tpu.rt import tracer

    W = H = 1024
    verts, faces, colors = scenes.sphere_field(copies=9, subdiv=5)
    scene = tracer.RTScene(verts=verts, faces=faces, colors=colors,
                           reflectivity=0.35)
    cam = tracer.Camera(eye=(0.0, 2.5, 9.5), look_at=(0.0, -0.4, 0.0),
                        fov_y_deg=55.0)
    cfg = tracer.RTConfig(width=W, height=H, bounces=2, shadows=True)
    frame, (o, d) = tracer.make_frame_fn(scene, cam, cfg)
    jax.block_until_ready(frame(o, d))                 # compile
    dt = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(frame(o, d))
        dt = min(dt, time.perf_counter() - t0)
    return W * H * (2 + 2 * cfg.bounces) / dt / 1e6


def _headline_device(jax):
    """Device-wall 256^2 frame rate (the headline): two compiled
    N-frame loops (N1/N2), frame-to-frame data dependence via the
    sentinel-count carry, rate from the difference quotient (cancels
    dispatch and sync costs).  Verifies AFTER timing that the sentinel
    never rendered and the loop's final frame == the single-dispatch
    frame."""
    from skybox_rt_tpu.geom import cgltrace
    from skybox_rt_tpu.ref import driver as ref_driver

    trace = cgltrace.load_cached(cgltrace.trace_path(SCENE))
    mode = "deferred"
    loop1, arrays = ref_driver.compile_frame_loop(
        trace, SIZE, SIZE, DEVICE_LOOP_N1, mode=mode)
    loop2, _ = ref_driver.compile_frame_loop(
        trace, SIZE, SIZE, DEVICE_LOOP_N2, mode=mode)
    fb1 = jax.block_until_ready(loop1(arrays))        # compile both
    fb2 = jax.block_until_ready(loop2(arrays))
    num_draws = len(arrays)

    rates = []
    for _ in range(DEVICE_REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(loop1(arrays))
        t1 = time.perf_counter()
        jax.block_until_ready(loop2(arrays))
        t2 = time.perf_counter()
        dt_frame = ((t2 - t1) - (t1 - t0)) / (DEVICE_LOOP_N2 -
                                              DEVICE_LOOP_N1)
        rates.append(round(SIZE * SIZE * num_draws / dt_frame / 1e6, 1))
    med = float(np.median(rates))

    # verification (readbacks AFTER all timing): z was provably 0
    frame, _ = ref_driver.compile_frame(trace, SIZE, SIZE, mode=mode)
    ref = np.asarray(frame(arrays))
    a1, a2 = np.asarray(fb1), np.asarray(fb2)
    assert not (ref == ref_driver.FRAME_LOOP_SENTINEL).any(), \
        "sentinel color rendered: loop carry not provably zero"
    assert (a1 == ref).all() and (a2 == ref).all(), \
        "device-wall loop frame differs from single-dispatch frame"
    return med, rates, mode


def _stage_headline_device(jax):
    med, rates, mode = _headline_device(jax)
    return {"value": med, "device_runs": rates, "device_mode": mode}


def _stage_headline(jax):
    mpix_s, best, mode, runs, roof = _headline(jax)
    out = {"headline_dispatch_mpix_s": round(mpix_s, 3),
           "dispatch_mode": mode, "headline_runs": runs,
           "headline_best": round(best, 1)}
    if roof is not None:
        out["headline_roofline"] = roof
    return out


def _stage_draw1024(jax):
    return _draw1024(jax)


def _stage_fwd_bwd(jax):
    rate, roof = _fwd_bwd(jax)
    out = {"fwd_bwd_512_mpix_s": round(rate, 2)}
    if roof is not None:
        out["fwd_bwd_roofline"] = roof
    return out


def _stage_fwd_bwd_1024(jax):
    rate, roof = _fwd_bwd(jax, size=1024)
    out = {"fwd_bwd_1024_mpix_s": round(rate, 2)}
    if roof is not None:
        out["fwd_bwd_1024_roofline"] = roof
    return out


def _stage_fwd_bwd_soft(jax):
    rate, _ = _fwd_bwd(jax, mode="soft")
    return {"fwd_bwd_softedge_512_mpix_s": round(rate, 2)}


def _stage_fwd_bwd_alpha(jax):
    rate, _ = _fwd_bwd(jax, mode="alpha")
    return {"fwd_bwd_alpha_512_mpix_s": round(rate, 2)}


def _stage_slots_soft(jax):
    k, _ = _fwd_bwd(jax, mode="soft", probe_slots_only=True)
    return {"slots": k}


def _stage_slots_alpha(jax):
    k, _ = _fwd_bwd(jax, mode="alpha", probe_slots_only=True)
    return {"slots": k}


def _stage_rt_northstar(jax):
    return {"rt_multibounce_1024_mrays_s": round(_rt_northstar(jax), 1)}


def _stage_rt_config3(jax):
    return {"rt_config3_512_ms": round(_rt_config3(jax), 1)}


STAGES = {
    "headline_device": (_stage_headline_device, 2400),
    "headline": (_stage_headline, 2400),
    "draw1024": (_stage_draw1024, 1200),
    "fwd_bwd": (_stage_fwd_bwd, 1200),
    "fwd_bwd_1024": (_stage_fwd_bwd_1024, 1200),
    "slots_soft": (_stage_slots_soft, 900),
    "fwd_bwd_soft": (_stage_fwd_bwd_soft, 1200),
    "slots_alpha": (_stage_slots_alpha, 900),
    "fwd_bwd_alpha": (_stage_fwd_bwd_alpha, 1200),
    "rt_northstar": (_stage_rt_northstar, 1800),
    "rt_config3": (_stage_rt_config3, 1800),
}

# stages whose result feeds the NEXT stage's env instead of the artifact
_PROBE_FOR = {"slots_soft": "fwd_bwd_soft", "slots_alpha": "fwd_bwd_alpha"}


def _run_stage(name: str) -> int:
    import jax

    fn, _ = STAGES[name]
    print(json.dumps(fn(jax)))
    return 0




def _device_info() -> dict:
    """The device the stages run on, read in a THROWAWAY subprocess (the
    orchestrator itself never attaches to the card, so each stage has it
    alone), plus the card's name and power limit from nvidia-smi."""
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax, json; d = jax.devices(); print(json.dumps("
         "{'platform': d[0].platform, 'kind': d[0].device_kind, "
         "'count': len(d)}))"],
        capture_output=True, text=True, timeout=300)
    lines = probe.stdout.strip().splitlines()
    info = json.loads(lines[-1]) if lines else {"platform": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except OSError:
        smi = ""
    info["card"] = smi.splitlines()[0] if smi else None
    return info


def main():
    # every stage in its own subprocess (module docstring); a failed
    # stage records an error field instead of killing the artifact
    import os

    device = _device_info()
    if device.get("platform") != "gpu":
        print(f"bench.py needs a GPU; JAX found {device}", file=sys.stderr)
        return 1

    results = {}
    env_extra = {}
    for name, (_, tmo) in STAGES.items():
        env = dict(os.environ)
        env.update(env_extra.pop(name, {}))
        try:
            proc = subprocess.run(
                [sys.executable, __file__, "--stage", name],
                capture_output=True, text=True, timeout=tmo, env=env)
            lines = proc.stdout.strip().splitlines()
            if not lines:
                results[name] = {
                    "error": f"exit={proc.returncode}",
                    "stderr": proc.stderr.strip()[-300:]}
            else:
                results[name] = json.loads(lines[-1])
        except Exception as e:
            results[name] = {"error": type(e).__name__}
        if name in _PROBE_FOR:
            r = results.pop(name)
            if "slots" in r:
                env_extra[_PROBE_FOR[name]] = {
                    "SKYBOX_BENCH_SLOTS": str(r["slots"])}

    dev = results.get("headline_device", {})
    mpix_s = dev.pop("value", None)
    extra = {}
    for name, r in results.items():
        if name == "headline_device":
            extra.update(dev)
        elif "error" in r:
            extra[f"{name}_error"] = r["error"]
            if r.get("stderr"):
                extra[f"{name}_stderr"] = r["stderr"]
        else:
            extra.update(r)

    print(json.dumps({
        "metric": f"draw3d_{SCENE}_{SIZE}x{SIZE}_fwd_devicewall",
        "value": mpix_s,
        "unit": "Mpix/s",
        "device": device,
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--stage":
        sys.exit(_run_stage(sys.argv[2]))
    sys.exit(main())
