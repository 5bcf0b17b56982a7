"""Host runtime layer tests (SURVEY §2.2 H1/H5/H6 + §2.4 S12).

Mirrors the reference's host-side unit tests: the vx_malloc allocator test
(tests/unittest/vx_malloc/main.cpp) exercises alloc + access flags; here the
Buffer access-flag checks carry that concept (ACL enforcement,
sim/common/mem.h:159-176).  The CLI test is the blackbox.sh run-an-app check.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from skybox_rt_tpu.runtime.device import Buffer, Device, DeviceError
from skybox_rt_tpu.runtime.perf import PerfCounters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_caps():
    caps = Device().caps
    assert caps.num_devices >= 1
    assert caps.has_raster and caps.has_tex and caps.has_om and caps.has_rt


def test_upload_download_roundtrip():
    dev = Device()
    host = np.arange(64, dtype=np.uint32).reshape(8, 8)
    buf = dev.upload(host, access=Buffer.READ | Buffer.WRITE)
    out = dev.download(buf)
    np.testing.assert_array_equal(out, host)
    assert dev.perf.counters["host_to_device_bytes"] == host.nbytes


def test_readonly_buffer_rejects_write():
    """ACL enforcement: VX_MEM_READ buffer rejects writes, like the
    reference aborts on an ACL violation (runtime/simx/vortex.cpp:143-145)."""
    dev = Device()
    buf = dev.upload(np.zeros(4, np.float32), access=Buffer.READ)
    with pytest.raises(DeviceError):
        buf.write(np.ones(4, np.float32))


def test_buffer_write_shape_check():
    dev = Device()
    buf = dev.upload(np.zeros(4, np.float32), access=Buffer.WRITE)
    with pytest.raises(DeviceError):
        buf.write(np.zeros(8, np.float32))
    buf.write(np.ones(4, np.float32))
    np.testing.assert_array_equal(dev.download(buf), np.ones(4, np.float32))


def test_device_run_counts_launch():
    dev = Device()
    buf = dev.upload(np.arange(8, dtype=np.float32))
    out = dev.run(lambda x: x * 2, buf.array)
    np.testing.assert_array_equal(np.asarray(out), np.arange(8) * 2.0)
    assert dev.perf.counters["kernel_launches"] == 1
    assert dev.perf.times_ms["device_ms"] > 0


def test_perf_counters_merge_and_dump(capsys):
    a, b = PerfCounters(), PerfCounters()
    a.count("x", 3)
    b.count("x", 4)
    b.add_time("t_ms", 1.5)
    a.merge(b)
    assert a.as_dict()["x"] == 7
    a.dump()
    out = capsys.readouterr().out
    assert "x" in out and "t_ms" in out


def test_drawcall_traffic_model():
    """Analytic traffic model ≅ S6/S7/S8 mem traces: sane, nonzero."""
    from skybox_rt_tpu.geom import binning, cgltrace
    from skybox_rt_tpu.core import state as state_mod
    from skybox_rt_tpu.runtime import perf as perf_mod

    trace = cgltrace.load_cached(cgltrace.trace_path("triangle"))
    dc = trace.drawcalls[0]
    binned = binning.bin_drawcall(
        dc.pos, dc.indices, dc.color, dc.texcoord, 64, 64,
        dc.near, dc.far, 5)
    rs = state_mod.RenderState(
        flags=state_mod.make_shader_flags(
            dc.states.depth_test, dc.states.color_enabled,
            dc.states.texture_enabled, dc.states.texture_envmode),
        om=state_mod.make_om_state(dc.states),
        tex=None, scissor=(0, 0, 64, 64))
    t = perf_mod.drawcall_traffic(binned, rs)
    assert t["raster_mem_reads_bytes"] > 0
    assert t["prims"] == binned.num_prims
    assert t["fragments_upper_bound"] >= 0


def test_measured_drawcall_counts():
    """Measured counters (emulator.cpp:416-545 analog): the counting pass
    must agree with the rendered image — for a single opaque triangle on
    cleared buffers, covered == passing == written pixels — and always sit
    at or below the coverage-area upper bound."""
    import jax.numpy as jnp

    from skybox_rt_tpu.core import state as state_mod
    from skybox_rt_tpu.geom import binning, cgltrace
    from skybox_rt_tpu.ops import deferred as deferred_mod
    from skybox_rt_tpu.ref import driver, renderer
    from skybox_rt_tpu.runtime import perf as perf_mod

    trace = cgltrace.load_cached(cgltrace.trace_path("triangle"))
    dc = trace.drawcalls[0]
    binned = binning.bin_drawcall(
        dc.pos, dc.indices, dc.color, dc.texcoord, 64, 64,
        dc.near, dc.far, 5)
    rs = state_mod.RenderState(
        flags=state_mod.make_shader_flags(
            dc.states.depth_test, dc.states.color_enabled,
            dc.states.texture_enabled, dc.states.texture_envmode),
        om=state_mod.make_om_state(dc.states),
        tex=None, scissor=(0, 0, 64, 64))

    fbc = jnp.asarray(renderer.pad_framebuffer(
        np.full((64, 64), driver.CLEAR_COLOR, np.uint32), 5))
    fbd = jnp.asarray(renderer.pad_framebuffer(
        np.full((64, 64), driver.CLEAR_DEPTH, np.uint32), 5))
    counts = deferred_mod.measure_drawcall_counts(rs, binned, fbd)

    out_c, _ = renderer.render_drawcall(rs, None, binned, fbc, fbd)
    written = int((np.asarray(out_c) != driver.CLEAR_COLOR).sum())
    assert counts["fragments"] == written
    assert counts["om_passing"] == written

    t = perf_mod.drawcall_traffic(binned, rs, counts=counts)
    tu = perf_mod.drawcall_traffic(binned, rs)
    assert t["fragments"] <= tu["fragments_upper_bound"]
    assert t["om_mem_writes_bytes"] <= tu["om_mem_writes_bytes_ub"]
    # this scene has depth test off: only the color word is written
    assert t["om_mem_writes_bytes"] == written * 4


def test_render_trace_measured_traffic():
    """Full-frame measured traffic on tekkaman: measured fragment totals
    are positive and below the upper bound."""
    from skybox_rt_tpu.geom import cgltrace
    from skybox_rt_tpu.ref import driver

    trace = cgltrace.load_cached(cgltrace.trace_path("tekkaman"))
    stats_m = driver.FrameStats()
    driver.render_trace(trace, 64, 64, stats=stats_m, mode="deferred",
                        measure_traffic=True)
    stats_u = driver.FrameStats()
    driver.render_trace(trace, 64, 64, stats=stats_u, mode="deferred")
    assert stats_m.traffic["fragments"] > 0
    assert (stats_m.traffic["fragments"]
            < stats_u.traffic["fragments_upper_bound"])
    assert (stats_m.traffic["tex_mem_reads_bytes"]
            <= stats_u.traffic["tex_mem_reads_bytes_ub"])
    assert stats_m.traffic["om_write_fragments"] > 0


def _run_cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "skybox_rt_tpu", *argv],
        capture_output=True, text=True, timeout=300,
        cwd="/root/repo",
        env={"PATH": "/usr/bin:/bin:/usr/local/bin",
             "JAX_PLATFORMS": "cpu", "HOME": "/root"},
    )


def test_cli_info():
    r = _run_cli("info")
    assert r.returncode == 0, r.stderr
    caps = json.loads(r.stdout)
    assert caps["isa"]["raster"] and caps["num_devices"] >= 1


def test_cli_render_golden(tmp_path):
    out = str(tmp_path / "triangle.png")
    r = _run_cli(
        "render", "-t", "triangle", "-w", "16", "-H", "16",
        "-o", out, "-r",
        "/root/reference/tests/regression/draw3d/triangle_ref_16.png",
        "--perf")
    assert r.returncode == 0, r.stderr + r.stdout
    assert "PASSED!" in r.stdout
    assert "PERF:" in r.stdout


def test_cost_analysis():
    """XLA cost counters: a known matmul reports ~2*M*N*K flops."""
    import jax.numpy as jnp

    from skybox_rt_tpu.runtime import perf as perf_mod

    a = np.ones((64, 64), np.float32)

    def f(a):
        return jnp.dot(a, a, preferred_element_type=jnp.float32)

    c = perf_mod.cost_analysis(f, a)
    assert c["flops"] >= 2 * 64 * 64 * 64 * 0.5   # within cost-model slack
    assert c["bytes_accessed"] > 0


def test_roofline_placement():
    """Roofline math (runtime.perf.roofline): axis selection, percents,
    and the ridge point."""
    from skybox_rt_tpu.runtime import perf as perf_mod

    pk = perf_mod.device_peaks("NVIDIA H100 80GB HBM3")
    # HBM-bound: 1 flop/byte << ridge
    r = perf_mod.roofline(1e9, 1e9, seconds=1e-2, peaks=pk)
    assert r["bound_by"] == "hbm"
    assert abs(r["pct_of_hbm_peak"] - 1e11 / pk["hbm_bytes_per_s"] * 100) \
        < 1e-6
    assert r["pct_of_roofline"] == r["pct_of_hbm_peak"]
    # compute-bound: intensity far above the ridge
    r2 = perf_mod.roofline(1e13, 1e9, seconds=1e-1, peaks=pk)
    assert r2["bound_by"] == "flops"
    assert r2["pct_of_roofline"] == r2["pct_of_flop_peak"]
    assert r2["arith_intensity_flops_per_byte"] > r2["ridge_flops_per_byte"]
    # table formatting smoke
    txt = perf_mod.format_roofline_table({"p": r, "q": r2})
    assert "hbm" in txt and "flops" in txt


def test_roofline_of_fn_cpu():
    import jax
    import jax.numpy as jnp
    from skybox_rt_tpu.runtime import perf as perf_mod

    def f(x):
        return (x @ x).sum()

    x = jnp.ones((128, 128), jnp.float32)
    r = perf_mod.roofline_of_fn(
        f, x, seconds=1e-3,
        peaks=perf_mod.device_peaks("NVIDIA H100 80GB HBM3"))
    assert r["flops"] > 0 and r["seconds"] == 1e-3


def test_roofline_from_traffic():
    from skybox_rt_tpu.runtime import perf as perf_mod

    t = {"tex_mem_reads_bytes": 6_000_000, "om_mem_writes_bytes": 2_000_000,
         "tiles": 24, "prims": 10}
    assert perf_mod.traffic_bytes(t) == 8_000_000
    r = perf_mod.roofline_from_traffic(
        t, seconds=1e-3, peaks=perf_mod.device_peaks("NVIDIA H100 80GB HBM3"))
    assert r["bytes_model"] == "measured_unit_traffic"
    assert r["bound_by"] == "hbm"
    assert abs(r["achieved_gb_per_s"] - 8.0) < 1e-6


@pytest.mark.parametrize("kind,known", [
    ("NVIDIA H100 80GB HBM3", True),
    ("cpu", False),
    ("AMD Instinct MI300X", False),
])
def test_device_peaks_table(kind, known):
    """Peaks come from the device-kind table; an unknown device raises
    instead of falling back to some other device's numbers."""
    from skybox_rt_tpu.runtime import perf as perf_mod

    if known:
        pk = perf_mod.device_peaks(kind)
        assert pk["hbm_bytes_per_s"] > 0 and pk["f32_flops_per_s"] > 0
    else:
        with pytest.raises(perf_mod.UnknownDeviceError):
            perf_mod.device_peaks(kind)


@pytest.mark.parametrize("platform,engine", [("gpu", "kernel"),
                                             ("cpu", "bvh")])
def test_rt_route_choice(platform, engine):
    """runtime.device picks the traversal route per platform."""
    from skybox_rt_tpu.runtime import device

    assert device.rt_engine(platform) == engine


def test_rt_route_unknown_platform_raises():
    from skybox_rt_tpu.runtime import device

    with pytest.raises(device.DeviceError):
        device.rt_engine("rocm")


def test_rt_route_never_interprets():
    """No platform routes to the Pallas interpreter: interpret mode is
    reached only through an explicit argument."""
    import dataclasses

    from skybox_rt_tpu.rt import tracer
    from skybox_rt_tpu.runtime import device

    assert "interpret" not in " ".join(device.RT_ENGINES.values())
    cfg = tracer.RTConfig(width=8, height=8)
    assert cfg.engine == "auto" and cfg.interpret is False
    assert tracer.resolve_engine(cfg) == "bvh"          # the CPU route
    assert tracer.resolve_engine(
        dataclasses.replace(cfg, use_bvh=False)) == "brute"
    with pytest.raises(ValueError):
        tracer.resolve_engine(dataclasses.replace(cfg, engine="pallas"))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, tmp_path):
    """The compile cache goes to $JAX_COMPILATION_CACHE_DIR when set,
    else to the one fixed, git-ignored directory of the checkout."""
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    env["JAX_PLATFORMS"] = "cpu"
    code = ("import jax, skybox_rt_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, check=True,
                         cwd=REPO).stdout.split()
    if env_set:
        assert out == [str(tmp_path)]
    else:
        assert out == [os.path.join(REPO, ".jax_cache")]
        ignored = open(os.path.join(REPO, ".gitignore")).read().split()
        assert ".jax_cache/" in ignored
