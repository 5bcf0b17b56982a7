"""Scaling-efficiency harness — the perf/graphics/run.sh sweep analog for
the mesh axis (north-star config 5: >=80 % rays/s scaling efficiency).

Runs the tile-sharded train step (forward + backward + psum all-reduce)
at increasing mesh sizes on whatever devices exist (real chips, or the
virtual CPU mesh in tests) and reports ms/step, speedup, and efficiency
vs the 1-device baseline.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..diff import binning as dbin
from ..diff import pipeline
from ..models import scenes
from . import mesh as mesh_mod
from . import tile_shard


def build_workload(size: int = 256, tile_logsize: int = 5, subdiv: int = 3):
    """A raster inverse-rendering workload big enough to shard: an
    icosphere projected to clip space, every tile populated."""
    verts, faces = scenes.icosphere(subdiv=subdiv)
    V = verts.shape[0]
    # orthographic-ish clip placement filling the frame
    pos = np.concatenate(
        [verts[:, :2] * 0.9, verts[:, 2:3] * 0.4 + 0.5,
         np.ones((V, 1), np.float32)], 1).astype(np.float32)
    rng = np.random.default_rng(0)
    params = {
        "pos": jnp.asarray(pos),
        "color": jnp.asarray(rng.uniform(size=(V, 4)).astype(np.float32)),
        "uv": jnp.asarray(rng.uniform(size=(V, 2)).astype(np.float32)),
    }
    cfg = pipeline.DiffRenderConfig(width=size, height=size,
                                    tile_logsize=tile_logsize)
    static = dbin.bin_static(pos, np.asarray(faces, np.int32), size, size,
                             tile_logsize=tile_logsize)
    return params, static, cfg


def measure(mesh_sizes=None, size: int = 256, iters: int = 10,
            warmup: int = 2, compiled_loop: bool = True) -> dict:
    """Returns {n_devices: {"ms": .., "speedup": .., "efficiency": ..}}.

    compiled_loop=True (default) times `iters` steps as ONE jitted
    lax.fori_loop dispatch, so the reported ms/step is device time —
    per-step host dispatch latency is excluded.  False reproduces the eager per-step
    protocol for comparison.
    """
    avail = len(jax.devices())
    if mesh_sizes is None:
        mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= avail]
    params, static, cfg = build_workload(size)

    results = {}
    base_ms = None
    for n in mesh_sizes:
        mesh = mesh_mod.make_mesh(n)
        sharded = tile_shard.shard_tiles(static, n)
        arrays = {k: jnp.asarray(v) for k, v in sharded.items()}
        target = jnp.zeros(
            (sharded["tile_xy"].shape[0], 1 << cfg.tile_logsize,
             1 << cfg.tile_logsize, 4), jnp.float32)
        step = tile_shard.make_train_step(mesh, cfg, lr=1e-3)

        if compiled_loop:
            @jax.jit
            def run_n(p, arrays=arrays, target=target, step=step):
                def body(i, carry):
                    p, _ = carry
                    p, loss, _maxw = step(p, arrays, target)
                    return (p, loss)
                return jax.lax.fori_loop(0, iters, body,
                                         (p, jnp.float32(0.0)))

            _, loss = run_n(params)          # compile + warmup
            jax.block_until_ready(loss)
            t0 = time.perf_counter()
            _, loss = run_n(params)
            jax.block_until_ready(loss)
            ms = (time.perf_counter() - t0) / iters * 1e3
        else:
            p = params
            for _ in range(max(warmup, 1)):  # >=1: the compile must land
                p, loss, _ = step(p, arrays, target)
            jax.block_until_ready(loss)
            t0 = time.perf_counter()
            p = params
            for _ in range(iters):
                p, loss, _ = step(p, arrays, target)
            jax.block_until_ready(loss)
            ms = (time.perf_counter() - t0) / iters * 1e3

        if base_ms is None:
            base_ms = ms
        speedup = base_ms / ms
        results[n] = {
            "ms": ms,
            "speedup": speedup,
            "efficiency": speedup / (n / mesh_sizes[0]),
        }
    return results
