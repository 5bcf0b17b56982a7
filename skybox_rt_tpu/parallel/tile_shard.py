"""Tile-parallel sharded rendering + the inverse-rendering training step.

Sharding strategy (SURVEY §2.7-2.8, north-star config 5):
  * geometry (vertices, indices, per-prim setup) is REPLICATED — the same
    strategy as the reference, where every raster unit reads the shared
    primitive buffer; the geometry processing is a tiny fraction of
    raster work, so recomputing it per device beats communicating it
  * screen tiles are SHARDED across the 'tiles' mesh axis — the analog of
    the reference's tile striping across raster units
    (raster_unit.cpp:109-114: unit i takes tiles i, i+N, ...)
  * the loss is psum-reduced; parameter gradients are psum-reduced across
    the mesh (the gradient all-reduce; XLA overlaps these collectives with
    the remaining backward compute)
  * framebuffer assembly = psum of disjoint tile scatters (each chip owns
    its tiles; races are impossible by construction)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..diff import pipeline
from . import mesh as mesh_mod

F32 = jnp.float32


def shard_tiles(static: dict, n_shards: int) -> dict:
    """Pad binning output so the tile axis divides the mesh.

    Padding tiles get empty pid lists and scatter to tile (0,0) with zero
    contribution (their rendered tiles are all-background and masked out of
    the psum scatter by a weight of 0).
    """
    tile_pids = mesh_mod.pad_to_multiple(
        np.asarray(static["tile_pids"]), n_shards, axis=0, fill=-1
    )
    T = tile_pids.shape[0]
    tile_xy = np.zeros((T, 2), np.int32)
    tile_xy[: static["tile_xy"].shape[0]] = static["tile_xy"]
    tile_valid = np.zeros((T,), np.float32)
    tile_valid[: static["tile_xy"].shape[0]] = 1.0
    return dict(static, tile_pids=tile_pids, tile_xy=tile_xy,
                tile_valid=tile_valid)


def make_sharded_render(mesh, cfg: pipeline.DiffRenderConfig):
    """Full-frame sharded forward render: each chip renders its tile strip,
    frames are assembled with a psum over disjoint scatters."""
    ts = 1 << cfg.tile_logsize
    Hp = -(-cfg.height // ts) * ts
    Wp = -(-cfg.width // ts) * ts
    gh, gw = Hp // ts, Wp // ts
    axis = tuple(mesh.axis_names)   # 1D or hosts x chips (mesh.make_mesh_2d)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis)),
        out_specs=P(), check_vma=False,
    )
    def _render(params, indices, tile_pids, tile_xy, tile_valid):
        setup = pipeline.prim_setup(params, indices, cfg)   # replicated
        tiles = pipeline.render_tile_set(setup, tile_pids, tile_xy * ts, cfg)
        tiles = tiles * tile_valid[:, None, None, None]
        canvas = jnp.zeros((gh, gw, ts, ts, 4), F32)
        canvas = canvas.at[tile_xy[:, 1], tile_xy[:, 0]].add(tiles)
        cover = jnp.zeros((gh, gw), F32).at[tile_xy[:, 1], tile_xy[:, 0]].add(
            tile_valid)
        canvas = jax.lax.psum(canvas, axis)
        cover = jax.lax.psum(cover, axis)
        # tiles no primitive was binned to keep the clear color
        bg = jnp.asarray(cfg.background, F32)
        canvas = canvas + ((cover == 0).astype(F32)[:, :, None, None, None]
                           * bg[None, None, None, None, :])
        return canvas.transpose(0, 2, 1, 3, 4).reshape(Hp, Wp, 4)

    def render(params, static):
        return _render(
            params, jnp.asarray(static["indices"]),
            jnp.asarray(static["tile_pids"]), jnp.asarray(static["tile_xy"]),
            jnp.asarray(static["tile_valid"]),
        )

    return render


def make_train_step(mesh, cfg: pipeline.DiffRenderConfig, lr: float = 0.1,
                    trainable: tuple = ("color", "pos", "uv", "tex"),
                    deferred: bool = True, slots: int = 8,
                    grad_buckets: int = 3,
                    grad_collective: str = "flat"):
    """Inverse-rendering SGD step, tile-sharded with gradient all-reduce.

    target_tiles are pre-gathered per tile on the host (the per-chip loss
    only touches local tiles — no image-sized communication in the loss).
    deferred=True uses the two-pass pipeline (non-diff K-slot visibility +
    O(pixels*K) differentiable shading) — the backward never traverses the
    per-prim scan; exact vs the scan renderer in hard mode, and for
    blend/soft modes whenever per-pixel writes fit the slot count.
    grad_buckets > 0 packs the parameter psums into that many size-balanced
    concatenated collectives (parallel.overlap.bucketed_psum) so XLA's
    scheduler can overlap each bucket's all-reduce with the backward
    compute feeding the next; 0 = one psum per parameter.
    grad_collective: "flat" psums each bucket over all mesh axes at once;
    "two_level" (2-D (hosts, chips) meshes only) uses the slice-aware
    decomposition — ICI reduce-scatter, DCN shard all-reduce, ICI
    all-gather (parallel.overlap.two_level_psum; SURVEY §2.8 DCN axis).
    Returns step(params, static_arrays, target_tiles)
        -> (params, loss, max_writes).
    max_writes is the mesh-max observed per-pixel write count of the
    deferred visibility pass (0 when deferred=False): when it exceeds
    `slots` in a blend/soft config, the deferred tiles (and therefore the
    loss/grads) deviate from the exact scan renderer — callers should
    re-dispatch with slots >= max_writes (tests/test_diff_deferred.py
    asserts no silent overflow in the shipped configs).
    """
    from . import overlap as overlap_mod

    ts = 1 << cfg.tile_logsize
    axis = tuple(mesh.axis_names)   # 1D or hosts x chips (mesh.make_mesh_2d)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P()), check_vma=False,
    )
    def _grads(params, indices, tile_pids, tile_xy, tile_valid, target_tiles):
        def local_loss(params):
            setup = pipeline.prim_setup(params, indices, cfg)
            if deferred:
                tiles, maxw = pipeline.render_tile_set_deferred(
                    setup, tile_pids, tile_xy * ts, cfg, slots)
            else:
                tiles = pipeline.render_tile_set(setup, tile_pids,
                                                 tile_xy * ts, cfg)
                maxw = jnp.int32(0)
            err = (tiles - target_tiles) ** 2
            return jnp.sum(err * tile_valid[:, None, None, None]), maxw

        (loss, maxw), grads = jax.value_and_grad(
            local_loss, has_aux=True)(params)
        # gradient all-reduce across the mesh — bucketed so each bucket's
        # collective depends only on its own leaves and can overlap the
        # rest of the backward (parallel.overlap docstring)
        loss = jax.lax.psum(loss, axis)
        maxw = jax.lax.pmax(maxw, axis)
        if grad_collective == "two_level":
            if len(axis) != 2:
                raise ValueError("two_level needs a (hosts, chips) mesh")
            grads = overlap_mod.two_level_psum(
                grads, dcn_axis=axis[0], ici_axis=axis[1],
                n_buckets=max(grad_buckets, 1))
        elif grad_buckets > 0:
            grads = overlap_mod.bucketed_psum(grads, axis, grad_buckets)
        else:
            grads = jax.tree.map(lambda g: jax.lax.psum(g, axis), grads)
        return loss, grads, maxw

    @jax.jit
    def step(params, arrays, target_tiles):
        loss, grads, maxw = _grads(
            params, arrays["indices"], arrays["tile_pids"],
            arrays["tile_xy"], arrays["tile_valid"], target_tiles,
        )
        params = {
            k: (v - lr * grads[k] if k in trainable else v)
            for k, v in params.items()
        }
        return params, loss, maxw

    return step


def gather_target_tiles(target_img: np.ndarray, tile_xy: np.ndarray,
                        tile_logsize: int) -> np.ndarray:
    """Cut the (H, W, 4) target image into the binned tile order."""
    ts = 1 << tile_logsize
    H, W = target_img.shape[:2]
    Hp = -(-H // ts) * ts
    Wp = -(-W // ts) * ts
    pad = np.zeros((Hp, Wp, 4), np.float32)
    pad[:H, :W] = target_img
    out = np.zeros((tile_xy.shape[0], ts, ts, 4), np.float32)
    for t, (tx, ty) in enumerate(np.asarray(tile_xy)):
        out[t] = pad[ty * ts:(ty + 1) * ts, tx * ts:(tx + 1) * ts]
    return out
