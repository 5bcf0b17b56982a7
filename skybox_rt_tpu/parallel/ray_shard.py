"""Ray-parallel RT rendering over the device mesh.

The raster path stripes *screen tiles* across devices (tile_shard.py,
mirroring raster_unit.cpp:224-227's tile striping).  The RT path's natural
data-parallel axis is *rays* (SURVEY §2.7 "new-framework-only axes"):
camera rays are contiguous-block-sharded over the mesh, the scene
(triangles + BVH + shading arrays) is replicated on every device,
and each device runs the full trace+shade body (tracer.trace_rays) on its
block.  No cross-device communication is needed until the framebuffer is
assembled — exactly the tile-ownership argument that makes the raster path
race-free by construction.

Row counts must divide the mesh size; pad_rows handles ragged heights.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..rt import tracer


def render_sharded(scene: tracer.RTScene, cam: tracer.Camera,
                   cfg: tracer.RTConfig, mesh):
    """tracer.render with rays block-sharded over mesh's first axis.

    Returns (H, W, 4) float32, identical to the single-device render
    (asserted in tests/test_ray_shard.py).
    """
    from ..rt import wavefront

    scene = scene.finalize()
    scene_arrays = tracer.scene_shade_arrays(scene, cfg)
    closest, occluded = tracer.make_intersectors(scene, cfg)
    o, d = tracer.camera_rays(cam, cfg.width, cfg.height)

    # same pixel-tile ordering as tracer.make_frame_fn: each device's
    # block is then a run of compact screen tiles (coherent warps AND
    # balanced tile ownership)
    perm = inv = None
    if tracer.resolve_engine(cfg) == "kernel":
        perm, inv = wavefront.tile_order_perm(cfg.width, cfg.height, 32)
        o, d = o[perm], d[perm]

    axis = mesh.axis_names[0]
    n = int(mesh.devices.size)
    R = o.shape[0]
    Rp = -(-R // n) * n
    if Rp != R:
        pad = ((0, Rp - R), (0, 0))
        o = jnp.pad(o, pad)
        # padded rays get a harmless +x direction (never NaN, result cut)
        d = jnp.concatenate(
            [d, jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], d.dtype),
                         (Rp - R, 1))])

    def block(o_, d_):
        return tracer.trace_rays(scene_arrays, cfg, closest, occluded,
                                 scene.reflectivity, o_, d_)

    # check_vma=False: the traversal loops initialize carries from
    # constants (unvarying), which trips shard_map's varying-manual-axes
    # check even though every carry is per-ray and purely local
    img = shard_map(block, mesh=mesh, in_specs=(P(axis), P(axis)),
                    out_specs=P(axis), check_vma=False)(o, d)
    img = img[:R]
    if inv is not None:
        img = img[inv]
    return img.reshape(cfg.height, cfg.width, 4)
