"""Worker for tests/test_multiprocess.py — one of N jax.distributed
processes on the CPU platform (4 local virtual devices each).

The analog of the reference's multi-cluster config sweeps
(/root/reference/ci/regression.sh.in graphics(): --clusters=2 --cores=2):
the same sharded programs that run on the single-process 8-device test
mesh execute here across 2 OS processes x 4 devices with a real
jax.distributed coordination service, proving parallel/mesh.py's
initialize wrapper and the global-mesh code paths multi-process clean.

Usage: python multiprocess_worker.py <coordinator> <num_procs> <pid> <out.json>
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))          # repo root (package import)

# platform + local device count must be pinned before first jax use
os.environ["XLA_FLAGS"] = (
    os.environ.get("SKYBOX_MP_XLA_FLAGS",
                   "--xla_force_host_platform_device_count=4"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main():
    coordinator, num_procs, pid, out_path = sys.argv[1:5]
    num_procs = int(num_procs)
    pid = int(pid)

    from skybox_rt_tpu.parallel import mesh as mesh_mod

    mesh_mod.initialize_distributed(coordinator, num_procs, pid)
    n_local = jax.local_device_count()
    n_global = jax.device_count()

    from skybox_rt_tpu.diff import binning as dbin
    from skybox_rt_tpu.diff import pipeline
    from skybox_rt_tpu.models import scenes
    from skybox_rt_tpu.parallel import tile_shard

    mesh = mesh_mod.make_mesh(n_global)

    def garr(x, spec):
        """Wrap process-local (fully known) data as a global array."""
        x = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, sh,
                                            lambda idx: x[idx])

    # identical scene on every process (replicated-geometry strategy)
    params, indices = scenes.triangle()
    cfg = pipeline.DiffRenderConfig(width=32, height=32, tile_logsize=3)
    static = dbin.bin_static(np.asarray(params["pos"]), indices, 32, 32,
                             tile_logsize=3)
    sharded = tile_shard.shard_tiles(static, n_global)

    axis = mesh.axis_names[0]
    params_g = {k: garr(v, P()) for k, v in params.items()}
    arrays_g = {
        "indices": garr(sharded["indices"], P()),
        "tile_pids": garr(sharded["tile_pids"], P(axis)),
        "tile_xy": garr(sharded["tile_xy"], P(axis)),
        "tile_valid": garr(sharded["tile_valid"], P(axis)),
    }
    target = np.zeros((sharded["tile_xy"].shape[0], 8, 8, 4), np.float32)
    target_g = garr(target, P(axis))

    # 1. sharded forward render across processes
    render = tile_shard.make_sharded_render(mesh, cfg)
    img = render(params_g, {
        "indices": arrays_g["indices"],
        "tile_pids": arrays_g["tile_pids"],
        "tile_xy": arrays_g["tile_xy"],
        "tile_valid": arrays_g["tile_valid"],
    })
    img_np = np.asarray(jax.device_get(img))

    # 2. sharded train step (grad all-reduce crosses the process boundary)
    step = tile_shard.make_train_step(mesh, cfg, lr=1e-4)
    new_params, loss, maxw = step(params_g, arrays_g, target_g)
    loss = float(loss)
    color_sum = float(jnp.sum(new_params["color"]))

    with open(out_path, "w") as f:
        json.dump({
            "pid": pid,
            "local_devices": n_local,
            "global_devices": n_global,
            "img_sum": float(img_np.sum()),
            "img_sha": int(np.frombuffer(
                img_np.tobytes(), np.uint8).sum()),
            "loss": loss,
            "max_writes": int(maxw),
            "color_sum": color_sum,
        }, f)
    print(f"worker {pid} done", flush=True)


if __name__ == "__main__":
    main()
