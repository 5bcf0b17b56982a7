"""Device facade — the public runtime API (vortex.h analog, SURVEY §2.2 H1).

The reference exposes open/caps/alloc/copy/start/ready_wait/dcr_write
(runtime/include/vortex.h:74-139).  Under JAX, JAX owns memory and
execution, so the equivalents are:

  vx_dev_open / vx_dev_caps      -> Device() / Device.caps
  vx_mem_alloc + vx_copy_to_dev  -> Device.upload (with access validation,
                                    the ACL concept of sim/common/mem.h:159)
  vx_copy_from_dev               -> Device.download
  vx_dcr_write                   -> RenderState construction (core.state)
  vx_start + vx_ready_wait       -> Device.run (dispatch + block)
  vx_mpm_query / vx_dump_perf    -> Device.perf / Device.dump_perf

It is also the one place that picks a compute route for the device:
rt_engine() names the ray-traversal engine the tracer runs by default.
"""
from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from . import perf as perf_mod


class DeviceError(RuntimeError):
    pass


#: ray-traversal engine per platform: the compiled GPU kernel
#: (ops.traverse) on a CUDA device, the XLA stackless walk elsewhere
RT_ENGINES = {"gpu": "kernel", "cpu": "bvh"}


def rt_engine(platform: str | None = None) -> str:
    """The traversal engine for `platform` (default: JAX's first device).

    Never picks the Pallas interpreter — interpret mode is reached only
    through an explicit argument (tests)."""
    platform = platform or jax.devices()[0].platform
    try:
        return RT_ENGINES[platform]
    except KeyError:
        raise DeviceError(
            f"no ray-traversal route for platform {platform!r}") from None


@dataclasses.dataclass(frozen=True)
class DeviceCaps:
    """vx_dev_caps analog (VX_CAPS_*, vortex.h:30-40)."""
    platform: str
    num_devices: int
    device_kind: str
    memory_per_device: int | None
    # ISA-flag analog: which pipeline extensions this build provides
    has_raster: bool = True
    has_tex: bool = True
    has_om: bool = True
    has_rt: bool = True


class Buffer:
    """Device buffer handle with access flags (vx_mem_alloc's
    VX_MEM_READ / VX_MEM_READ_WRITE, enforced like the ACL manager)."""

    READ = 1
    WRITE = 2

    def __init__(self, array: jax.Array, access: int):
        self._array = array
        self.access = access

    @property
    def array(self) -> jax.Array:
        return self._array

    def write(self, new_array):
        if not (self.access & Buffer.WRITE):
            raise DeviceError("buffer is read-only (VX_MEM_READ)")
        if (new_array.shape != self._array.shape
                or new_array.dtype != self._array.dtype):
            raise DeviceError(
                f"shape/dtype mismatch: {new_array.shape}/{new_array.dtype} "
                f"vs {self._array.shape}/{self._array.dtype}")
        # keep the buffer on the device it was allocated on (the vx_mem
        # placement contract), not wherever the default backend lives
        dev = list(self._array.devices())[0]
        self._array = jax.device_put(jnp.asarray(new_array), dev)


class Device:
    """One logical accelerator (or mesh of them)."""

    def __init__(self, platform: str | None = None):
        devices = jax.devices(platform) if platform else jax.devices()
        if not devices:
            raise DeviceError("no devices")
        self._devices = devices
        self.perf = perf_mod.PerfCounters()

    @property
    def caps(self) -> DeviceCaps:
        d = self._devices[0]
        mem = None
        try:
            stats = d.memory_stats()
            if stats:
                mem = stats.get("bytes_limit")
        except Exception:
            pass
        return DeviceCaps(
            platform=d.platform,
            num_devices=len(self._devices),
            device_kind=d.device_kind,
            memory_per_device=mem,
        )

    def upload(self, host_array, access: int = Buffer.READ) -> Buffer:
        """vx_mem_alloc + vx_copy_to_dev."""
        arr = jax.device_put(jnp.asarray(host_array), self._devices[0])
        self.perf.count("host_to_device_bytes", arr.nbytes)
        return Buffer(arr, access)

    def download(self, buf: Buffer) -> np.ndarray:
        """vx_copy_from_dev."""
        out = np.asarray(buf.array)
        self.perf.count("device_to_host_bytes", out.nbytes)
        return out

    def run(self, fn, *args, timeout_s: float | None = None):
        """vx_start + vx_ready_wait: dispatch and block until done.

        timeout_s mirrors vx_ready_wait's polling timeout
        (runtime/simx/vortex.cpp:195-209) — JAX dispatch is async, so the
        timeout guards the block_until_ready wait via a watchdog.
        """
        t0 = time.perf_counter()
        out = fn(*args)
        if timeout_s is None:
            jax.block_until_ready(out)
        else:
            # true watchdog: poll readiness like vx_ready_wait's 1 s loop
            # (runtime/simx/vortex.cpp:195-209) instead of blocking —
            # a hung dispatch raises instead of waiting forever
            deadline = t0 + timeout_s
            leaves = [x for x in jax.tree_util.tree_leaves(out)
                      if hasattr(x, "is_ready")]
            poll = min(max(timeout_s / 100.0, 0.001), 1.0)
            while not all(x.is_ready() for x in leaves):
                if time.perf_counter() > deadline:
                    raise DeviceError(
                        f"device run exceeded {timeout_s}s timeout")
                time.sleep(poll)
            jax.block_until_ready(out)   # surface any execution error
        self.perf.count("kernel_launches", 1)
        self.perf.add_time("device_ms", (time.perf_counter() - t0) * 1e3)
        return out

    def dump_perf(self, file=None):
        """vx_dump_perf analog."""
        self.perf.dump(file=file)
