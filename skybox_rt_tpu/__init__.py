"""skybox_rt_tpu — differentiable rasterizer & ray tracer in JAX.

Importing the package is side-effect-free except for enabling JAX's
persistent compilation cache, so later processes start warm.  Where
JAX_COMPILATION_CACHE_DIR is set, JAX keeps its cache there and this
package sets nothing; otherwise the cache lives in one fixed directory
of the checkout (CACHE_DIR, git-ignored).
"""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def _enable_compile_cache():
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return                  # JAX reads the variable itself
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
        import jax
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except OSError:
        pass            # cache is an optimization, never a requirement


_enable_compile_cache()
