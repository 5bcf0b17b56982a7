"""Regenerate the config-3 self-golden (tests/test_config3.py).

Run on CPU so the pin is platform-stable:
  python scripts/make_config3_golden.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from skybox_rt_tpu.rt import raster_bridge  # noqa: E402
from skybox_rt_tpu.utils import image  # noqa: E402


def main():
    rt = raster_bridge.render_scene_rt(
        "vase", 128, 128, engine="auto", camera="perspective")
    rgba = np.clip(rt * 255.0 + 0.5, 0, 255).astype(np.uint32)
    fb = ((rgba[..., 3] << 24) | (rgba[..., 0] << 16)
          | (rgba[..., 1] << 8) | rgba[..., 2]).astype(np.uint32)
    out = os.path.join(os.path.dirname(__file__), "..", "tests",
                       "goldens", "config3_vase_128_rt.png")
    image.save_framebuffer_png(out, fb)
    print("wrote", out)


if __name__ == "__main__":
    main()
