"""Inverse-rendering loop: failure detection, rollback, checkpoint/resume
(SURVEY §5 failure-detection/checkpoint subsystems)."""
import os

import jax
import jax.numpy as jnp
import numpy as np

from skybox_rt_tpu.diff import binning as dbin
from skybox_rt_tpu.diff import optim, pipeline
from skybox_rt_tpu.models import scenes
from skybox_rt_tpu.utils import tracing


def _setup():
    full, indices = scenes.triangle()
    full = {k: jnp.asarray(v) for k, v in full.items()}
    cfg = pipeline.DiffRenderConfig(width=16, height=16, tile_logsize=3)
    static = dbin.bin_static(np.asarray(full["pos"]), indices, 16, 16,
                             tile_logsize=3)
    static = {k: jnp.asarray(v) for k, v in static.items()}
    target = pipeline.render_cropped(
        {**full, "color": full["color"] * 0.5}, static, cfg)

    # optimize vertex colors (geometry fixed): the loop-machinery test —
    # full-parameter inverse rendering is covered in tests/test_diff.py
    params = {"color": full["color"]}

    def loss_fn(p, static, target):
        img = pipeline.render_cropped({**full, **p}, static, cfg)
        return jnp.mean((img - target) ** 2)

    return params, static, target, loss_fn


def test_fit_converges():
    params, static, target, loss_fn = _setup()
    res = optim.fit(loss_fn, params, static, target, steps=60, lr=2e-2)
    assert res.losses[-1] < res.losses[0] * 0.25
    assert res.bad_steps == 0


def test_nan_guard_rolls_back():
    params, static, target, loss_fn = _setup()

    # clean run: no rollbacks
    res = optim.fit(loss_fn, params, static, target, steps=5, lr=1e-2)
    assert res.bad_steps == 0

    # fault injection: NaN loss every step -> every step rejected, params
    # stay finite and untouched
    def always_nan(p, static, target):
        return jnp.sum(p["color"]) * jnp.nan

    res2 = optim.fit(always_nan, params, static, target, steps=3, lr=1e-2)
    assert res2.bad_steps == 3
    assert np.all(np.isfinite(np.asarray(res2.params["color"])))
    np.testing.assert_array_equal(np.asarray(res2.params["color"]),
                                  np.asarray(params["color"]))


def test_checkpoint_resume(tmp_path):
    params, static, target, loss_fn = _setup()
    ckdir = str(tmp_path / "ck")
    res1 = optim.fit(loss_fn, params, static, target, steps=20, lr=1e-2,
                     checkpoint_dir=ckdir, checkpoint_every=10)
    # resume: a new fit with the same dir picks up at step 20 and does
    # nothing more (steps=20 already done)
    res2 = optim.fit(loss_fn, params, static, target, steps=20, lr=1e-2,
                     checkpoint_dir=ckdir, checkpoint_every=10)
    assert res2.resumed_from == 20
    np.testing.assert_allclose(np.asarray(res2.params["color"]),
                               np.asarray(res1.params["color"]), rtol=1e-6)
    # and a longer fit continues from there
    res3 = optim.fit(loss_fn, params, static, target, steps=25, lr=1e-2,
                     checkpoint_dir=ckdir, checkpoint_every=10)
    assert res3.resumed_from == 20
    assert len(res3.losses) == 5


def test_stage_tracing():
    tracing.reset_stages()
    with tracing.stage("demo_stage"):
        jnp.ones((4,)).sum()
    rep = tracing.stage_report()
    assert "demo_stage" in rep and rep["demo_stage"]["calls"] == 1


def test_checkpoint_files_roundtrip_and_pruning(tmp_path):
    """.npz checkpoints: leaves round-trip exactly, the newest wins, and
    only optim.KEEP_CHECKPOINTS files stay."""
    params = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": {"c": np.ones((4,), np.float32)}}
    d = str(tmp_path / "ck")
    for step in range(1, 6):
        p = jax.tree_util.tree_map(lambda x, s=step: x * s, params)
        optim.save_checkpoint(d, step, p)
    files = sorted(os.listdir(d))
    assert len(files) == optim.KEEP_CHECKPOINTS
    step, restored = optim.load_checkpoint(optim.latest_checkpoint(d),
                                           params)
    assert step == 5
    np.testing.assert_array_equal(np.asarray(restored["a"]), params["a"] * 5)
    np.testing.assert_array_equal(np.asarray(restored["b"]["c"]),
                                  params["b"]["c"] * 5)
