"""Inverse-rendering optimization loop: failure detection + checkpoint/resume
(SURVEY §5: the reference has neither — renders are seconds-long; the
north-star inverse-rendering runs are not, so the framework adds the
minimal production loop: NaN/inf gradient detection, retry-from-last-good
parameter state, and .npz checkpoints of the parameter tree).
"""
from __future__ import annotations

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..utils import tracing


@dataclasses.dataclass
class FitResult:
    params: dict
    losses: list
    bad_steps: int            # steps rejected by the NaN/inf guard
    resumed_from: int         # step index restored from checkpoint (0 = fresh)


def _all_finite(tree) -> bool:
    leaves = jax.tree_util.tree_leaves(tree)
    return all(bool(jnp.all(jnp.isfinite(leaf))) for leaf in leaves)


def make_step(loss_fn, optimizer):
    """jitted (params, opt_state, *args) -> (params, opt_state, loss, grads).

    The gradient psum for sharded losses lives inside loss_fn (the
    tile-parallel train step builds it with shard_map, parallel.tile_shard);
    this wrapper only owns the optimizer update.
    """
    @jax.jit
    def step(params, opt_state, *args):
        loss, grads = jax.value_and_grad(loss_fn)(params, *args)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, grads

    return step


def fit(loss_fn, params, *args, steps: int = 100, lr: float = 1e-2,
        checkpoint_dir: str | None = None, checkpoint_every: int = 25,
        optimizer=None) -> FitResult:
    """Optimize params to minimize loss_fn(params, *args).

    Failure handling (the framework's elastic-recovery policy, SURVEY §5):
      * non-finite loss or gradients -> the step is rejected, parameters
        roll back to the last good state, and the learning rate is halved
        for subsequent steps (a bad step must not corrupt the run)
      * checkpoint_dir enables .npz checkpoints of the parameter tree
        every checkpoint_every steps; a later fit() with the same dir
        resumes from the newest one
    """
    optimizer = optimizer or optax.adam(lr)

    start_step = 0
    if checkpoint_dir:
        latest = latest_checkpoint(checkpoint_dir)
        if latest is not None:
            start_step, params = load_checkpoint(latest, params)
            tracing.trace_log(1, f"resumed from checkpoint step "
                                 f"{start_step}")

    opt_state = optimizer.init(params)
    step = make_step(loss_fn, optimizer)

    losses = []
    bad_steps = 0
    lr_scale = 1.0
    good_params = params
    for i in range(start_step, steps):
        with tracing.stage("optim_step"):
            new_params, opt_state, loss, grads = step(params, opt_state,
                                                      *args)
        loss_val = float(loss)
        if not np.isfinite(loss_val) or not _all_finite(grads):
            # failure detected: roll back and damp the USER's optimizer by
            # chaining a scale onto its updates (swapping optimizers here
            # would pair the old opt_state with a new update rule)
            bad_steps += 1
            lr_scale *= 0.5
            params = good_params
            damped = optax.chain(optimizer, optax.scale(lr_scale))
            opt_state = damped.init(params)
            tracing.trace_log(
                1, f"step {i}: non-finite loss/grads, rolled back "
                   f"(lr_scale={lr_scale})")
            step = make_step(loss_fn, damped)
            continue
        params = new_params
        good_params = params
        losses.append(loss_val)

        if checkpoint_dir and ((i + 1) % checkpoint_every == 0
                               or i + 1 == steps):
            save_checkpoint(checkpoint_dir, i + 1, params)

    return FitResult(params=params, losses=losses, bad_steps=bad_steps,
                     resumed_from=start_step)


#: checkpoints kept per directory (older ones are deleted)
KEEP_CHECKPOINTS = 3


def _checkpoint_files(checkpoint_dir: str) -> list:
    return sorted(glob.glob(os.path.join(checkpoint_dir, "step_*.npz")))


def latest_checkpoint(checkpoint_dir: str):
    """Path of the newest checkpoint in checkpoint_dir, or None."""
    files = _checkpoint_files(checkpoint_dir)
    return files[-1] if files else None


def save_checkpoint(checkpoint_dir: str, step: int, params) -> str:
    """Write the parameter tree's leaves to step_<step>.npz (atomically:
    a crash mid-write leaves the previous checkpoints intact)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    leaves = jax.tree_util.tree_leaves(params)
    path = os.path.join(checkpoint_dir, f"step_{step:09d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, step=np.int64(step),
             **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
    os.replace(tmp, path)
    for old in _checkpoint_files(checkpoint_dir)[:-KEEP_CHECKPOINTS]:
        os.remove(old)
    return path


def load_checkpoint(path: str, like):
    """(step, params) from a checkpoint; `like` gives the tree structure
    (the checkpoint stores the leaves in tree_leaves order)."""
    treedef = jax.tree_util.tree_structure(like)
    with np.load(path) as z:
        leaves = [jnp.asarray(z[f"leaf_{i}"])
                  for i in range(treedef.num_leaves)]
        step = int(z["step"])
    return step, jax.tree_util.tree_unflatten(treedef, leaves)
