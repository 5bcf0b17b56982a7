"""Bucketed gradient all-reduce with engineered compute/communication
overlap (SURVEY §2.8: "explicit overlap of gradient psum with backward
compute"; VERDICT r1 #9).

Design (the DDP-bucketing recipe):
  * gradients are flattened and greedily packed into `n_buckets` roughly
    size-balanced buckets; each bucket is ONE concatenated psum instead of
    one psum per parameter — fewer, larger ICI collectives (latency is
    per-collective; bandwidth is what we want to pay for)
  * each bucket's psum depends only on ITS leaves, so XLA's latency-hiding
    scheduler can issue bucket k's all-reduce-start while the backward
    compute feeding bucket k+1 is still running — the async-pair
    (all-reduce-start / all-reduce-done) separation in the scheduled HLO
    is the checkable artifact (see `collective_schedule_report`)
  * numerics are exactly a per-leaf psum (concat/split commutes with the
    elementwise sum)

Verification story on this hardware: a single real chip elides psums and
the CPU mesh runs collectives synchronously, so overlap cannot be
*timed* here.  What CAN be checked (tests/test_overlap.py) is (a) exact
numerical equality with unbucketed psums on the 8-device CPU mesh and
(b) the compiled module containing exactly n_buckets all-reduces.  On a
real multi-chip slice, `collective_schedule_report` on the scheduled HLO
shows whether starts are hoisted away from dones.
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp


def _bucketed_reduce(tree, n_buckets: int, reduce_flat):
    """Shared bucketing: pack leaves (grouped by dtype, size-balanced)
    into concatenated flats, apply `reduce_flat` to each, split back."""
    leaves, treedef = jax.tree.flatten(tree)
    if not leaves:
        return tree

    by_dtype = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(jnp.result_type(leaf), []).append(i)

    out = [None] * len(leaves)
    for group in by_dtype.values():
        nb = max(1, min(n_buckets, len(group)))
        order = sorted(group, key=lambda i: -leaves[i].size)
        buckets = [[] for _ in range(nb)]
        fill = [0] * nb
        for i in order:
            b = fill.index(min(fill))
            buckets[b].append(i)
            fill[b] += leaves[i].size

        for idx in buckets:
            if not idx:
                continue
            flat = jnp.concatenate([leaves[i].ravel() for i in idx])
            flat = reduce_flat(flat)
            off = 0
            for i in idx:
                n = leaves[i].size
                out[i] = flat[off:off + n].reshape(leaves[i].shape)
                off += n
    return jax.tree.unflatten(treedef, out)


def bucketed_psum(tree, axis_name: str, n_buckets: int = 3):
    """psum a gradient pytree as (up to) `n_buckets` concatenated
    collectives.

    Leaves are grouped BY DTYPE (so each concatenated psum reduces in the
    leaf's native dtype — exact vs a per-leaf psum for every dtype, not
    just f32), then packed greedily (largest first) into the currently
    smallest bucket, so buckets are size-balanced; each bucket is
    flattened, concatenated, psum-ed once, then split back.  A mixed-dtype
    tree may therefore emit more than `n_buckets` collectives (one set per
    dtype); the homogeneous-f32 gradient case emits exactly `n_buckets`.
    """
    return _bucketed_reduce(
        tree, n_buckets, lambda flat: jax.lax.psum(flat, axis_name))


def two_level_psum(tree, dcn_axis: str, ici_axis: str, n_buckets: int = 3):
    """Slice-aware gradient all-reduce for (hosts, chips) meshes
    (SURVEY §2.8 multi-slice/DCN; VERDICT r3 missing #3).

    A flat psum over both mesh axes moves every byte of the gradient
    across the slow DCN axis on every host.  The 2-level decomposition
    per bucket:

      1. reduce-scatter over the fast ICI axis (`lax.psum_scatter`):
         each chip ends up owning the fully-ICI-reduced 1/|ici| shard
      2. all-reduce the SHARD over the DCN axis (`lax.psum`): cross-host
         bytes drop by |ici| and all |ici| chips' DCN transfers run in
         parallel (each host's chips carry disjoint shards)
      3. all-gather the shards back over ICI (`lax.all_gather`)

    Numerically this is a psum with a different (still deterministic)
    reduction grouping: integer-valued f32 gradients reduce exactly;
    generic f32 differs from a flat psum only by addition order.
    Use inside shard_map over a mesh whose axes are (dcn_axis, ici_axis)
    = mesh.make_mesh_2d's ("hosts", "tiles").
    """
    def reduce_flat(flat):
        n_ici = jax.lax.axis_size(ici_axis)
        n = flat.shape[0]
        padded = -(-n // n_ici) * n_ici
        if padded != n:
            flat = jnp.pad(flat, (0, padded - n))
        shard = jax.lax.psum_scatter(flat, ici_axis, scatter_dimension=0,
                                     tiled=True)
        shard = jax.lax.psum(shard, dcn_axis)
        out = jax.lax.all_gather(shard, ici_axis, axis=0, tiled=True)
        return out[:n]

    return _bucketed_reduce(tree, n_buckets, reduce_flat)


def count_all_reduces(text: str) -> int:
    """Number of all-reduce collectives in an HLO or StableHLO dump
    (async start/done pairs and tupled combiner outputs count once)."""
    # count DEFINITIONS only — each start is also referenced by name in
    # its done instruction, so a bare substring count overcounts
    starts = len(re.findall(
        r"=\s*(?:\([^)]*\)|\S+)?\s*all-reduce-start\(", text))
    if starts:
        return starts
    hlo = len(re.findall(r"=\s*(?:\([^)]*\)|\S+)\s+all-reduce\(", text))
    if hlo:
        return hlo
    return len(re.findall(r"stablehlo\.all_reduce", text))


def collective_schedule_report(compiled_text: str) -> list:
    """For each async all-reduce pair in a scheduled HLO dump, report how
    many instructions the scheduler placed between start and done — the
    direct artifact of compute/communication overlap (0 = no overlap).

    Returns [(name, gap_instructions), ...].
    """
    lines = compiled_text.splitlines()
    starts = {}
    report = []
    for pos, ln in enumerate(lines):
        # result shape may be a parenthesized tuple, e.g.
        #   %ars = (f32[8]{0}, f32[8]{0}) all-reduce-start(...)
        m = re.search(r"(%?[\w.\-]+)\s*=\s*(?:\([^)]*\)|\S+)?\s*"
                      r"all-reduce-start", ln)
        if m:
            starts[m.group(1).rstrip(" =")] = pos
            continue
        # operand is preceded by its (possibly tuple) type, e.g.
        #   all-reduce-done((f32[1024]{0}, f32[1024]{0}) %ars.2)
        # so capture the LAST %name before the closing paren
        m = re.search(r"all-reduce-done\(.*(%[\w.\-]+)\)", ln)
        if m:
            key = m.group(1)
            if key in starts:
                report.append((key, pos - starts[key] - 1))
    return report
