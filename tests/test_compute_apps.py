"""Compute/SIMT regression apps vs their CPU oracles (SURVEY §4.6).

Mirrors the reference's general-purpose suite — vecaddx, sgemmx, sgemm2x,
conv3x, stencil3d, sort, diverge, dogfood, and the BAR/GBAR barrier cases —
with each host's verify() loop reimplemented as the numpy oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skybox_rt_tpu.apps import compute


def rng(seed=0):
    return np.random.default_rng(seed)


def test_vecadd():
    r = rng(1)
    a = r.standard_normal(4096).astype(np.float32)
    b = r.standard_normal(4096).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(compute.vecadd(a, b)), a + b)


def test_sgemm():
    r = rng(2)
    a = r.standard_normal((128, 96)).astype(np.float32)
    b = r.standard_normal((96, 64)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(compute.sgemm(a, b)), a @ b,
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(256, 384, 128), (33, 1000, 7)])
def test_sgemm_full_precision(m, k, n):
    """sgemm/sgemm2x analog: the one-matmul sgemm keeps float32 products
    (precision HIGHEST), so it matches a float64 product to float32
    accumulation error at any shape."""
    r = rng(3)
    a = r.standard_normal((m, k)).astype(np.float32)
    b = r.standard_normal((k, n)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = compute.sgemm(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * np.sqrt(k))


def test_conv3x():
    r = rng(4)
    h, w = 33, 47
    padded = np.zeros((h + 2, w + 2), np.float32)
    padded[1:-1, 1:-1] = r.standard_normal((h, w)).astype(np.float32)
    wts = r.standard_normal((3, 3)).astype(np.float32)
    ref = np.zeros((h, w), np.float32)
    for y in range(h):                        # conv3x/kernel.cpp:20-35
        for x in range(w):
            ref[y, x] = np.sum(padded[y:y + 3, x:x + 3] * wts,
                               dtype=np.float32)
    got = np.asarray(compute.conv3x(padded, wts))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_stencil3d():
    r = rng(5)
    s = 9
    vol = r.standard_normal((s, s, s)).astype(np.float32)
    ref = np.zeros_like(vol)
    for z in range(s):                        # stencil3d/kernel.cpp:16-52
        for y in range(s):
            for x in range(s):
                acc = 0.0
                for dz in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            nz = min(max(z + dz, 0), s - 1)
                            ny = min(max(y + dy, 0), s - 1)
                            nx = min(max(x + dx, 0), s - 1)
                            acc += vol[nz, ny, nx]
                ref[z, y, x] = acc / 27.0
    np.testing.assert_allclose(np.asarray(compute.stencil3d(vol)), ref,
                               rtol=1e-5, atol=1e-5)


def test_rank_sort_stable_with_duplicates():
    r = rng(6)
    x = r.integers(0, 50, size=257).astype(np.int32)   # duplicates certain
    got = np.asarray(compute.rank_sort(x))
    np.testing.assert_array_equal(got, np.sort(x, kind="stable"))


def test_diverge():
    r = rng(7)
    src = r.integers(-20, 20, size=64).astype(np.int32)
    got = np.asarray(compute.diverge(src))
    np.testing.assert_array_equal(got, compute.diverge_oracle(src))


@pytest.mark.parametrize("name", sorted(compute.DOGFOOD_CASES))
def test_dogfood(name):
    r = rng(hash(name) % 2**31)
    fn, oracle = compute.DOGFOOD_CASES[name]
    n = 256
    if name.startswith("i"):
        a = r.integers(-1000, 1000, size=n).astype(np.int32)
        b = r.integers(1, 1000, size=n).astype(np.int32)  # no div-by-zero
    else:
        a = (r.standard_normal(n) * 4 + 0.5).astype(np.float32)
        b = (np.abs(r.standard_normal(n)) + 0.5).astype(np.float32)
    got = np.asarray(fn(jnp.asarray(a), jnp.asarray(b)))
    ref = oracle(a, b)
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)


def test_barrier_psum():
    """BAR/GBAR analog (dogfood testcases.h:798-874): every lane deposits a
    value, barrier, every lane reads the full reduction."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from skybox_rt_tpu.parallel import mesh as mesh_mod

    n = min(8, len(jax.devices()))
    mesh = mesh_mod.make_mesh(n)
    axis = mesh.axis_names[0]

    def body(x):
        total = jax.lax.psum(x, axis)          # the barrier + reduction
        return total - x                        # every lane sees all others

    x = jnp.arange(n, dtype=jnp.float32)
    out = shard_map(body, mesh=mesh, in_specs=P(axis),
                    out_specs=P(axis))(x)
    ref = np.full(n, np.arange(n).sum(), np.float32) - np.arange(n)
    np.testing.assert_array_equal(np.asarray(out), ref)
