"""Texture-gradient path: row accumulation + quad-sampler custom VJP.

The hand-written VJPs (sample_texture_bilinear_quad, gather_tile_rows)
must equal autodiff of the same math, and the row accumulator must equal
numpy's unbuffered scatter-add.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skybox_rt_tpu.diff import pipeline


@pytest.mark.parametrize("N,R,C", [(3000, 256, 16), (777, 1000, 27)])
def test_accumulate_rows_matches_scatter(N, R, C):
    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.integers(0, R, N).astype(np.int32))
    val = jnp.asarray(rng.normal(size=(N, C)).astype(np.float32))
    want = np.zeros((R, C), np.float32)
    np.add.at(want, np.asarray(idx), np.asarray(val))
    got = pipeline._accumulate_rows(idx, val, R)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_accumulate_rows_drops_out_of_range():
    idx = jnp.asarray([0, 5, 300, 5], dtype=jnp.int32)   # 300 >= R
    val = jnp.ones((4, 2), jnp.float32)
    got = np.asarray(pipeline._accumulate_rows(idx, val, 256))
    assert got[0, 0] == 1.0 and got[5, 0] == 2.0
    assert got.sum() == pytest.approx(6.0)


def _plain_quad_sample(tex_quad, u, v):
    """The same math WITHOUT the custom VJP (autodiff oracle)."""
    q, _, fx, fy = pipeline._quad_sample_prep(tex_quad, u, v)
    return pipeline._quad_lerp(q, fx, fy)


def test_quad_sampler_custom_vjp_matches_autodiff():
    rng = np.random.default_rng(1)
    th = tw = 8
    tex = jnp.asarray(rng.uniform(0, 1, (th, tw, 4)).astype(np.float32))
    tq = pipeline._quad_texture(tex)
    u = jnp.asarray(rng.uniform(-0.2, 1.2, (3, 7, 7)).astype(np.float32))
    v = jnp.asarray(rng.uniform(-0.2, 1.2, (3, 7, 7)).astype(np.float32))
    g_out = jnp.asarray(rng.normal(size=(3, 7, 7, 4)).astype(np.float32))

    def loss_custom(tq, u, v):
        return jnp.sum(pipeline.sample_texture_bilinear_quad(tq, u, v)
                       * g_out)

    def loss_plain(tq, u, v):
        return jnp.sum(_plain_quad_sample(tq, u, v) * g_out)

    gc = jax.grad(loss_custom, argnums=(0, 1, 2))(tq, u, v)
    gp = jax.grad(loss_plain, argnums=(0, 1, 2))(tq, u, v)
    for a, b, name in zip(gc, gp, ("tex_quad", "u", "v")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_quad_values_match_flat_sampler():
    rng = np.random.default_rng(2)
    tex = jnp.asarray(rng.uniform(0, 1, (16, 16, 4)).astype(np.float32))
    u = jnp.asarray(rng.uniform(0, 1, (50,)).astype(np.float32))
    v = jnp.asarray(rng.uniform(0, 1, (50,)).astype(np.float32))
    flat = pipeline.sample_texture_bilinear(tex, u, v)
    quad = pipeline.sample_texture_bilinear_quad(
        pipeline._quad_texture(tex), u, v)
    np.testing.assert_allclose(np.asarray(quad), np.asarray(flat),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,M,C", [(5, 37, 27), (3, 4, 9)])
def test_gather_tile_rows_vjp_matches_autodiff(T, M, C):
    """gather_tile_rows: forward == take_along_axis, and its scatter-add
    backward == autodiff of the plain gather."""
    rng = np.random.default_rng(3)
    table = jnp.asarray(rng.normal(size=(T, M, C)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, M, (T, 8, 8)).astype(np.int32))
    g_out = jnp.asarray(rng.normal(size=(T, 8, 8, C)).astype(np.float32))

    def plain(table):
        return jnp.take_along_axis(
            table, idx.reshape(T, -1)[..., None], axis=1
        ).reshape(T, 8, 8, C)

    np.testing.assert_array_equal(
        np.asarray(pipeline.gather_tile_rows(table, idx)),
        np.asarray(plain(table)))
    gc = jax.grad(lambda t: jnp.sum(pipeline.gather_tile_rows(t, idx)
                                    * g_out))(table)
    gp = jax.grad(lambda t: jnp.sum(plain(t) * g_out))(table)
    np.testing.assert_allclose(np.asarray(gc), np.asarray(gp),
                               rtol=1e-5, atol=1e-5)
