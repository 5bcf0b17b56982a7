"""Compute / SIMT regression apps — array-program analogs of the
reference's general-purpose regression suite (SURVEY §4.6).

The reference validates its SIMT machine with a set of small GPGPU apps
(tests/regression/{vecaddx,sgemmx,sgemm2x,conv3x,stencil3d,sort,diverge}
and the dogfood op-conformance suite, tests/regression/dogfood/testcases.h).
Each app here reproduces the same *math* with the idiomatic XLA mapping:

- per-task SIMT kernels      -> jitted elementwise / vmapped array ops
- sgemm inner-product loops  -> one matmul at full float32 precision
- divergent branches         -> predication (`jnp.where` / `jnp.select`)
- data-dependent loop bounds -> prefix sums instead of per-lane loops
- BAR/GBAR barriers          -> `lax.psum` collectives over the mesh

Oracles mirror the reference hosts' CPU verify() loops (numpy, same
formulas); tests/test_compute_apps.py asserts equality.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# vecaddx — tests/regression/vecaddx/kernel.cpp:9 (dst = src0 + src1)
# ---------------------------------------------------------------------------

@jax.jit
def vecadd(x, y):
    return x + y


# ---------------------------------------------------------------------------
# sgemmx — tests/regression/sgemmx/kernel.cpp:14-19 (naive row*col loop).
# The whole loop nest is one matmul; HIGHEST keeps float32 products (no
# TF32), matching the reference's fp32 inner loop.
# ---------------------------------------------------------------------------

@jax.jit
def sgemm(a, b):
    return jnp.dot(a, b, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


# ---------------------------------------------------------------------------
# conv3x — tests/regression/conv3x/kernel.cpp:20-35: 3x3 convolution over a
# zero-padded (w+2, h+2) input.  Nine shifted adds, which XLA fuses into
# one elementwise pass (the __local_mem weight staging is moot — the
# nine weights are scalars baked into the fused kernel).
# ---------------------------------------------------------------------------

@jax.jit
def conv3x(padded, weights):
    """padded: (H+2, W+2) float32; weights: (3, 3) -> (H, W)."""
    h, w = padded.shape[0] - 2, padded.shape[1] - 2
    out = jnp.zeros((h, w), jnp.float32)
    for dy in range(3):
        for dx in range(3):
            out = out + padded[dy:dy + h, dx:dx + w] * weights[dy, dx]
    return out


# ---------------------------------------------------------------------------
# stencil3d — tests/regression/stencil3d/kernel.cpp:16-52: mean of the 27
# clamped-index neighbors.  Edge-clamping == edge-replicate padding.
# ---------------------------------------------------------------------------

@jax.jit
def stencil3d(vol):
    """vol: (S, S, S) float32 -> 27-point clamped-neighborhood mean."""
    p = jnp.pad(vol, 1, mode="edge")
    s = vol.shape[0]
    out = jnp.zeros_like(vol)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                out = out + p[dz:dz + s, dy:dy + s, dx:dx + s]
    return out / 27.0


# ---------------------------------------------------------------------------
# sort — tests/regression/sort/kernel.cpp:9-17: per-lane stable rank count
# (pos = #{i : x[i] < x[j] or (x[i]==x[j] and i<j)}), scatter to dst[pos].
# Already a data-parallel O(n^2) formulation; the count is one
# broadcast compare + row-sum, and the scatter one take-along-axis.
# ---------------------------------------------------------------------------

@jax.jit
def rank_sort(x):
    n = x.shape[0]
    i = jnp.arange(n)
    lt = x[None, :] < x[:, None]                       # [j, i]: x_i < x_j
    tie = (x[None, :] == x[:, None]) & (i[None, :] < i[:, None])
    pos = jnp.sum(lt | tie, axis=1)
    return jnp.zeros_like(x).at[pos].set(x)


# ---------------------------------------------------------------------------
# diverge — tests/regression/diverge/kernel.cpp:8-77: a cascade of
# divergent branches, a data-dependent loop, a switch, selects and min/max.
# The reference exercises the ipdom SPLIT/JOIN stack; the array mapping is
# full predication: every branch becomes jnp.where/jnp.select and the
# `for (i < task_id) value += src[i]` loop an exclusive prefix sum.
# ---------------------------------------------------------------------------

@jax.jit
def diverge(src):
    """src: (N,) int32; returns the reference kernel's dst array."""
    n = src.shape[0]
    tid = jnp.arange(n, dtype=jnp.int32)
    value = src + 2                                     # "none taken" branch

    # nested diverge: tid>1 ? (tid>2 ? +6 : +5) : (tid>0 ? +4 : +3)
    value = value + jnp.where(tid > 1, jnp.where(tid > 2, 6, 5),
                              jnp.where(tid > 0, 4, 3))
    value = value + 7                                   # "all taken" branch

    # loop: value += sum(src[0:tid])  -> exclusive prefix sum
    excl = jnp.cumsum(src) - src
    value = value + excl

    # switch (tid): 0:+1, 1:-1, 2:*3, 3:*5, default: unchanged
    value = jnp.select(
        [tid == 0, tid == 1, tid == 2, tid == 3],
        [value + 1, value - 1, value * 3, value * 5],
        value)

    # select: tid>5 ? src[0] : tid   (tid >= 0 always)
    value = value + jnp.where(tid > 5, src[0], tid)

    # sequential min/max accumulation
    value = value + jnp.minimum(src, value)
    value = value + jnp.maximum(src, value)
    return value


def diverge_oracle(src: np.ndarray) -> np.ndarray:
    """Scalar CPU oracle, line-for-line with the reference kernel."""
    src = np.asarray(src, np.int32)
    out = np.empty_like(src)
    for tid in range(len(src)):
        value = int(src[tid]) + 2
        if tid > 1:
            value += 6 if tid > 2 else 5
        else:
            value += 4 if tid > 0 else 3
        value += 7
        for i in range(tid):
            value += int(src[i])
        if tid == 0:
            value += 1
        elif tid == 1:
            value -= 1
        elif tid == 2:
            value *= 3
        elif tid == 3:
            value *= 5
        value += int(src[0]) if tid > 5 else tid
        value += min(int(src[tid]), value)
        value += max(int(src[tid]), value)
        out[tid] = np.int32(value)
    return out


# ---------------------------------------------------------------------------
# dogfood — tests/regression/dogfood/testcases.h:876-899: 24 op-conformance
# cases (ALU/FPU/convert/clamp/trig + barriers).  Each entry is
# (jax_fn, numpy_oracle); both take (a, b) arrays.  BAR/GBAR are covered
# separately by the psum barrier test (tests/test_compute_apps.py).
# ---------------------------------------------------------------------------

def _f(fn):
    return jax.jit(fn)


DOGFOOD_CASES = {
    "iadd":  (_f(lambda a, b: a + b),            lambda a, b: a + b),
    "imul":  (_f(lambda a, b: a * b),            lambda a, b: a * b),
    # RISC-V idiv truncates toward zero; numpy's // floors — oracle uses
    # trunc division like the reference's verify loop.
    "idiv":  (_f(lambda a, b: jax.lax.div(a, b)),
              lambda a, b: (np.sign(a) * np.sign(b) *
                            (np.abs(a) // np.abs(b))).astype(a.dtype)),
    "idiv_mul": (_f(lambda a, b: jax.lax.div(a, b) * b),
                 lambda a, b: (np.sign(a) * np.sign(b) *
                               (np.abs(a) // np.abs(b))).astype(a.dtype) * b),
    "fadd":  (_f(lambda a, b: a + b),            lambda a, b: a + b),
    "fsub":  (_f(lambda a, b: a - b),            lambda a, b: a - b),
    "fmul":  (_f(lambda a, b: a * b),            lambda a, b: a * b),
    "fmadd": (_f(lambda a, b: a * b + b),        lambda a, b: a * b + b),
    "fmsub": (_f(lambda a, b: a * b - b),        lambda a, b: a * b - b),
    "fnmadd": (_f(lambda a, b: -(a * b) - b),    lambda a, b: -(a * b) - b),
    "fnmsub": (_f(lambda a, b: -(a * b) + b),    lambda a, b: -(a * b) + b),
    "fnmadd_madd": (_f(lambda a, b: (-(a * b) - b) + (a * b + b)),
                    lambda a, b: (-(a * b) - b) + (a * b + b)),
    "fdiv":  (_f(lambda a, b: a / b),            lambda a, b: a / b),
    "fdiv2": (_f(lambda a, b: (a / b) / (b / a)),
              lambda a, b: (a / b) / (b / a)),
    "fsqrt": (_f(lambda a, b: jnp.sqrt(jnp.abs(a * b))),
              lambda a, b: np.sqrt(np.abs(a * b))),
    "ftoi":  (_f(lambda a, b: (a + b).astype(jnp.int32)),
              lambda a, b: (a + b).astype(np.int32)),
    "ftou":  (_f(lambda a, b: (jnp.abs(a) + jnp.abs(b)).astype(jnp.uint32)),
              lambda a, b: (np.abs(a) + np.abs(b)).astype(np.uint32)),
    "itof":  (_f(lambda a, b: (a + b).astype(jnp.float32)),
              lambda a, b: (a + b).astype(np.float32)),
    "utof":  (_f(lambda a, b: (a + b).astype(jnp.float32)),
              lambda a, b: (a + b).astype(np.float32)),
    # fclamp — testcases.h:720: fmin(fmax(1.0, a), b)
    "fclamp": (_f(lambda a, b: jnp.minimum(jnp.maximum(1.0, a), b)),
               lambda a, b: np.minimum(np.maximum(1.0, a), b)),
    "iclamp": (_f(lambda a, b: jnp.minimum(jnp.maximum(1, a), b)),
               lambda a, b: np.minimum(np.maximum(1, a), b)),
    # trigo — testcases.h:786-789: ref = a*b, sin() on every 4th lane
    "trigo": (_f(lambda a, b: jnp.where(
                    jnp.arange(a.shape[0]) % 4 == 0, jnp.sin(a * b), a * b)),
              lambda a, b: np.where(np.arange(a.shape[0]) % 4 == 0,
                                    np.sin(a * b), a * b)),
}
