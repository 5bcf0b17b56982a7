"""OpenCL/POCL benchmark-suite analogs (SURVEY §4: tests/opencl/).

The reference runs a POCL port of Rodinia/NVIDIA OpenCL benchmarks on its
SIMT machine.  Each function here is the array-program mapping of one
app's kernel math; tests/test_opencl_apps.py oracles them against numpy (the
hosts' verify loops).  Covered: saxpy, dotproduct, psum, transpose,
blackscholes, nearn, kmeans, spmv, bfs, gaussian, sfilter, sgemm3.
vecadd/sgemm/sgemm2/conv3/stencil/psort duplicate the regression apps
(apps/compute.py) and oclprintf is jax.debug.print — not repeated.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

F32 = jnp.float32


# ---------------------------------------------------------------------------
# saxpy / dotproduct / psum / transpose — tests/opencl/{saxpy,dotproduct,
# psum,transpose}: the elementwise / reduction / layout primitives.  The
# tree-reduction kernels collapse to single jnp reductions (XLA emits
# the tree) and transpose is a relayout the compiler fuses.
# ---------------------------------------------------------------------------

@jax.jit
def saxpy(a, x, y):
    return a * x + y


@jax.jit
def dotproduct(x, y):
    return jnp.sum(x * y)


@jax.jit
def psum_reduce(x):
    return jnp.sum(x)


@jax.jit
def transpose(a):
    return a.T


# ---------------------------------------------------------------------------
# blackscholes — tests/opencl/blackscholes/BlackScholes.cl: the NVIDIA
# sample.  Polynomial cumulative-normal approximation, call+put per option.
# Pure elementwise math, one fused pass over five input arrays.
# ---------------------------------------------------------------------------

_CND_A = (0.31938153, -0.356563782, 1.781477937, -1.821255978, 1.330274429)
_RSQRT2PI = 0.39894228040143267794


def _cnd(d):
    a1, a2, a3, a4, a5 = _CND_A
    k = 1.0 / (1.0 + 0.2316419 * jnp.abs(d))
    poly = k * (a1 + k * (a2 + k * (a3 + k * (a4 + k * a5))))
    cnd = _RSQRT2PI * jnp.exp(-0.5 * d * d) * poly
    return jnp.where(d > 0, 1.0 - cnd, cnd)


@jax.jit
def blackscholes(S, X, T, R, V):
    """-> (call, put) per option."""
    sqrtT = jnp.sqrt(T)
    d1 = (jnp.log(S / X) + (R + 0.5 * V * V) * T) / (V * sqrtT)
    d2 = d1 - V * sqrtT
    cnd1 = _cnd(d1)
    cnd2 = _cnd(d2)
    expRT = jnp.exp(-R * T)
    call = S * cnd1 - X * expRT * cnd2
    put = X * expRT * (1.0 - cnd2) - S * (1.0 - cnd1)
    return call, put


def blackscholes_oracle(S, X, T, R, V):
    def cnd(d):
        a1, a2, a3, a4, a5 = _CND_A
        k = 1.0 / (1.0 + 0.2316419 * np.abs(d))
        poly = k * (a1 + k * (a2 + k * (a3 + k * (a4 + k * a5))))
        c = _RSQRT2PI * np.exp(-0.5 * d * d) * poly
        return np.where(d > 0, 1.0 - c, c)
    sqrtT = np.sqrt(T)
    d1 = (np.log(S / X) + (R + 0.5 * V * V) * T) / (V * sqrtT)
    d2 = d1 - V * sqrtT
    expRT = np.exp(-R * T)
    call = S * cnd(d1) - X * expRT * cnd(d2)
    put = X * expRT * (1.0 - cnd(d2)) - S * (1.0 - cnd(d1))
    return call, put


# ---------------------------------------------------------------------------
# nearn — tests/opencl/nearn: per-record euclidean distance to a query
# (lat/lng), host takes the min.  One broadcast + reduction.
# ---------------------------------------------------------------------------

@jax.jit
def nearn(points, query):
    """points (N, D), query (D,) -> (distances (N,), argmin)."""
    dist = jnp.sqrt(jnp.sum((points - query) ** 2, axis=1))
    return dist, jnp.argmin(dist)


# ---------------------------------------------------------------------------
# kmeans — tests/opencl/kmeans/kernel.cl: assignment step = argmin distance
# over clusters; the host then recomputes centroids.  One (N, K)
# distance matrix from the matmul-friendly quadratic expansion (float32
# products: HIGHEST, no TF32) + segment_sum centroid update.
# ---------------------------------------------------------------------------

@jax.jit
def kmeans_assign(points, centroids):
    """points (N, D), centroids (K, D) -> (N,) cluster ids."""
    d2 = (jnp.sum(points ** 2, 1)[:, None]
          - 2.0 * jnp.dot(points, centroids.T,
                          precision=jax.lax.Precision.HIGHEST)
          + jnp.sum(centroids ** 2, 1)[None, :])
    return jnp.argmin(d2, axis=1)


@functools.partial(jax.jit, static_argnames=("k",))
def kmeans_update(points, assign, k: int):
    """Mean of each cluster's members (empty clusters keep 0)."""
    sums = jax.ops.segment_sum(points, assign, num_segments=k)
    counts = jax.ops.segment_sum(jnp.ones((points.shape[0],), F32),
                                 assign, num_segments=k)
    return sums / jnp.maximum(counts, 1.0)[:, None]


# ---------------------------------------------------------------------------
# spmv — tests/opencl/spmv: CSR sparse matrix-vector product.  Gather x by column index, multiply by values, segment-sum by row.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("num_rows",))
def spmv_csr(values, col_idx, row_id, x, num_rows: int):
    """CSR with precomputed per-nonzero row ids (row_ptr expanded):
    y[r] = sum over nonzeros of row r of values * x[col]."""
    prod = values * x[col_idx]
    return jax.ops.segment_sum(prod, row_id, num_segments=num_rows)


def expand_row_ptr(row_ptr: np.ndarray) -> np.ndarray:
    """Host-side CSR row_ptr (R+1,) -> per-nonzero row ids (nnz,)."""
    counts = np.diff(row_ptr)
    return np.repeat(np.arange(len(counts), dtype=np.int32), counts)


# ---------------------------------------------------------------------------
# bfs — tests/opencl/bfs/kernel.cl (BFS_1/BFS_2): level-synchronous
# frontier expansion.  The scatter loop over a node's edge range becomes a
# whole-edge-list gather/scatter: new frontier = nodes reached through any
# edge whose source is in the frontier and that are unvisited.  The
# divergent per-node edge loop disappears; lax.while_loop iterates levels.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("num_nodes", "source"))
def bfs(edge_src, edge_dst, num_nodes: int, source: int = 0):
    """Directed edge list -> (cost (N,) i32, -1 if unreachable)."""
    frontier = jnp.zeros((num_nodes,), bool).at[source].set(True)
    visited = frontier
    cost = jnp.where(frontier, 0, -1).astype(jnp.int32)

    def cond(state):
        frontier, visited, cost, level = state
        return jnp.any(frontier)

    def body(state):
        frontier, visited, cost, level = state
        reached = jnp.zeros((num_nodes,), bool).at[edge_dst].max(
            frontier[edge_src])
        new = reached & ~visited
        cost = jnp.where(new, level + 1, cost)
        return new, visited | new, cost, level + 1

    _, _, cost, _ = jax.lax.while_loop(
        cond, body, (frontier, visited, cost, jnp.int32(0)))
    return cost


def bfs_oracle(edge_src, edge_dst, num_nodes, source=0):
    from collections import deque
    adj = [[] for _ in range(num_nodes)]
    for s, t in zip(edge_src, edge_dst):
        adj[int(s)].append(int(t))
    cost = np.full(num_nodes, -1, np.int32)
    cost[source] = 0
    q = deque([source])
    while q:
        u = q.popleft()
        for w in adj[u]:
            if cost[w] < 0:
                cost[w] = cost[u] + 1
                q.append(w)
    return cost


# ---------------------------------------------------------------------------
# gaussian — tests/opencl/guassian (Rodinia Gaussian elimination, Fan1/Fan2
# kernels): forward elimination of [A|b] one pivot per step.  The two
# kernels become one masked rank-1 row update inside lax.scan over pivots
# (no pivoting, like the reference).
# ---------------------------------------------------------------------------

@jax.jit
def gaussian_eliminate(A, b):
    """Forward elimination -> (U upper-triangular, b')."""
    n = A.shape[0]
    M = jnp.concatenate([A, b[:, None]], axis=1)     # (n, n+1)
    rows = jnp.arange(n)

    def step(M, p):
        pivot_row = M[p]                             # (n+1,)
        m = M[:, p] / pivot_row[p]                   # Fan1: multipliers
        mask = (rows > p).astype(M.dtype)
        M = M - (mask * m)[:, None] * pivot_row[None, :]   # Fan2
        return M, None

    M, _ = jax.lax.scan(step, M, jnp.arange(n - 1))
    return M[:, :-1], M[:, -1]


def back_substitute(U, c):
    """Host-side back substitution (the reference does this on the CPU)."""
    U = np.asarray(U)
    c = np.asarray(c)
    n = U.shape[0]
    x = np.zeros(n, U.dtype)
    for i in range(n - 1, -1, -1):
        x[i] = (c[i] - U[i, i + 1:] @ x[i + 1:]) / U[i, i]
    return x


# ---------------------------------------------------------------------------
# sfilter — tests/opencl/sfilter/kernel.cl:1-23: 3x3 convolution over the
# image interior (the host launches with global_offset (1,1) and work size
# (n-2, n-2), main.cc:223-225, so borders keep the zero-initialized dst).
# The per-pixel gather becomes nine shifted slice-multiplies XLA fuses; the i0+i1+...+i8 accumulation order is preserved left-to-right
# (matching the host reference loop up to XLA FMA contraction).
# ---------------------------------------------------------------------------

@jax.jit
def sfilter(src, m):
    """src (H, W) f32, m (9,) f32 taps (row-major 3x3) -> (H, W) f32."""
    src = jnp.asarray(src, F32)
    m = jnp.asarray(m, F32)
    acc = None
    for k, (dy, dx) in enumerate([(-1, -1), (-1, 0), (-1, 1),
                                  (0, -1), (0, 0), (0, 1),
                                  (1, -1), (1, 0), (1, 1)]):
        term = src[1 + dy:src.shape[0] - 1 + dy,
                   1 + dx:src.shape[1] - 1 + dx] * m[k]
        acc = term if acc is None else acc + term
    return jnp.zeros_like(src).at[1:-1, 1:-1].set(acc)


# ---------------------------------------------------------------------------
# sgemm3 — tests/opencl/sgemm3/kernel.cl:1-36: local-memory-tiled matmul
# (each workgroup stages A/B blocks in __local and barriers between block
# loads).  The tiling/staging is exactly what XLA's matmul lowering does
# to a plain dot, so the array form IS jnp.dot — the blocked schedule is
# the compiler's job, not the kernel author's.  HIGHEST keeps float32
# products (no TF32).
# ---------------------------------------------------------------------------

@jax.jit
def sgemm3(A, B):
    return jnp.dot(jnp.asarray(A, F32), jnp.asarray(B, F32),
                   preferred_element_type=F32,
                   precision=jax.lax.Precision.HIGHEST)
