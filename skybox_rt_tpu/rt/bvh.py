"""BVH construction (host) + vectorized traversal (device).

Build: binned median split over the longest centroid axis (host numpy —
the analog of the reference's host-side binning pass, gfxutil.cpp:103-276:
acceleration structure built once per scene on the host, consumed by the
device inner loop).  Node layout is a flat struct-of-arrays:

  node_min/max (N, 3) f32   AABB
  node_left    (N,)   i32   left child   (internal nodes)
  node_right   (N,)   i32   right child
  node_first   (N,)   i32   first index into prim_order (leaves)
  node_count   (N,)   i32   prim count (0 => internal)
  prim_order   (P,)   i32   triangle permutation so leaf prims are contiguous

Traversal: per-ray explicit stack inside lax.while_loop, vmapped over the
ray batch — rays advance in lockstep with masked lanes (the RT analog of
the reference's SIMT divergence handling, SURVEY §2.7: ipdom stack ->
while_loop + masks).  Leaves hold up to LEAF_SIZE triangles tested with a
vectorized Möller–Trumbore.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import intersect

F32 = jnp.float32
I32 = jnp.int32

LEAF_SIZE = 4
STACK_DEPTH = 64
#: Far-bound slack of the stackless box tests: 1 + 2*gamma(3) (Ize,
#: "Robust BVH Ray Traversal", 2013).  Float rounding in the slab test
#: can otherwise cull a box whose triangle MT still hits — a ray through
#: a box edge, or a tie at the running best t.
ROBUST_FAR = 1.0 + 2.0 * (3 * 2.0 ** -24) / (1 - 3 * 2.0 ** -24)


@dataclasses.dataclass
class BVH:
    node_min: np.ndarray
    node_max: np.ndarray
    node_left: np.ndarray
    node_right: np.ndarray
    node_first: np.ndarray
    node_count: np.ndarray
    prim_order: np.ndarray
    # leaf capacity this tree was built with — traversals MUST test this
    # many prims per leaf (pass bvh.leaf_size, not the module default)
    leaf_size: int = LEAF_SIZE
    # preorder + escape-link layout for the stackless lockstep traversal
    # (computed lazily): node i's first child is i+1; `escape[i]` is the
    # preorder index to jump to when i's subtree is done (N = exit)
    pre_min: np.ndarray = None
    pre_max: np.ndarray = None
    pre_first: np.ndarray = None
    pre_count: np.ndarray = None
    pre_escape: np.ndarray = None

    @property
    def num_nodes(self):
        return self.node_min.shape[0]

    def as_device_arrays(self):
        return tuple(jnp.asarray(a) for a in (
            self.node_min, self.node_max, self.node_left, self.node_right,
            self.node_first, self.node_count, self.prim_order))

    def build_preorder(self):
        """Re-layout nodes in preorder with escape links (host, once)."""
        if self.pre_escape is not None:
            return self
        N = self.num_nodes
        sizes = np.ones(N, np.int64)
        # postorder subtree sizes (children were appended after parents in
        # build(), so a reverse index sweep sees children before parents)
        internal = self.node_count == 0
        for i in range(N - 1, -1, -1):
            if internal[i]:
                sizes[i] = 1 + sizes[self.node_left[i]] \
                             + sizes[self.node_right[i]]
        perm = np.empty(N, np.int64)        # preorder position -> old index
        escape = np.empty(N, np.int32)
        stack = [(0, N)]
        pos = 0
        while stack:
            old, esc = stack.pop()
            perm[pos] = old
            escape[pos] = esc
            if internal[old]:
                l, r = self.node_left[old], self.node_right[old]
                right_pos = pos + 1 + sizes[l]
                stack.append((r, esc))          # popped after left subtree
                stack.append((l, right_pos))    # left is next (pos + 1)
            pos += 1
        self.pre_min = self.node_min[perm]
        self.pre_max = self.node_max[perm]
        self.pre_first = self.node_first[perm]
        self.pre_count = self.node_count[perm]
        self.pre_escape = escape
        return self

    def as_stackless_arrays(self):
        self.build_preorder()
        return tuple(jnp.asarray(a) for a in (
            self.pre_min, self.pre_max, self.pre_first, self.pre_count,
            self.pre_escape, self.prim_order))


class _Builder:
    """Shared node-array bookkeeping for the top-down host builders.

    All builders emit the same flat layout (and keep each subtree's prims
    contiguous in prim_order, which the leaf-ordered triangle records of
    ops.traverse rely on); they differ only in how a range is
    partitioned.
    """

    def __init__(self, verts, faces):
        verts = np.asarray(verts, np.float32)
        faces = np.asarray(faces, np.int64)
        self.P = faces.shape[0]
        tri = verts[faces]                  # (P, 3, 3)
        self.tmin = tri.min(1)
        self.tmax = tri.max(1)
        self.cent = tri.mean(1)
        self.order = np.arange(self.P)
        self.node_min, self.node_max = [], []
        self.node_left, self.node_right = [], []
        self.node_first, self.node_count = [], []

    def new_node(self):
        self.node_min.append(None)
        self.node_max.append(None)
        self.node_left.append(-1)
        self.node_right.append(-1)
        self.node_first.append(0)
        self.node_count.append(0)
        return len(self.node_min) - 1

    def set_bounds(self, ni, ids):
        self.node_min[ni] = self.tmin[ids].min(0)
        self.node_max[ni] = self.tmax[ids].max(0)

    def make_leaf(self, ni, lo, hi):
        self.node_first[ni] = lo
        self.node_count[ni] = hi - lo

    def split_node(self, ni):
        li = self.new_node()
        ri = self.new_node()
        self.node_left[ni] = li
        self.node_right[ni] = ri
        return li, ri

    def finish(self, leaf_size):
        return BVH(
            node_min=np.asarray(self.node_min, np.float32),
            node_max=np.asarray(self.node_max, np.float32),
            node_left=np.asarray(self.node_left, np.int32),
            node_right=np.asarray(self.node_right, np.int32),
            node_first=np.asarray(self.node_first, np.int32),
            node_count=np.asarray(self.node_count, np.int32),
            prim_order=self.order.astype(np.int32),
            leaf_size=leaf_size,
        )


def build(verts: np.ndarray, faces: np.ndarray,
          leaf_size: int = LEAF_SIZE, method: str = "median") -> BVH:
    """Build a BVH. method: 'median' (centroid median split),
    'sah' (binned surface-area heuristic), 'lbvh' (Morton radix split)."""
    if method == "median":
        return build_median(verts, faces, leaf_size)
    if method == "sah":
        return build_sah(verts, faces, leaf_size)
    if method == "lbvh":
        return build_lbvh(verts, faces, leaf_size)
    raise ValueError(f"unknown BVH build method {method!r}")


def build_median(verts: np.ndarray, faces: np.ndarray,
                 leaf_size: int = LEAF_SIZE) -> BVH:
    """Median-split BVH over triangle centroids."""
    b = _Builder(verts, faces)
    root = b.new_node()
    work = [(root, 0, b.P)]
    while work:
        ni, lo, hi = work.pop()
        ids = b.order[lo:hi]
        b.set_bounds(ni, ids)
        n = hi - lo
        if n <= leaf_size:
            b.make_leaf(ni, lo, hi)
            continue
        ext = b.cent[ids].max(0) - b.cent[ids].min(0)
        axis = int(ext.argmax())
        part = np.argsort(b.cent[ids, axis], kind="stable")
        b.order[lo:hi] = ids[part]
        mid = lo + n // 2
        li, ri = b.split_node(ni)
        work.append((li, lo, mid))
        work.append((ri, mid, hi))
    return b.finish(leaf_size)


def _half_area(bmin, bmax):
    """Half surface area of AABBs; 0 for empty (inverted) boxes."""
    e = np.maximum(bmax - bmin, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] \
        + e[..., 2] * e[..., 0]


def build_sah(verts: np.ndarray, faces: np.ndarray,
              leaf_size: int = LEAF_SIZE, num_bins: int = 16) -> BVH:
    """Binned surface-area-heuristic BVH (host numpy, top-down).

    Per node, centroids are scattered into `num_bins` bins along each
    axis; prefix/suffix AABB sweeps give the SAH cost
    area_L*n_L + area_R*n_R for every bin boundary, and the cheapest
    (axis, boundary) partitions the range.  Falls back to a median split
    when every centroid lands in one bin.  Same flat layout/contiguity
    guarantees as build_median, so every traversal works unchanged;
    typically 1.5-3x fewer ray-box/ray-tri
    tests than median split on irregular geometry.
    """
    b = _Builder(verts, faces)
    root = b.new_node()
    work = [(root, 0, b.P)]
    while work:
        ni, lo, hi = work.pop()
        ids = b.order[lo:hi]
        b.set_bounds(ni, ids)
        n = hi - lo
        if n <= leaf_size:
            b.make_leaf(ni, lo, hi)
            continue

        c = b.cent[ids]
        cmin = c.min(0)
        ext = c.max(0) - cmin
        best_cost = np.inf
        best_part = None
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            scale = num_bins * (1.0 - 1e-6) / ext[axis]
            bins = ((c[:, axis] - cmin[axis]) * scale).astype(np.int64)
            counts = np.bincount(bins, minlength=num_bins)
            bbmin = np.full((num_bins, 3), np.inf, np.float32)
            bbmax = np.full((num_bins, 3), -np.inf, np.float32)
            np.minimum.at(bbmin, bins, b.tmin[ids])
            np.maximum.at(bbmax, bins, b.tmax[ids])
            # prefix (left) and suffix (right) sweeps over bin boundaries
            lmin = np.minimum.accumulate(bbmin, 0)
            lmax = np.maximum.accumulate(bbmax, 0)
            rmin = np.minimum.accumulate(bbmin[::-1], 0)[::-1]
            rmax = np.maximum.accumulate(bbmax[::-1], 0)[::-1]
            ncum = np.cumsum(counts)
            n_l = ncum[:-1]                       # prims left of boundary i+1
            n_r = n - n_l
            cost = np.where(n_l > 0, _half_area(lmin, lmax)[:-1] * n_l, 0.0) \
                + np.where(n_r > 0, _half_area(rmin, rmax)[1:] * n_r, 0.0)
            cost = np.where((n_l == 0) | (n_r == 0), np.inf, cost)
            k = int(np.argmin(cost))
            if cost[k] < best_cost:
                best_cost = cost[k]
                best_part = bins <= k
        if best_part is None or not (0 < best_part.sum() < n):
            # degenerate centroids: median split keeps the tree balanced
            axis = int(ext.argmax())
            part = np.argsort(c[:, axis], kind="stable")
            b.order[lo:hi] = ids[part]
            mid = lo + n // 2
        else:
            b.order[lo:hi] = np.concatenate(
                [ids[best_part], ids[~best_part]])
            mid = lo + int(best_part.sum())
        li, ri = b.split_node(ni)
        work.append((li, lo, mid))
        work.append((ri, mid, hi))
    return b.finish(leaf_size)


def morton_codes(cent: np.ndarray, bits: int = 10) -> np.ndarray:
    """30-bit Morton codes of points quantized to a 2^bits grid (vectorized)."""
    cent = np.asarray(cent, np.float64)
    lo = cent.min(0)
    ext = np.maximum(cent.max(0) - lo, 1e-30)
    q = np.minimum(((cent - lo) / ext * (1 << bits)).astype(np.uint64),
                   (1 << bits) - 1)

    def part1by2(x):
        x &= np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x30000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x9249249)
        return x

    return (part1by2(q[:, 0]) << np.uint64(2)) \
        | (part1by2(q[:, 1]) << np.uint64(1)) | part1by2(q[:, 2])


def build_lbvh(verts: np.ndarray, faces: np.ndarray,
               leaf_size: int = LEAF_SIZE, bits: int = 10) -> BVH:
    """Linear BVH: Morton-sort centroids, then split each range at its
    highest differing Morton bit (the radix/Karras-style hierarchy).

    The sort is the only O(P log P) step; each split is a binary search
    (the bit column is monotonic within a sorted range whose higher bits
    agree).  Build is near-linear and order-deterministic — the host-side
    analog of a GPU LBVH, and the natural builder for animated geometry
    where per-frame rebuild cost dominates traversal quality.
    """
    b = _Builder(verts, faces)
    codes = morton_codes(b.cent, bits)
    perm = np.argsort(codes, kind="stable")
    b.order = b.order[perm]
    codes = codes[perm]

    root = b.new_node()
    work = [(root, 0, b.P, 3 * bits - 1)]
    while work:
        ni, lo, hi, bit = work.pop()
        ids = b.order[lo:hi]
        b.set_bounds(ni, ids)
        n = hi - lo
        if n <= leaf_size:
            b.make_leaf(ni, lo, hi)
            continue
        # find the highest bit that actually splits this range
        mid = lo
        while bit >= 0:
            col = (codes[lo:hi] >> np.uint64(bit)) & np.uint64(1)
            mid = lo + int(np.searchsorted(col, 1))
            if lo < mid < hi:
                break
            bit -= 1
        if not (lo < mid < hi):
            # all codes equal: median split on the longest axis
            axis = int((b.cent[ids].max(0) - b.cent[ids].min(0)).argmax())
            part = np.argsort(b.cent[ids, axis], kind="stable")
            b.order[lo:hi] = ids[part]
            codes[lo:hi] = codes[lo:hi][part]
            mid = lo + n // 2
        li, ri = b.split_node(ni)
        work.append((li, lo, mid, bit - 1))
        work.append((ri, mid, hi, bit - 1))
    return b.finish(leaf_size)


def _aabb_hit(bmin, bmax, orig, inv_dir, t_best):
    """Slab test; robust to inf inv_dir (axis-parallel rays)."""
    t0 = (bmin - orig) * inv_dir
    t1 = (bmax - orig) * inv_dir
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    t_near = jnp.maximum(jnp.max(tn), 0.0)
    t_far = jnp.minimum(jnp.min(tf), t_best)
    return t_near <= t_far


def closest_hit(bvh_arrays, tri_arrays, orig, direction,
                t_min=1e-4, t_max=jnp.inf,
                leaf_size: int = LEAF_SIZE,
                stack_depth: int = STACK_DEPTH):
    """Closest-hit traversal for a ray batch.

    bvh_arrays: BVH.as_device_arrays(); tri_arrays: (v0, e1, e2) in the
    ORIGINAL primitive order (prim_order indices resolve into them).
    orig, direction: (R, 3).
    Returns (prim_id (R,), t, u, v) — prim ids in original order, -1 miss.
    """
    (nmin, nmax, nleft, nright, nfirst, ncount, prim_order) = bvh_arrays
    v0, e1, e2 = tri_arrays

    def one_ray(o, d):
        safe = jnp.abs(d) > 1e-12
        inv_d = jnp.where(safe, 1.0 / jnp.where(safe, d, 1.0), 1e30)

        stack = jnp.zeros((stack_depth,), I32)
        # state: (sp, stack, best_t, best_prim, best_u, best_v)
        state = (jnp.int32(1), stack, jnp.asarray(t_max, F32),
                 jnp.int32(-1), F32(0), F32(0))

        def cond(state):
            sp = state[0]
            return sp > 0

        def body(state):
            sp, stack, best_t, best_p, best_u, best_v = state
            node = stack[sp - 1]
            sp = sp - 1

            hit_box = _aabb_hit(nmin[node], nmax[node], o, inv_d, best_t)
            count = ncount[node]
            is_leaf = count > 0

            # --- leaf: test up to leaf_size prims (masked) ---
            first = nfirst[node]
            ks = jnp.arange(leaf_size)
            pids = prim_order[jnp.clip(first + ks, 0, prim_order.shape[0] - 1)]
            pm = hit_box & is_leaf & (ks < count)
            h, t, u, v = intersect.moller_trumbore(
                o[None], d[None], v0[pids], e1[pids], e2[pids],
                t_min, best_t,
            )
            h = h & pm
            t_m = jnp.where(h, t, jnp.inf)
            k_best = jnp.argmin(t_m)
            better = t_m[k_best] < best_t
            best_t = jnp.where(better, t_m[k_best], best_t)
            best_p = jnp.where(better, pids[k_best], best_p)
            best_u = jnp.where(better, u[k_best], best_u)
            best_v = jnp.where(better, v[k_best], best_v)

            # --- internal: push children ---
            push = hit_box & ~is_leaf
            stack = stack.at[sp].set(jnp.where(push, nleft[node], stack[sp]))
            sp1 = sp + push.astype(I32)
            stack = stack.at[sp1].set(
                jnp.where(push, nright[node], stack[sp1]))
            sp = sp1 + push.astype(I32)

            return (sp, stack, best_t, best_p, best_u, best_v)

        sp, stack, best_t, best_p, best_u, best_v = jax.lax.while_loop(
            cond, body, state)
        return best_p, jnp.where(best_p >= 0, best_t, jnp.inf), best_u, best_v

    return jax.vmap(one_ray)(orig, direction)


def closest_hit_stackless(stackless_arrays, tri_arrays, orig, direction,
                          t_min=1e-4, t_max=jnp.inf,
                          leaf_size: int = LEAF_SIZE, t_lo=None, p_lo=None):
    """Lockstep traversal in XLA: preorder + escape links.

    Per-ray state is ONE int32 node pointer (no stacks): at an interior
    node whose box the ray hits, descend to node+1 (preorder first child);
    otherwise jump to escape[node].  All rays advance together each
    iteration of a single while_loop — dense (R, ...) gathers + masked
    Möller–Trumbore (the SIMT-divergence-as-predication rule of SURVEY
    §2.7 applied to traversal).  The closest hit is the lexicographic
    (t, prim) minimum, so exact-t ties resolve to the lowest prim id, as
    in intersect.closest_hit_bruteforce.  This is the plain reference of
    the GPU kernel in ops.traverse, which walks the same arrays per lane.

    stackless_arrays: BVH.as_stackless_arrays(); rays (R, 3).
    t_lo / p_lo: optional (R,) lexicographic lower bound — the result is
    then the closest hit strictly AFTER (t_lo, p_lo), so repeated calls
    enumerate every hit along a ray in (t, prim) order.
    Returns (prim (R,) i32 [-1 miss], t, u, v).
    """
    nmin, nmax, nfirst, ncount, escape, prim_order = stackless_arrays
    v0, e1, e2 = tri_arrays
    N = nmin.shape[0]
    P = prim_order.shape[0]
    R = orig.shape[0]

    safe = jnp.abs(direction) > 1e-12
    inv_d = jnp.where(safe, 1.0 / jnp.where(safe, direction, 1.0), 1e30)

    ks = jnp.arange(leaf_size)

    def cond(state):
        node = state[0]
        return jnp.any(node < N)

    def body(state):
        node, best_t, best_p, best_u, best_v = state
        active = node < N
        nc = jnp.minimum(node, N - 1)

        bmin = nmin[nc]                    # (R, 3) gathers
        bmax = nmax[nc]
        t0 = (bmin - orig) * inv_d
        t1 = (bmax - orig) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        hit_box = (jnp.maximum(tn, 0.0)
                   <= jnp.minimum(tf, best_t) * ROBUST_FAR) & active

        cnt = ncount[nc]
        is_leaf = cnt > 0

        # leaf primitive tests, masked dense (R, leaf_size)
        first = nfirst[nc]
        pids = prim_order[jnp.clip(first[:, None] + ks[None, :], 0, P - 1)]
        pm = hit_box[:, None] & is_leaf[:, None] & (ks[None, :] < cnt[:, None])
        h, t, u, v = intersect.moller_trumbore(
            orig[:, None], direction[:, None],
            v0[pids], e1[pids], e2[pids], t_min, jnp.inf)
        h = h & pm
        for k in range(leaf_size):
            tk, pk = t[:, k], pids[:, k]
            better = h[:, k] & ((tk < best_t)
                                | ((tk == best_t) & (pk < best_p)))
            if t_lo is not None:
                better = better & ((tk > t_lo)
                                   | ((tk == t_lo) & (pk > p_lo)))
            best_t = jnp.where(better, tk, best_t)
            best_p = jnp.where(better, pk, best_p)
            best_u = jnp.where(better, u[:, k], best_u)
            best_v = jnp.where(better, v[:, k], best_v)

        descend = hit_box & ~is_leaf
        nxt = jnp.where(descend, node + 1, escape[nc])
        node = jnp.where(active, nxt, N)
        return (node, best_t, best_p, best_u, best_v)

    state = (jnp.zeros((R,), I32),
             jnp.full((R,), t_max, F32),
             jnp.full((R,), -1, I32),
             jnp.zeros((R,), F32), jnp.zeros((R,), F32))
    _, best_t, best_p, best_u, best_v = jax.lax.while_loop(cond, body, state)
    return (best_p, jnp.where(best_p >= 0, best_t, jnp.inf),
            best_u, best_v)


def any_hit(bvh_arrays, tri_arrays, orig, direction, t_min=1e-4, t_max=1.0,
            leaf_size: int = LEAF_SIZE, stack_depth: int = STACK_DEPTH):
    """Occlusion query via full closest-hit traversal (the per-ray-stack
    path has no early-out; prefer any_hit_stackless)."""
    prim, t, _, _ = closest_hit(bvh_arrays, tri_arrays, orig, direction,
                                t_min, t_max, leaf_size, stack_depth)
    return prim >= 0


def any_hit_stackless(stackless_arrays, tri_arrays, orig, direction,
                      t_min=1e-4, t_max=1.0, leaf_size: int = LEAF_SIZE):
    """Occlusion traversal with a true early-out: a ray that finds ANY
    hit in [t_min, t_max) jumps straight to the exit node, and the loop
    ends as soon as every ray is done or occluded."""
    nmin, nmax, nfirst, ncount, escape, prim_order = stackless_arrays
    v0, e1, e2 = tri_arrays
    N = nmin.shape[0]
    P = prim_order.shape[0]

    safe = jnp.abs(direction) > 1e-12
    inv_d = jnp.where(safe, 1.0 / jnp.where(safe, direction, 1.0), 1e30)
    ks = jnp.arange(leaf_size)
    tmax_arr = jnp.broadcast_to(jnp.asarray(t_max, F32), orig.shape[:1])

    def cond(state):
        node, _ = state
        return jnp.any(node < N)

    def body(state):
        node, occluded = state
        active = node < N
        nc = jnp.minimum(node, N - 1)

        bmin = nmin[nc]
        bmax = nmax[nc]
        t0 = (bmin - orig) * inv_d
        t1 = (bmax - orig) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        hit_box = (jnp.maximum(tn, 0.0)
                   <= jnp.minimum(tf, tmax_arr) * ROBUST_FAR) & active

        cnt = ncount[nc]
        is_leaf = cnt > 0
        first = nfirst[nc]
        pids = prim_order[jnp.clip(first[:, None] + ks[None, :], 0, P - 1)]
        pm = hit_box[:, None] & is_leaf[:, None] & (ks[None, :] < cnt[:, None])
        h, t, _, _ = intersect.moller_trumbore(
            orig[:, None], direction[:, None],
            v0[pids], e1[pids], e2[pids], t_min, jnp.inf)
        h = h & pm & (t < tmax_arr[:, None])
        occluded = occluded | jnp.any(h, axis=1)

        descend = hit_box & ~is_leaf
        nxt = jnp.where(descend, node + 1, escape[nc])
        node = jnp.where(active & ~occluded, nxt, N)   # early-out
        return (node, occluded)

    state = (jnp.zeros(orig.shape[:1], I32),
             jnp.zeros(orig.shape[:1], bool))
    _, occluded = jax.lax.while_loop(cond, body, state)
    return occluded
