"""Tile binning: primitives -> per-tile primitive lists + raster-ready arrays.

The analog of ``graphics::Binning`` (sim/common/gfxutil.cpp:103-276), with an
array-native output layout: instead of the reference's serialized tilebuf /
primbuf device buffers, binning produces

  * dense per-primitive arrays   edges (P,3,3) i32 fixed16,
                                 attribs (P,7,3) i32 fixed24
  * a padded per-tile pid matrix (T, M) i32 with -1 padding

The padded matrix is what lets a device kernel scan primitives per tile in
lockstep (vmap over tiles, sequential over the prim axis) while preserving
the reference's per-pixel blend order: pids are stored in submission order,
exactly like the reference's per-tile pid lists (gfxutil.cpp:244-249).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import transform
from ..core import fixed

F32 = np.float32

# attribute order inside the (P, 7, 3) array (graphics.h:44-52)
ATTR_Z, ATTR_R, ATTR_G, ATTR_B, ATTR_A, ATTR_U, ATTR_V = range(7)


@dataclasses.dataclass
class BinnedDrawcall:
    """Raster-ready, device-consumable drawcall geometry."""
    edges: np.ndarray        # (P, 3, 3) int32 fixed16: [edge][a, b, c]
    attribs: np.ndarray      # (P, 7, 3) int32 fixed24: [z r g b a u v][dx dy c]
    tile_xy: np.ndarray      # (T, 2) int32 tile coords (tx, ty)
    tile_pids: np.ndarray    # (T, M) int32 prim ids, -1 padded, submission order
    tile_pid_count: np.ndarray  # (T,) int32
    tile_logsize: int
    num_prims: int

    @property
    def num_tiles(self):
        return self.tile_xy.shape[0]

    @property
    def max_prims_per_tile(self):
        return self.tile_pids.shape[1]


def bin_drawcall(pos, indices, colors, texcoords, width, height, near, far,
                 tile_logsize=5, pad_multiple=8) -> BinnedDrawcall | None:
    """Bin one drawcall.  Mirrors gfxutil.cpp:103-276 bit-for-bit.

    pos (V,4) f32 clip space; indices (P,3) i32; colors (V,4); texcoords (V,2).
    Returns None when no primitive survives rejection (host then skips the
    draw, draw3d/main.cpp:192-193).

    Dispatches to the native C++ engine (native/binning.cpp) when built —
    the reference's host tier is native C++ too — with this numpy
    implementation as the behavioral oracle and fallback (SKYBOX_NATIVE=0
    forces it).
    """
    from . import native as native_mod
    res = native_mod.bin_drawcall_native(
        pos, indices, colors, texcoords, width, height, near, far,
        tile_logsize, pad_multiple)
    if res == "empty":
        return None
    if res is not None:
        edges, attribs, tile_xy, tile_pids, tile_cnt = res
        return BinnedDrawcall(
            edges=edges, attribs=attribs, tile_xy=tile_xy,
            tile_pids=tile_pids, tile_pid_count=tile_cnt,
            tile_logsize=tile_logsize, num_prims=edges.shape[0])
    return bin_drawcall_py(pos, indices, colors, texcoords, width, height,
                           near, far, tile_logsize, pad_multiple)


def bin_drawcall_py(pos, indices, colors, texcoords, width, height, near,
                    far, tile_logsize=5, pad_multiple=8
                    ) -> BinnedDrawcall | None:
    """Pure-numpy binning — the oracle the native engine is tested against."""
    pos = np.asarray(pos, F32)
    indices = np.asarray(indices, np.int64)
    if indices.size == 0:
        return None
    p0, p1, p2 = (pos[indices[:, k]] for k in range(3))

    # clip -> 2D homogeneous device space, edge matrix, winding fix
    ph0 = transform.clip_to_hdc(p0, 0, width, 0, height, near, far)
    ph1 = transform.clip_to_hdc(p1, 0, width, 0, height, near, far)
    ph2 = transform.clip_to_hdc(p2, 0, width, 0, height, near, far)
    edges_f, nondegenerate = transform.edge_equation(ph0, ph1, ph2)

    # clip -> screen space for bbox + z attribute
    ps0 = transform.clip_to_screen(p0, 0, width, 0, height, near, far)
    ps1 = transform.clip_to_screen(p1, 0, width, 0, height, near, far)
    ps2 = transform.clip_to_screen(p2, 0, width, 0, height, near, far)

    xs = np.stack([ps0[:, 0], ps1[:, 0], ps2[:, 0]], -1)
    ys = np.stack([ps0[:, 1], ps1[:, 1], ps2[:, 1]], -1)
    bb_left = np.maximum(np.floor(xs.min(-1)).astype(np.int64), 0)
    bb_right = np.minimum(np.ceil(xs.max(-1)).astype(np.int64), width)
    bb_top = np.maximum(np.floor(ys.min(-1)).astype(np.int64), 0)
    bb_bottom = np.minimum(np.ceil(ys.max(-1)).astype(np.int64), height)

    keep = nondegenerate & (bb_right > bb_left) & (bb_bottom > bb_top)
    if not keep.any():
        return None

    # half-pixel offset then float->fixed16 with matrix normalization
    edges_f = transform.apply_half_pixel_offset(edges_f)
    kept = np.flatnonzero(keep)
    edges_fx = transform.edges_to_fixed(edges_f[kept])

    idx = indices[kept]
    v0c, v1c, v2c = (np.asarray(colors, F32)[idx[:, k]] for k in range(3))
    v0t, v1t, v2t = (np.asarray(texcoords, F32)[idx[:, k]] for k in range(3))
    z0, z1, z2 = (p[kept, 2] for p in (ps0, ps1, ps2))

    attribs = np.stack([
        transform.attribute_deltas(z0, z1, z2),
        transform.attribute_deltas(v0c[:, 0], v1c[:, 0], v2c[:, 0]),
        transform.attribute_deltas(v0c[:, 1], v1c[:, 1], v2c[:, 1]),
        transform.attribute_deltas(v0c[:, 2], v1c[:, 2], v2c[:, 2]),
        transform.attribute_deltas(v0c[:, 3], v1c[:, 3], v2c[:, 3]),
        transform.attribute_deltas(v0t[:, 0], v1t[:, 0], v2t[:, 0]),
        transform.attribute_deltas(v0t[:, 1], v1t[:, 1], v2t[:, 1]),
    ], axis=1)

    # tile coverage (gfxutil.cpp:236-250): bbox -> tile-id lists, pid order
    # preserved within each tile
    tile_size = 1 << tile_logsize
    tmin_x = bb_left[kept] >> tile_logsize
    tmax_x = (bb_right[kept] + tile_size - 1) >> tile_logsize
    tmin_y = bb_top[kept] >> tile_logsize
    tmax_y = (bb_bottom[kept] + tile_size - 1) >> tile_logsize

    tiles: dict[tuple[int, int], list[int]] = {}
    for p in range(len(kept)):
        for ty in range(tmin_y[p], tmax_y[p]):
            for tx in range(tmin_x[p], tmax_x[p]):
                tiles.setdefault((tx, ty), []).append(p)

    tile_keys = sorted(tiles)  # std::map<pair> iteration order (tx, then ty)
    T = len(tile_keys)
    max_ppt = max(len(tiles[k]) for k in tile_keys)
    M = -(-max_ppt // pad_multiple) * pad_multiple
    tile_xy = np.array(tile_keys, np.int32).reshape(T, 2)
    tile_pids = np.full((T, M), -1, np.int32)
    tile_cnt = np.zeros((T,), np.int32)
    for t, k in enumerate(tile_keys):
        pids = tiles[k]
        tile_pids[t, : len(pids)] = pids
        tile_cnt[t] = len(pids)

    return BinnedDrawcall(
        edges=edges_fx,
        attribs=attribs.astype(np.int32),
        tile_xy=tile_xy,
        tile_pids=tile_pids,
        tile_pid_count=tile_cnt,
        tile_logsize=tile_logsize,
        num_prims=len(kept),
    )
