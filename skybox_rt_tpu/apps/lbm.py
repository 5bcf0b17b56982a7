"""lbm — Parboil D3Q19 lattice-Boltzmann (SURVEY §4: tests/opencl/lbm).

Array-native port of the reference's stream-collide kernel
(/root/reference/tests/opencl/lbm/kernel.cl: performStreamCollide_kernel)
with the GATHER (pull) layout its layout_config.h selects: each cell pulls
distribution e from its opposite-direction neighbor, applies BGK collision
(OMEGA=1.95) or obstacle bounce-back, and writes locally.

The C grid is a flat float array of 20-entry cells (19 distributions +
FLAGS stored as a bit pattern in float memory) with a 2-z-slice margin on
each end; out-of-domain neighbor reads deliberately wrap through the flat
layout (CALC_INDEX is plain linear arithmetic — layout_config.h:42-44).
We reproduce those semantics exactly by precomputing the source/destination
flat indices on the host and making the device step ONE static gather + the
vectorized collide + ONE static scatter — the whole grid's stencil becomes
two dense index ops XLA pipelines from HBM, with no data-dependent control
flow (obstacle/accel handling is pure predication, the SIMT-divergence rule
of SURVEY §2.7).

Cell entry order and constants mirror layout_config.h:60-70 and
lbm_macros.h:12-22; the LDC (lid-driven cavity) initial condition mirrors
lbm.c:98-193.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

OMEGA = np.float32(1.95)
DFL1 = np.float32(1.0 / 3.0)
DFL2 = np.float32(1.0 / 18.0)
DFL3 = np.float32(1.0 / 36.0)

OBSTACLE = 1 << 0
ACCEL = 1 << 1

# entry order = CELL_ENTRIES enum (layout_config.h:60-64); FLAGS = 19
NAMES = ["C", "N", "S", "E", "W", "T", "B",
         "NE", "NW", "SE", "SW", "NT", "NB", "ST", "SB",
         "ET", "EB", "WT", "WB"]
FLAGS = len(NAMES)
N_CELL_ENTRIES = FLAGS + 1

# direction vectors (dx, dy, dz) per entry (lbm_macros.h:55-73)
DIRS = np.array([
    (0, 0, 0), (0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0),
    (0, 0, 1), (0, 0, -1),
    (1, 1, 0), (-1, 1, 0), (1, -1, 0), (-1, -1, 0),
    (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1),
    (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
], np.int64)

# index of the opposite direction (N<->S swizzles etc., kernel.cl:62-72)
OPPOSITE = np.array([NAMES.index(
    n.translate(str.maketrans("NSEWTB", "SNWEBT"))) for n in NAMES])

# equilibrium weight per entry: DFL1 for C, DFL2 for axis, DFL3 for diagonal
WEIGHTS = np.array([DFL1] + [DFL2] * 6 + [DFL3] * 12, np.float32)


@dataclasses.dataclass(frozen=True)
class LBMConfig:
    size_x: int = 32
    size_y: int = 32
    size_z: int = 8

    @property
    def padded(self):
        return self.size_x, self.size_y, self.size_z  # PADDING_* are 0

    @property
    def margin(self):
        px, py, _ = self.padded
        return N_CELL_ENTRIES * px * py * 2            # two z slices

    @property
    def total_floats(self):
        px, py, pz = self.padded
        return N_CELL_ENTRIES * px * py * pz + 2 * self.margin

    def calc_index(self, x, y, z, e):
        """CALC_INDEX (layout_config.h:42) + margin: plain linear
        arithmetic, so out-of-domain coords wrap through the flat array
        exactly as in the C code."""
        px, py, _ = self.padded
        return self.margin + e + N_CELL_ENTRIES * (x + y * px + z * px * py)


def make_indices(cfg: LBMConfig):
    """Host-side precompute: (src (19, NC), dst (19, NC), flags (NC,)).

    GATHER layout: SRC_e(x) = entry e at x - dir_e (lbm_macros.h:130-150),
    DST is local.
    """
    x, y, z = np.meshgrid(np.arange(cfg.size_x), np.arange(cfg.size_y),
                          np.arange(cfg.size_z), indexing="ij")
    x, y, z = x.ravel(), y.ravel(), z.ravel()
    src = np.stack([cfg.calc_index(x - dx, y - dy, z - dz, e)
                    for e, (dx, dy, dz) in enumerate(DIRS)])
    dst = np.stack([cfg.calc_index(x, y, z, e) for e in range(FLAGS)])
    flags = cfg.calc_index(x, y, z, FLAGS)
    return src.astype(np.int32), dst.astype(np.int32), flags.astype(np.int32)


def init_ldc(cfg: LBMConfig) -> np.ndarray:
    """Initial grid for the lid-driven-cavity test (lbm.c:98-193).

    The reference's init sweeps the domain writing equilibrium through the
    same SRC_* gather stencil (so margins that later feed boundary gathers
    hold equilibrium too) and flags the 6 domain faces OBSTACLE with an
    ACCEL plate just inside the z faces.
    """
    grid = np.zeros(cfg.total_floats, np.float32)
    x, y, z = np.meshgrid(np.arange(cfg.size_x), np.arange(cfg.size_y),
                          np.arange(cfg.size_z), indexing="ij")
    x, y, z = x.ravel(), y.ravel(), z.ravel()
    for e, (dx, dy, dz) in enumerate(DIRS):
        grid[cfg.calc_index(x - dx, y - dy, z - dz, e)] = WEIGHTS[e]

    flags = np.zeros(x.shape, np.uint32)
    boundary = ((x == 0) | (x == cfg.size_x - 1) | (y == 0)
                | (y == cfg.size_y - 1) | (z == 0) | (z == cfg.size_z - 1))
    accel = (~boundary & ((z == 1) | (z == cfg.size_z - 2))
             & (x > 1) & (x < cfg.size_x - 2) & (y > 1) & (y < cfg.size_y - 2))
    flags = np.where(boundary, flags | OBSTACLE, flags)
    flags = np.where(accel, flags | ACCEL, flags)
    grid[cfg.calc_index(x, y, z, FLAGS)] = flags.view(np.float32)
    return grid


def _collide(f, accel):
    """BGK collision on gathered distributions f (19, NC) — the fluid
    branch of kernel.cl:75-146, with the reference's exact constants."""
    rho = jnp.sum(f, axis=0)
    n = {name: f[i] for i, name in enumerate(NAMES)}
    ux = (n["E"] - n["W"] + n["NE"] - n["NW"] + n["SE"] - n["SW"]
          + n["ET"] + n["EB"] - n["WT"] - n["WB"]) / rho
    uy = (n["N"] - n["S"] + n["NE"] + n["NW"] - n["SE"] - n["SW"]
          + n["NT"] + n["NB"] - n["ST"] - n["SB"]) / rho
    uz = (n["T"] - n["B"] + n["NT"] - n["NB"] + n["ST"] - n["SB"]
          + n["ET"] - n["EB"] + n["WT"] - n["WB"]) / rho
    ux = jnp.where(accel, np.float32(0.005), ux)
    uy = jnp.where(accel, np.float32(0.002), uy)
    uz = jnp.where(accel, np.float32(0.0), uz)
    u2 = np.float32(1.5) * (ux * ux + uy * uy + uz * uz) - np.float32(1.0)
    base = OMEGA * rho
    keep = np.float32(1.0) - OMEGA
    # projected velocity along each direction (C gets 0)
    dirs = jnp.asarray(DIRS, jnp.float32)
    cu = (dirs[:, 0, None] * ux[None]
          + dirs[:, 1, None] * uy[None]
          + dirs[:, 2, None] * uz[None])
    eq = WEIGHTS[:, None] * base[None] \
        * (cu * (np.float32(4.5) * cu + np.float32(3.0)) - u2[None])
    return keep * f + eq


def make_step(cfg: LBMConfig):
    """Build the jitted stream-collide step: grid (total_floats,) f32 ->
    next grid.  Margins and FLAGS pass through untouched (the kernel only
    writes the 19 domain distributions, kernel.cl:148-175)."""
    src_idx, dst_idx, flags_idx = make_indices(cfg)
    src_j = jnp.asarray(src_idx)
    dst_j = jnp.asarray(dst_idx)
    flags_j = jnp.asarray(flags_idx)
    opp = jnp.asarray(OPPOSITE)

    @jax.jit
    def step(grid):
        f = grid[src_j]                                     # (19, NC) gather
        flags = jax.lax.bitcast_convert_type(grid[flags_j], jnp.uint32)
        obstacle = (flags & OBSTACLE) != 0
        accel = (flags & ACCEL) != 0
        bounced = f[opp]                                    # swizzle pairs
        collided = _collide(f, accel)
        out = jnp.where(obstacle[None, :], bounced, collided)
        return grid.at[dst_j].set(out)

    return step


def run(cfg: LBMConfig = LBMConfig(), steps: int = 10,
        grid: np.ndarray | None = None):
    """Run `steps` stream-collide iterations; returns the final grid."""
    step = make_step(cfg)
    g = jnp.asarray(init_ldc(cfg) if grid is None else grid)
    g = jax.lax.fori_loop(0, steps, lambda _, g: step(g), g)
    return np.asarray(jax.block_until_ready(g))


def velocity_field(cfg: LBMConfig, grid: np.ndarray):
    """(NC, 3) cell velocities — the analog of LBM_storeVelocityField
    (lbm.c:304), used by the hosts' verification output."""
    _, _, flags_idx = make_indices(cfg)
    # local (post-write) distributions live at the cell itself
    local = np.stack([grid[flags_idx - FLAGS + e] for e in range(FLAGS)])
    rho = local.sum(0)
    vel = (DIRS.astype(np.float32).T @ local) / rho
    return vel.T
