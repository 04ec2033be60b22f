"""2-D occupancy-grid world of the particle-navigation task (counterpart
of `dust_tpu/models/obstacle_map.py`).

Map construction is host-side numpy, run once when the model is built:
rectangle rasterization with ceil cell math, border walls on the four map
edges, the named obstacle presets. `get_collisions` is the collision test
of every rollout step; it runs in torch on the points' device.

The raster holds only {0, 1} (rectangles set cells to 1.0), so the
occupied set is decomposed once into K disjoint cell-index rectangles and
`get_collisions` tests rectangle membership, equal to the raster lookup
for a binary map; `use_gather=True` (or a non-binary raster) indexes the
raster instead.
"""

from __future__ import annotations

import math
import random
from pathlib import Path

import numpy as np
import torch


class ObstacleMap:
    """Occupancy grid with its origin at the map center. `map` is the
    numpy raster; its torch copies are made per device on first use."""

    def __init__(self, map_dim, cell_size):
        if map_dim[0] % 2 or map_dim[1] % 2:
            raise ValueError("Map dimensions must be even.")
        cmap_x = math.ceil(map_dim[0] / cell_size)
        cmap_y = math.ceil(map_dim[1] / cell_size)
        self.map = np.zeros((cmap_x, cmap_y), dtype=np.float32)
        self.cell_size = float(cell_size)
        self.origin_xi = int(cmap_x / 2)
        self.origin_yi = int(cmap_y / 2)
        self.x_dim, self.y_dim = self.map.shape
        x_range = self.cell_size * self.x_dim
        y_range = self.cell_size * self.y_dim
        self.xlim = [-x_range / 2, x_range / 2]
        self.ylim = [-y_range / 2, y_range / 2]
        self._rect_bounds = None
        self._on_device = {}

    @property
    def c_offset(self):
        return np.array([self.origin_xi, self.origin_yi], dtype=np.float32)

    def convert_map(self):
        """Freeze the raster: compute the rectangle decomposition and drop
        the per-device copies made from an earlier raster."""
        self._rect_bounds = self._compute_rect_bounds()
        self._on_device = {}
        return self.map

    @property
    def rect_bounds(self):
        """(xlo, xhi, ylo, yhi) float32 numpy arrays [K] of half-open
        cell-index bounds of the K disjoint occupied rectangles, or None
        when the raster is not binary."""
        if self._rect_bounds is None:
            return self._compute_rect_bounds()
        return self._rect_bounds

    def _compute_rect_bounds(self):
        if not np.isin(self.map, (0.0, 1.0)).all():
            return None
        b = np.asarray(decompose_rects(self.map), dtype=np.float32)
        b = b.reshape(-1, 4)
        return tuple(b[:, i].copy() for i in range(4))

    def _tensors(self, device):
        """(raster, c_offset, rect bounds or None) as tensors on `device`,
        made once per device."""
        key = str(device)
        if key not in self._on_device:
            bounds = self.rect_bounds
            self._on_device[key] = (
                torch.as_tensor(self.map, device=device),
                torch.as_tensor(self.c_offset, device=device),
                None if bounds is None else tuple(
                    torch.as_tensor(b, device=device) for b in bounds),
            )
        return self._on_device[key]

    def get_xy_grid(self):
        """World-coordinate grid [x_dim, y_dim, 2]."""
        xv, yv = torch.meshgrid(
            torch.linspace(self.xlim[0], self.xlim[1], self.x_dim),
            torch.linspace(self.ylim[0], self.ylim[1], self.y_dim),
            indexing="ij",
        )
        return torch.stack((xv, yv), dim=2)

    def plot(self, save_dir=None, filename="obst_map.png"):
        """Draw the occupancy grid (origin lower left) and save it as
        `save_dir/filename` when `save_dir` is given (needs matplotlib)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure()
        plt.imshow(self.map.T, origin="lower")
        if save_dir is not None:
            plt.savefig(Path(save_dir) / filename)
        plt.close()

    def get_collisions(self, x, use_gather=False):
        """Occupancy values at world positions x [..., 2]: floor to cell
        indices, clamp to the map, look up occupancy (rectangle membership
        by default, the raster with `use_gather=True`)."""
        raster, c_offset, bounds = self._tensors(x.device)
        occ = torch.floor(x * (1.0 / self.cell_size) + c_offset)
        if bounds is not None and not use_gather:
            xi = torch.clamp(occ[..., 0], 0.0, self.map.shape[0] - 1.0)
            yi = torch.clamp(occ[..., 1], 0.0, self.map.shape[1] - 1.0)
            xlo, xhi, ylo, yhi = bounds
            inside = ((xi[..., None] >= xlo) & (xi[..., None] < xhi)
                      & (yi[..., None] >= ylo) & (yi[..., None] < yhi))
            return torch.any(inside, dim=-1).to(raster.dtype)
        occ = occ.to(torch.int32)
        xi = torch.clamp(occ[..., 0], 0, self.map.shape[0] - 1).long()
        yi = torch.clamp(occ[..., 1], 0, self.map.shape[1] - 1).long()
        return raster[xi, yi]


def decompose_rects(grid):
    """Decompose a binary occupancy grid into disjoint half-open cell-index
    rectangles [(xi_lo, xi_hi, yi_lo, yi_hi), ...] whose union is exactly
    the occupied set: occupied runs along y are extended across consecutive
    x rows while their (y_lo, y_hi) extents match."""
    grid = np.asarray(grid)
    rects = []
    prev = {}  # (y_lo, y_hi) -> xi where that run started
    for xi in range(grid.shape[0] + 1):
        cur = {}
        if xi < grid.shape[0]:
            row = grid[xi] > 0
            edges = np.flatnonzero(np.diff(np.concatenate(
                ([False], row, [False])
            ).astype(np.int8)))
            for y_lo, y_hi in edges.reshape(-1, 2):
                run = (int(y_lo), int(y_hi))
                cur[run] = prev.pop(run, xi)
        for (y_lo, y_hi), x_start in prev.items():
            rects.append((x_start, xi, y_lo, y_hi))
        prev = cur
    return rects


class ObstacleRectangle:
    """Axis-aligned rectangle rasterized with ceil cell math, the center
    snapped to an integer first."""

    def __init__(self, center_x=0, center_y=0, width=None, height=None):
        self.center_x = int(center_x)
        self.center_y = int(center_y)
        self.width = width
        self.height = height

    def add_to_map(self, obst_map: ObstacleMap):
        cs = obst_map.cell_size
        w = math.ceil(self.width / cs)
        h = math.ceil(self.height / cs)
        c_x = math.ceil(self.center_x / cs)
        c_y = math.ceil(self.center_y / cs)
        x_start = c_x - math.ceil(w / 2.0) + obst_map.origin_xi
        x_end = c_x + math.ceil(w / 2.0) + obst_map.origin_xi
        y_start = c_y - math.ceil(h / 2.0) + obst_map.origin_yi
        y_end = c_y + math.ceil(h / 2.0) + obst_map.origin_yi
        # raw numpy slicing on purpose: a negative start wraps and
        # start > end is empty; the border walls depend on it (PARITY #14)
        obst_map.map[x_start:x_end, y_start:y_end] = 1.0
        return obst_map

    def collision_check(self, obst_map: ObstacleMap):
        import copy

        test = self.add_to_map(copy.deepcopy(obst_map))
        return not np.any(test.map > 1)


def get_obst_preset(preset_name, obst_width=2):
    """The named obstacle layouts: [[cx, cy, w, w], ...]."""
    w = obst_width
    if preset_name == "staggered_3-2-3":
        centers = [(-4, 4), (0, 4), (4, 4), (-6, 0), (-2, 0), (2, 0), (6, 0),
                   (-4, -4), (0, -4), (4, -4)]
    elif preset_name == "staggered_4-3-4-3-4":
        centers = [(-6, 6), (-2, 6), (2, 6), (6, 6),
                   (-4, 3), (0, 3), (4, 3),
                   (-6, 0), (-2, 0), (2, 0), (6, 0),
                   (-4, -3), (0, -3), (4, -3),
                   (-6, -6), (-2, -6), (2, -6), (6, -6)]
    elif preset_name == "grid_3x3":
        s = 5
        centers = [(i * s, j * s) for j in (1, 0, -1) for i in (-1, 0, 1)]
    elif preset_name == "grid_4x4":
        s = 4
        centers = [(i * s / 2, j * s / 2)
                   for j in (3, 1, -1, -3) for i in (-3, -1, 1, 3)]
    elif preset_name == "grid_6x6":
        s = 3
        centers = [(i * s / 2, j * s / 2)
                   for j in (5, 3, 1, -1, -3, -5) for i in (-5, -3, -1, 1, 3, 5)]
    elif preset_name == "single_centred":
        centers = [(0, 0)]
    else:
        raise IOError(f"Obstacle preset not supported: {preset_name}")
    return [[cx, cy, w, w] for cx, cy in centers]


def generate_obstacle_map(map_dim=(10, 10), obst_list=(), cell_size=1.0,
                          map_type=None, random_gen=False, num_obst=0,
                          rand_xy_limits=None, rand_shape=(2, 2), seed=None):
    """Build the occupancy grid: fixed rectangles, 4 border walls, optional
    random rectangles drawn from `random.Random(seed)`."""
    obst_map = ObstacleMap(map_dim, cell_size)

    for cx, cy, width, height in obst_list:
        ObstacleRectangle(cx, cy, width, height).add_to_map(obst_map)

    # border walls
    for limit in obst_map.xlim:
        ObstacleRectangle(
            limit, 0, 4 * obst_map.cell_size, obst_map.ylim[1] - obst_map.ylim[0]
        ).add_to_map(obst_map)
    for limit in obst_map.ylim:
        ObstacleRectangle(
            0, limit, obst_map.xlim[1] - obst_map.xlim[0], 4 * obst_map.cell_size
        ).add_to_map(obst_map)

    if random_gen:
        rng = random.Random(seed)
        xlim, ylim = rand_xy_limits
        width, height = rand_shape
        added = len(list(obst_list))
        while added < num_obst:
            placed = False
            for _ in range(25):
                rect = ObstacleRectangle(
                    rng.uniform(*xlim), rng.uniform(*ylim), width, height
                )
                if rect.collision_check(obst_map):
                    rect.add_to_map(obst_map)
                    placed = True
                    added += 1
                    break
            if not placed:
                break

    if map_type not in (None, "direct"):
        raise IOError(f'Map type "{map_type}" not recognized')
    obst_map.convert_map()
    return obst_map
