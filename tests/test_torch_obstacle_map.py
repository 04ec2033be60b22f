"""The obstacle map of the particle task: the port's host-side map
construction and its torch collision test against `dust_tpu`'s, and the
occupancy helpers that the particle kernels' plain versions use.

Everything here is compared exactly: one wrong occupancy boolean moves a
navigation cost by w_obs = 1e6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.models.obstacle_map import decompose_rects as j_decompose
from dust_tpu.models.obstacle_map import generate_obstacle_map as j_generate
from dust_tpu.models.obstacle_map import get_obst_preset as j_preset
from dust_tpu.ops.pallas_particle_rollout import (
    _periodic_intervals as j_periodic,
)
from dust_tpu.ops.pallas_particle_rollout import factor_rects as j_factor
from dust_tpu.ops.pallas_particle_rollout import occupancy_hit as j_hit
from dust_tpu_torch.models.obstacle_map import (
    decompose_rects,
    generate_obstacle_map,
    get_obst_preset,
)
from dust_tpu_torch.ops.particle_rollout import (
    _periodic_intervals,
    factor_rects,
    occupancy_hit,
    occupancy_words,
)

PRESETS = ("staggered_3-2-3", "staggered_4-3-4-3-4", "grid_3x3", "grid_4x4",
           "grid_6x6", "single_centred")
# the demo map: grid_4x4, width 2.1, 22 x 22 m at 0.1 m cells
DEMO = dict(map_dim=[22, 22], cell_size=0.1, map_type="direct")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maps(preset, width, **kw):
    return (j_generate(obst_list=j_preset(preset, width), **kw),
            generate_obstacle_map(obst_list=get_obst_preset(preset, width),
                                  **kw))


def _rects(om):
    return tuple((float(a), float(b), float(c), float(d))
                 for a, b, c, d in zip(*(np.asarray(v)
                                         for v in om.rect_bounds)))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("width,kw", [
    (2.1, DEMO),
    (2, dict(map_dim=[20, 20], cell_size=0.25)),
])
def test_presets_raster_and_rectangles_equal_jax(preset, width, kw):
    assert get_obst_preset(preset, width) == j_preset(preset, width)
    jm, tm = _maps(preset, width, **kw)
    np.testing.assert_array_equal(tm.map, jm.map)
    assert tm.map.dtype == jm.map.dtype
    assert decompose_rects(tm.map) == j_decompose(jm.map)
    for a, b in zip(tm.rect_bounds, jm.rect_bounds):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(tm.c_offset, jm.c_offset)
    assert (tm.xlim, tm.ylim) == (jm.xlim, jm.ylim)
    # numpy slicing of the border walls: the high-side walls fill the
    # last rows and columns; the low-side walls start below 0, wrap past
    # their end and stay empty
    assert tm.map[-1].all() and tm.map[:, -1].all()
    assert tm.map[0].sum() < tm.map.shape[1] / 2


def test_seeded_random_map_equals_jax():
    kw = dict(map_dim=[20, 20], cell_size=0.2, random_gen=True, num_obst=9,
              rand_xy_limits=([-8, 8], [-8, 8]), rand_shape=(2, 3), seed=5)
    jm = j_generate(obst_list=[[0, 0, 2, 2]], **kw)
    tm = generate_obstacle_map(obst_list=[[0, 0, 2, 2]], **kw)
    np.testing.assert_array_equal(tm.map, jm.map)
    base = generate_obstacle_map(obst_list=[[0, 0, 2, 2]],
                                 **dict(kw, random_gen=False))
    assert tm.map.sum() > base.map.sum()   # random rectangles were placed
    assert decompose_rects(tm.map) == j_decompose(jm.map)


def test_unknown_preset_and_map_type_raise():
    with pytest.raises(IOError, match="preset"):
        get_obst_preset("nope")
    with pytest.raises(IOError, match="Map type"):
        generate_obstacle_map(map_dim=[4, 4], map_type="other")
    with pytest.raises(ValueError, match="even"):
        generate_obstacle_map(map_dim=[5, 4])


def test_occupancy_hit_equals_jax_on_every_cell_of_the_demo_map():
    jm, tm = _maps("grid_4x4", 2.1, **DEMO)
    rects = _rects(tm)
    assert rects == _rects(jm)
    xs, ys, left = factor_rects(rects)
    assert (xs, ys, left) == j_factor(rects)
    assert xs is not None      # the demo grid factors
    imax = tm.map.shape[0] - 1.0
    for ivs in (xs, ys):
        assert _periodic_intervals(ivs, imax) == j_periodic(ivs, imax)
    cells = np.arange(tm.map.shape[0], dtype=np.float32)
    xi, yi = np.meshgrid(cells, cells, indexing="ij")
    bounds = (imax, tm.map.shape[1] - 1.0)
    got = occupancy_hit(torch.tensor(xi), torch.tensor(yi), rects,
                        bounds).numpy()
    want = np.asarray(j_hit(jnp.asarray(xi), jnp.asarray(yi), rects,
                            bounds))
    np.testing.assert_array_equal(got, want)
    # and both equal the raster itself
    np.testing.assert_array_equal(got, tm.map > 0)
    # without the clamp bounds, every comparison is kept: same booleans
    np.testing.assert_array_equal(
        occupancy_hit(torch.tensor(xi), torch.tensor(yi), rects).numpy(),
        got)
    # the kernels' bit per cell (ops/particle_rollout.py:occupancy_words)
    grid = (10.0, 110.0, 110.0, imax, bounds[1])
    words = occupancy_words(rects, grid)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(
        bits[:xi.size].reshape(xi.shape).astype(bool), want)


def _world_points(tm, rng):
    cs = tm.cell_size
    off = tm.c_offset
    n = 4000
    # uniform points over and beyond the map
    pts = [rng.uniform(-14.0, 14.0, size=(n, 2))]
    # exactly on cell edges (world coordinates of integer cell indices)
    k = rng.integers(-5, tm.map.shape[0] + 5, size=(n, 2))
    pts.append((k - off) * cs)
    # a hair either side of the edges
    pts.append((k - off) * cs + 1e-6)
    pts.append((k - off) * cs - 1e-6)
    # far outside, and the corners
    pts.append(np.array([[1e4, -1e4], [-11.0, -11.0], [11.0, 11.0],
                         [10.95, -10.95], [0.0, 0.0]]))
    return np.concatenate(pts).astype(np.float32)


@pytest.mark.parametrize("use_gather", [False, True])
def test_get_collisions_equals_jax_at_random_world_points(rng, use_gather):
    jm, tm = _maps("grid_4x4", 2.1, **DEMO)
    pts = _world_points(tm, rng)
    got = tm.get_collisions(torch.tensor(pts), use_gather=use_gather)
    want = np.asarray(jm.get_collisions(jnp.asarray(pts),
                                        use_gather=use_gather))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # both paths agree, on batched shapes too
    other = tm.get_collisions(torch.tensor(pts).reshape(-1, 5, 2),
                              use_gather=not use_gather)
    np.testing.assert_array_equal(other.reshape(-1).numpy(), want)
    assert 0.05 < want.mean() < 0.95
