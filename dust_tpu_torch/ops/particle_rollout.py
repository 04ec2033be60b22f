"""Fused particle rollout costs (K6): counterpart of
`dust_tpu/ops/pallas_particle_rollout.py`, with its occupancy helpers.

All n_params x n_actions x n_pol point-mass trajectories evolve and only
their navigation costs sum_{t<H} inst(s_t, a_t) + term(s_H) come back, as
[n_params, n_actions, n_pol]. Each step computes the occupancy of the
current state once and shares it between the cost term `w_obs * occ` and
the crash-freeze factor `dt * (1 - occ)`; the position advances with the
old velocity, then the velocity is clamped to +-max_speed.

* On CUDA tensors `fused_particle_rollout_costs` launches the
  hand-written kernel `csrc/particle_rollout.cu` (which replaces the TPU
  kernel `dust_tpu/ops/pallas_particle_rollout.py:
  fused_particle_rollout_costs`): a block per 32 trajectories, one
  thread per (draw, trajectory), the actions read in their native layout
  (`kernel_operands`: no copy) and staged in shared memory, the occupancy
  a lookup in a bit per map cell held there too. It is bound by its
  H-step dependent chain.
* On CPU tensors it runs `particle_rollout_costs_plain`, the same
  arithmetic in plain PyTorch, with the occupancy of `occupancy_hit`.

`model_tensor` packs a model's cost weights, target, limits, grid and
rectangles into the one float32 array the particle kernels (K6-K9) read.
"""

from __future__ import annotations

import functools
from collections import Counter

import numpy as np
import torch

from .phase_clock import PhaseClock

# model_tensor layout: cost weights (w_px, w_py, w_vx, w_vy, w_cx, w_cy,
# w_obs, wt_px, wt_py, wt_vx, wt_vy), target (4), dt, max_acc, max_speed,
# grid (inv_cell, offx, offy, ximax, yimax), crash, has_map, n_words, then
# the occupancy bits as n_words uint32 words (`occupancy_words`);
# csrc/particle.cuh reads the same offsets
MODEL_HEADER = 26
# the kernels hold the occupancy bits in shared memory (8 KB)
MAX_CELLS = 65536
# trajectories per block of K6 (csrc/particle_rollout.cu:kTraj), and the
# mass draws a block takes (kMaxDraws; more go to further blocks)
TRAJ_PER_BLOCK = 32
_MAX_DRAWS = 8
# the phases of K6 that its clocked build times, in order
# (csrc/particle_rollout.cu, kClkLoad ... kClkStore)
CLOCK_PHASES = ("load", "rollouts", "store")
# `with phase_clock() as rows:` launches K6's clocked build
phase_clock = PhaseClock(CLOCK_PHASES)


# -- occupancy ------------------------------------------------------------------


def factor_rects(rects):
    """Split the rectangle set into (x_intervals, y_intervals, leftover)
    such that the cross product of the interval lists is a subset of
    `rects`; (None, None, rects) when no cross product of >= 4 rectangles
    exists. The OR of the factored tests equals the per-rectangle OR."""
    if rects is None:
        return None, None, None
    cx = Counter((xl, xh) for xl, xh, _, _ in rects)
    cy = Counter((yl, yh) for _, _, yl, yh in rects)
    xs = tuple(sorted(iv for iv, c in cx.items() if c >= 2))
    ys = tuple(sorted(iv for iv, c in cy.items() if c >= 2))
    cross = {(xl, xh, yl, yh) for xl, xh in xs for yl, yh in ys}
    if len(cross) >= 4 and cross <= set(rects):
        leftover = tuple(r for r in rects if r not in cross)
        return xs, ys, leftover
    return None, None, rects


def _periodic_intervals(ivs, vmax):
    """(offset, period, width, lo, hi) when the interval list is a uniform
    arithmetic progression whose periodic-remainder membership test is
    exhaustively equal, in float32, to the interval OR over the clamped
    integer cell domain [0, vmax]; None otherwise."""
    if vmax is None or len(ivs) < 3:
        return None
    w = ivs[0][1] - ivs[0][0]
    if any((h - l) != w for l, h in ivs):
        return None
    p = ivs[1][0] - ivs[0][0]
    if p <= 0 or any(ivs[k][0] != ivs[0][0] + k * p
                     for k in range(len(ivs))):
        return None
    off, lo, hi = ivs[0][0], ivs[0][0], ivs[-1][1]
    cells = np.arange(0.0, float(vmax) + 1.0, dtype=np.float32)
    u = cells - np.float32(off)
    r = u - np.float32(p) * np.floor(u * np.float32(1.0 / p))
    fast = ((r < np.float32(w)) & (cells >= np.float32(lo))
            & (cells < np.float32(hi)))
    ref = np.zeros_like(fast)
    for l, h in ivs:
        ref |= (cells >= np.float32(l)) & (cells < np.float32(h))
    if not np.array_equal(fast, ref):
        return None
    return float(off), float(p), float(w), float(lo), float(hi)


def occupancy_hit(xi, yi, rects, bounds=None):
    """Boolean occupancy of clamped cell-index tensors xi, yi: factored
    interval tests when the rectangle set decomposes (`factor_rects`,
    a periodic-remainder test per axis where `_periodic_intervals`
    verifies one), per-rectangle tests otherwise. bounds=(ximax, yimax)
    states that the caller clamps xi to [0, ximax] and yi to [0, yimax];
    comparisons that are then always true are dropped."""
    ximax = bounds[0] if bounds is not None else None
    yimax = bounds[1] if bounds is not None else None

    def ge(v, lo):
        return None if lo <= 0.0 else (v >= lo)

    def lt(v, hi, vmax):
        return None if (vmax is not None and hi > vmax) else (v < hi)

    def conj(*terms):
        out = None
        for term in terms:
            if term is None:
                continue
            out = term if out is None else (out & term)
        return (xi >= 0.0) if out is None else out

    def band_in(v, ivs, vmax):
        per = _periodic_intervals(ivs, vmax)
        if per is not None:
            off, period, width, lo, hi = per
            u = v - off
            r = u - period * torch.floor(u * (1.0 / period))
            return (r < width) & conj(ge(v, lo), lt(v, hi, vmax))
        out = None
        for lo_, hi_ in ivs:
            h = conj(ge(v, lo_), lt(v, hi_, vmax))
            out = h if out is None else (out | h)
        return out

    xs, ys, leftover = factor_rects(rects)
    hit = None
    if xs is not None:
        hit = band_in(xi, xs, ximax) & band_in(yi, ys, yimax)
    for xl, xh, yl, yh in leftover:
        h = conj(ge(xi, xl), lt(xi, xh, ximax),
                 ge(yi, yl), lt(yi, yh, yimax))
        hit = h if hit is None else (hit | h)
    return hit


def cell_indices(px, py, grid):
    """Clamped float cell indices of world positions:
    clip(floor(p * inv_cell + off), 0, imax)."""
    inv_cell, offx, offy, ximax, yimax = grid
    xi = torch.clamp(torch.floor(px * inv_cell + offx), 0.0, ximax)
    yi = torch.clamp(torch.floor(py * inv_cell + offy), 0.0, yimax)
    return xi, yi


def occupancy(px, py, rects, grid):
    """1.0 inside an obstacle cell, else 0.0; None without a map."""
    if rects is None:
        return None
    xi, yi = cell_indices(px, py, grid)
    hit = occupancy_hit(xi, yi, rects, (grid[3], grid[4]))
    return torch.where(hit, 1.0, 0.0)


# -- model statics ----------------------------------------------------------------


def particle_kernel_statics(model):
    """Validate a `Particle` model for the fused kernels and extract their
    configuration: dict(weights, target, rects, grid, crash) of plain
    floats and tuples."""
    if model.control_type != "acceleration":
        raise ValueError(
            "fused particle rollout supports acceleration control only"
        )
    if not model.deterministic:
        raise ValueError(
            "fused particle rollout requires deterministic dynamics (the "
            "kernel has no RNG for control noise) - use the rollout loop"
        )
    if tuple(model.uncertain_params or ()) not in ((), ("mass",)):
        raise ValueError(
            "fused particle rollout supports exactly one uncertain param:"
            f" ('mass',), got {tuple(model.uncertain_params)}"
        )
    vals = lambda t: tuple(float(v) for v in t.detach().cpu().numpy())
    weights = (*vals(model.w_state), *vals(model.w_ctrl),
               float(model.w_obs), *vals(model.w_term))
    target = vals(model.target)

    rects, grid = None, None
    if model.with_obstacle and model.obst_map is not None:
        bounds = model.obst_map.rect_bounds
        if bounds is None:
            raise ValueError(
                "fused particle rollout needs a binary occupancy raster "
                "(rectangle decomposition unavailable) - use the rollout loop"
            )
        rects = tuple(
            (float(a), float(b), float(c), float(d))
            for a, b, c, d in zip(*bounds)
        )
        om = model.obst_map
        grid = (
            1.0 / om.cell_size,
            float(om.c_offset[0]), float(om.c_offset[1]),
            float(om.map.shape[0] - 1), float(om.map.shape[1] - 1),
        )
    crash = model.can_crash and model.with_obstacle
    return dict(weights=weights, target=target, rects=rects, grid=grid,
                crash=crash)


def occupancy_words(rects, grid):
    """The occupancy of every clamped cell (xi, yi), set from the disjoint
    rectangles, as little-endian uint32 words: bit xi * (yimax + 1) + yi.
    Equal to `occupancy_hit` on every cell (tests/test_torch_obstacle_map
    .py)."""
    nx, ny = int(grid[3]) + 1, int(grid[4]) + 1
    if nx * ny > MAX_CELLS:
        raise ValueError(f"the particle kernels hold at most {MAX_CELLS} "
                         f"map cells, the map has {nx * ny}")
    raster = np.zeros((nx, ny), dtype=bool)
    for xl, xh, yl, yh in rects:
        raster[int(xl):int(xh), int(yl):int(yh)] = True
    packed = np.packbits(raster.reshape(-1), bitorder="little")
    packed = np.concatenate([packed,
                             np.zeros(-len(packed) % 4, np.uint8)])
    return packed.view("<u4")


@functools.lru_cache(maxsize=16)
def _model_tensor(dt, max_acc, max_speed, weights, target, rects, grid,
                  crash, device):
    words = (np.zeros(0, "<u4") if rects is None
             else occupancy_words(rects, grid))
    head = [*weights, *target, dt, max_acc, max_speed,
            *(grid if grid is not None else (0.0,) * 5),
            float(bool(crash) and rects is not None),
            float(rects is not None), float(len(words))]
    # the words travel as the bits of float32 values
    flat = np.concatenate([np.asarray(head, np.float32),
                           words.view(np.float32)])
    return torch.from_numpy(flat).to(device)


def model_tensor(statics, dt, max_acc, max_speed, device):
    """The particle kernels' model array on `device` (see MODEL_HEADER),
    made once per configuration and device."""
    return _model_tensor(float(dt), float(max_acc), float(max_speed),
                         tuple(statics["weights"]), tuple(statics["target"]),
                         statics["rects"], statics["grid"],
                         bool(statics["crash"]), str(torch.device(device)))


# -- the rollout ------------------------------------------------------------------


def _state_cost(px, py, vx, vy, occ, quad, target, w_obs):
    wpx, wpy, wvx, wvy = quad
    tx, ty, tvx, tvy = target
    c = (wpx * (px - tx) ** 2 + wpy * (py - ty) ** 2
         + wvx * (vx - tvx) ** 2 + wvy * (vy - tvy) ** 2)
    if occ is not None:
        c = c + w_obs * occ
    return c


def rollout_costs(s0, act, im, shape, st):
    """Navigation costs of a batch of trajectories, the arithmetic of the
    TPU kernel operation by operation. s0: the 4 start coordinates, each a
    tensor broadcastable to `shape`; act(t) -> (a_x, a_y) broadcastable to
    `shape`; im: 1/mass broadcastable to `shape`; st: dict(hz, dt,
    max_acc, max_speed, weights, target, rects, grid, crash). Returns
    cost of `shape`."""
    (w_px, w_py, w_vx, w_vy, w_cx, w_cy, w_obs,
     wt_px, wt_py, wt_vx, wt_vy) = st["weights"]
    target, rects, grid = st["target"], st["rects"], st["grid"]
    dt, max_acc, max_speed = st["dt"], st["max_acc"], st["max_speed"]
    crash = st["crash"] and rects is not None
    dev = im.device
    zs = torch.zeros(shape, dtype=torch.float32, device=dev)
    px, py, vx, vy = (zs + v for v in s0)
    cost = zs
    for t in range(st["hz"]):
        occ = occupancy(px, py, rects, grid)
        a_x, a_y = act(t)
        cost = cost + (
            _state_cost(px, py, vx, vy, occ, (w_px, w_py, w_vx, w_vy),
                        target, w_obs)
            + w_cx * a_x * a_x + w_cy * a_y * a_y
        )
        acc_x = torch.clamp(a_x * im, -max_acc, max_acc)
        acc_y = torch.clamp(a_y * im, -max_acc, max_acc)
        scale = dt * (1.0 - occ) if crash else dt
        px, py = px + vx * scale, py + vy * scale
        vx = torch.clamp(vx + acc_x * scale, -max_speed, max_speed)
        vy = torch.clamp(vy + acc_y * scale, -max_speed, max_speed)
    return cost + _state_cost(px, py, vx, vy, occupancy(px, py, rects, grid),
                              (wt_px, wt_py, wt_vx, wt_vy), target, w_obs)


def _statics(hz, dt, max_acc, max_speed, weights, target, rects, grid, crash):
    return dict(hz=int(hz), dt=float(dt), max_acc=float(max_acc),
                max_speed=float(max_speed), weights=tuple(weights),
                target=tuple(target), rects=rects, grid=grid,
                crash=bool(crash))


def particle_rollout_costs_plain(state0, actions, masses, *, dt, max_acc,
                                 max_speed, weights, target, rects, grid,
                                 crash):
    """Plain PyTorch version of the kernel: state0 [4], actions
    [n_act, n_pol, H, 2], masses [n_params] -> [n_params, n_act, n_pol]."""
    n_act, n_pol, hz, _ = actions.shape
    n_params = masses.shape[0]
    st = _statics(hz, dt, max_acc, max_speed, weights, target, rects, grid,
                  crash)
    im = (1.0 / masses).reshape(n_params, 1, 1)
    return rollout_costs(
        tuple(state0[i] for i in range(4)),
        lambda t: (actions[:, :, t, 0], actions[:, :, t, 1]), im,
        (n_params, n_act, n_pol), st)


def kernel_operands(state0, actions, masses):
    """The tensors K6 reads: state0 [4], the actions in their native
    layout [n_act, n_pol, H, 2] (trajectory r = a * n_pol + pol is the
    row of 2 H values at r * 2 H: what `particle_rollout_costs_plain`
    reads as actions[a, pol, t, :]), masses [n_params]; contiguous, so
    for contiguous inputs views of the caller's storage, no copy."""
    return (state0.reshape(4).contiguous(), actions.contiguous(),
            masses.contiguous())


def fused_particle_rollout_costs(state0, actions, masses, *, dt, max_acc,
                                 max_speed, weights, target, rects, grid,
                                 crash):
    """Navigation costs of every (param draw, action sample, policy)
    particle rollout. state0 [4]; actions [n_actions, n_pol, H, 2] (shared
    across param draws); masses [n_params]; the rest as
    `particle_kernel_statics` returns them, plus the model's dt and limits.
    Returns [n_params, n_actions, n_pol].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in `fused_particle_rollout_costs.launches`)."""
    statics = dict(weights=weights, target=target, rects=rects, grid=grid,
                   crash=crash)
    if actions.device.type == "cpu":
        return particle_rollout_costs_plain(
            state0, actions, masses, dt=dt, max_acc=max_acc,
            max_speed=max_speed, **statics)
    if actions.device.type != "cuda":
        raise ValueError(f"unsupported device {actions.device}")
    n_act, n_pol, hz, a_dim = actions.shape
    n_params = masses.shape[0]
    if a_dim != 2 or state0.numel() != 4 or masses.shape != (n_params,):
        raise ValueError(
            "expected state0 [4], actions [n_act, n_pol, H, 2], masses "
            "[n_params]"
        )
    if any(t.dtype != torch.float32 or t.device != actions.device
           for t in (state0, actions, masses)):
        raise ValueError("all inputs must be float32 on the same device")
    if n_params * n_act * n_pol == 0 or hz == 0:
        raise ValueError("empty rollout batch")
    from ._build import check, load_library

    model = model_tensor(statics, dt, max_acc, max_speed, actions.device)
    s0, acts, masses = kernel_operands(state0, actions, masses)
    costs = torch.empty((n_params, n_act, n_pol), dtype=torch.float32,
                        device=actions.device)
    args = [model.data_ptr(), model.numel(), s0.data_ptr(), acts.data_ptr(),
            masses.data_ptr(), costs.data_ptr(), n_params, n_act * n_pol, hz]
    blocks = ((n_act * n_pol + TRAJ_PER_BLOCK - 1) // TRAJ_PER_BLOCK
              * ((n_params + _MAX_DRAWS - 1) // _MAX_DRAWS))
    clock = phase_clock.rows(blocks, actions.device)
    stream = torch.cuda.current_stream(actions.device).cuda_stream
    if clock is None:
        rc = load_library().dust_particle_rollout_costs(*args, stream)
    else:
        rc = load_library().dust_particle_rollout_costs_clock(
            *args, clock.data_ptr(), stream)
    fused_particle_rollout_costs.launches += 1
    check(rc, "particle_rollout_costs")
    return costs


fused_particle_rollout_costs.launches = 0


def particle_occupancy_probe(points, *, rects, grid):
    """Occupancy (1.0 / 0.0) of world points [n, 2] as the particle
    kernels' device code computes it (`csrc/particle.cuh:occupancy`), for
    checking it against `occupancy_hit` on the card. CPU tensors take the
    plain version. Not a kernel of any path: it launches no counted
    kernel."""
    px, py = points[:, 0], points[:, 1]
    if points.device.type == "cpu":
        return occupancy(px, py, rects, grid)
    from ._build import check, load_library

    statics = dict(weights=(0.0,) * 11, target=(0.0,) * 4, rects=rects,
                   grid=grid, crash=False)
    model = model_tensor(statics, 0.0, 0.0, 0.0, points.device)
    pts = points.to(torch.float32).contiguous()
    out = torch.empty((pts.shape[0],), dtype=torch.float32,
                      device=points.device)
    rc = load_library().dust_particle_occupancy(
        model.data_ptr(), pts.data_ptr(), out.data_ptr(), pts.shape[0],
        torch.cuda.current_stream(points.device).cuda_stream,
    )
    check(rc, "particle_occupancy")
    return out


def make_fused_particle_state_costs(model):
    """Build the `MultiDisco(fused_state_costs=...)` hook for a
    deterministic acceleration-control `Particle` model: (state, actions
    [n_actions, n_pol, H, 2], params dict|None) -> state costs
    [n_actions, n_pol], the mean over the parameter draws."""
    statics = particle_kernel_statics(model)
    m_def = float(model.params_dict["mass"])
    kw = dict(dt=float(model.dt), max_acc=model.max_acc,
              max_speed=model.max_speed, **statics)

    def hook(state, actions, params):
        s0 = state.reshape(-1)[:4].to(torch.float32)
        if params is None:
            masses = torch.full((1,), m_def, device=actions.device)
        else:
            unknown = set(params) - {"mass"}
            if unknown:
                raise ValueError(
                    "fused particle state-cost hook only supports a mass"
                    f" parameter column, got {sorted(unknown)} - use the"
                    " rollout loop for other overrides"
                )
            masses = params["mass"].reshape(-1)
        costs = fused_particle_rollout_costs(s0, actions, masses, **kw)
        return costs.mean(dim=0)

    return hook
