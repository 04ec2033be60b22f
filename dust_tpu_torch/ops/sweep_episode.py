"""Scenario sweeps of whole pendulum DuSt episodes in one launch (K5):
counterpart of `dust_tpu/ops/pallas_sweep_episode.py:
fused_pendulum_sweep_episode`.

n_sc scenarios (per-scenario true parameters, Silverman bandwidths and
MPF posteriors) times `n_chains` independent episode chains advance in one
program. The TPU kernel packs scenarios into tile rows and lane halves;
here every (group, chain, scenario) episode is one block of the
whole-episode kernel (`csrc/pendulum_episode.cu`, the entry K4 launches
too), so each scenario's values equal an
independent `fused_pendulum_episode` run on the same draws, and a diverged
scenario cannot reach another one. The controller a_seq term is dropped
(the adapter asserts a_seq == 0, as the TPU kernel does).

`fused_pendulum_sweep_groups` folds a leading group axis G into the same
launch (the `MegakernelGroupSweep` path); `fused_pendulum_sweep_episode`
is its G = 1 case. On CPU tensors both run the plain version,
`ops.episode.pendulum_episode_plain`, batched over all episodes.

Device-RNG mode keys each episode's draws by (chain seed, step, scenario
index); the TPU stream is equal in distribution only.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .episode import (
    LOG_FIELDS,
    episode_plain,
    episode_scal,
    episode_statics,
    kernel_statics,
    run_episodes,
    split_log,
)
from .sweep_inputs import InputCache, Prepared, head

_LAYOUTS = ("colbcast", "lanepack", "symm")
# the TPU kernel's chain-seed stride (`pallas_sweep_episode.py:1376-1392`)
_CHAIN_SEED_STRIDE = 4099


def _round8(n):
    return -(-n // 8) * 8


def check_sweep_dims(n_sc, hz, m, n_params, n_act, m_mpf, mpf_drive_layout,
                     probe_skip):
    """The TPU adapter's limits, kept as coded
    (`pallas_sweep_episode.py:1345-1371`)."""
    if n_sc > 16:
        raise ValueError("sweep episode kernel: n_sc <= 16 per program "
                         "(batch larger sweeps on the group axis)")
    if mpf_drive_layout not in _LAYOUTS:
        raise ValueError("sweep episode kernel: mpf_drive_layout must "
                         "be 'colbcast', 'lanepack' or 'symm'")
    if tuple(probe_skip) != ():
        raise ValueError("sweep episode kernel: probe_skip is a TPU "
                         "attribution probe; only () is supported")
    if hz > 128 or n_act > 128:
        raise ValueError("sweep episode kernel: hz<=128, n_act<=128")
    if n_params > 8:
        raise ValueError("sweep episode kernel: n_params <= 8")
    if m * hz > 128:
        raise ValueError("sweep episode kernel: m*hz <= 128")
    if _round8(max(m_mpf, 8)) > 64:
        raise ValueError("sweep episode kernel: m_mpf <= 64")


class SeedRows:
    """A call's per-episode seed inputs, from per-chain offsets and a
    scenario column made once. Called with seeds [G, 2] or [G, k, 2]
    int64 (G and k as made): chain c < k takes its given seed; a chain
    c >= k takes chain 0's plus 4099 c on the second word (the TPU
    kernel's chain-seed stride); episode b = (g * C + c) * n_sc + s takes
    its chain's seed and scenario s. With `packed` (the kernel's form)
    {"ep_i": [B, 3] int32}, the rows of `ops.episode.episode_ids` (a copy
    of a kept scenario column, then one int64 add into its seed columns,
    cast as `.to` casts); else {"seeds": [B, 2], "scenario": [B]}."""

    def __init__(self, G, k, n_chains, n_sc, device, packed):
        C = n_chains
        self.C, self.packed = C, packed
        # chains c >= k: chain 0 plus 4099 c on the second word
        self.pick = None
        if 1 < k < C:
            self.pick = torch.tensor([c if c < k else 0 for c in range(C)],
                                     device=device)
        offs = torch.zeros((C, 1, 1, 2), dtype=torch.int64)
        for c in range(k, C):
            offs[c, 0, 0, 1] = _CHAIN_SEED_STRIDE * c
        # the sum is laid out [C, n_sc, G, 2], so that [G, 2] seeds broadcast
        # against it with no view of their own
        self.offs = offs.to(device).expand(C, n_sc, 1, 2)
        scenario = torch.arange(n_sc, device=device)
        if packed:
            self.ids = torch.zeros((G * C * n_sc, 3), dtype=torch.int32,
                                   device=device)
            self.ids[:, 2] = scenario.repeat(G * C)
            # the seed columns of a [B, 3] copy of `ids` as [C, n_sc, G, 2]
            self.seed_cols = ((C, n_sc, G, 2),
                              (3 * n_sc, 3, 3 * C * n_sc, 1))
        else:
            self.scenario = scenario.repeat(G * C)

    def __call__(self, seeds):
        if seeds.ndim == 3:
            s = seeds[:, :self.C] if self.pick is None else seeds[:, self.pick]
            seeds = s.transpose(0, 1)[:, None]             # [C, 1, G, 2]
        if self.packed:
            ep_i = self.ids.clone()
            torch.add(seeds, self.offs,
                      out=ep_i.as_strided(*self.seed_cols))
            return {"ep_i": ep_i}
        rows = torch.add(seeds, self.offs).permute(2, 0, 1, 3)
        return {"seeds": rows.reshape(-1, 2), "scenario": self.scenario}


def _host_noise(host_eps, host_pdz, host_pdu, G, C, n_sc, steps, hz, m,
                n_params, n_act, dev):
    """JAX-layout host noise with a leading group axis (and a chain axis
    when C > 1) -> canonical per-episode tensors, episode b = (g*C + c)*n_sc
    + s: eps [B, steps, hz, m, n_act], pdz [B, steps, n_params, 2],
    pdu [B, steps, n_params]."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    sm = n_sc * m
    eps = f32(host_eps).reshape(G, C, steps, hz, -1, 128)[..., :sm, :n_act]
    eps = eps.reshape(G, C, steps, hz, n_sc, m, n_act).permute(
        0, 1, 4, 2, 3, 5, 6).reshape(-1, steps, hz, m, n_act)
    pdz = f32(host_pdz).reshape(G, C, steps, n_sc, 8, 128)[..., :n_params, :2]
    pdz = pdz.permute(0, 1, 3, 2, 4, 5).reshape(-1, steps, n_params, 2)
    pdu = f32(host_pdu).reshape(G, C, steps, n_sc, 8, 128)[..., :n_params, 0]
    pdu = pdu.permute(0, 1, 3, 2, 4).reshape(-1, steps, n_params)
    return eps, pdz, pdu


def _prepare(
        runner, seeds_shape, state0, theta0, locs0, a_mat0, mpfx0, prior_bw0,
        true_lengths, true_masses, ctrl_sigma, lr, alpha, temp,
        prior_sigma, mpf_lr, mpf_sigma, *, n_sc, steps, warm_up=0, hz,
        m, n_params, n_act, m_mpf, mpf_steps, dt=0.05, g_model=9.8,
        g_sim=10.0, exp_util=True, mpf_log_space=False,
        mpf_fixed_bw=None, mpf_bw_scale=1.0, unroll=True,
        mpf_drive_layout="colbcast", probe_skip=(), n_chains=1):
    """The `Prepared` inputs of one argument set of `_sweep_groups`: on
    CUDA tensors the kernel's form (`kernel_statics`), else the plain
    version's."""
    check_sweep_dims(n_sc, hz, m, n_params, n_act, m_mpf, mpf_drive_layout,
                     probe_skip)
    dev = torch.as_tensor(theta0).device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    G, C = seeds_shape[0], n_chains
    B = G * C * n_sc
    st = episode_statics(steps, warm_up, hz, m, n_params, n_act, m_mpf,
                         mpf_steps, dt, g_model, g_sim, exp_util,
                         mpf_log_space, mpf_fixed_bw, mpf_bw_scale)
    lens = f32(true_lengths).expand(G, n_sc)
    mass = f32(true_masses).expand(G, n_sc)
    ep_f = torch.stack([1.0 / lens, 1.0 / mass], dim=-1)     # [G, n_sc, 2]
    mpfx0 = f32(mpfx0)
    mpfx0 = mpfx0.reshape(-1, m_mpf, 2).expand(n_sc, m_mpf, 2)
    per_ep = lambda v: f32(v).reshape(1, m, hz).expand(B, m, hz)
    inputs = dict(
        scal=episode_scal(state0, ctrl_sigma, lr, alpha, temp, prior_sigma,
                          mpf_lr, mpf_sigma, prior_bw0, m, dev),
        ep_f=ep_f[:, None].expand(G, C, n_sc, 2).reshape(B, 2),
        theta0=per_ep(theta0), locs0=per_ep(locs0), amat0=per_ep(a_mat0),
        a_seq=None,
        mpfx0=mpfx0[None].expand(G * C, n_sc, m_mpf, 2).reshape(
            B, m_mpf, 2),
    )
    packed = runner is _launch_k5 and dev.type == "cuda"
    if packed:
        inputs = kernel_statics(inputs, st)
    inputs.update(eps=None, pdz=None, pdu=None)
    k = seeds_shape[1] if len(seeds_shape) == 3 else 1
    return Prepared(
        inputs=inputs, statics=st,
        rows=SeedRows(G, k, C, n_sc, dev, packed),
        noise=lambda eps, pdz, pdu: _host_noise(
            eps, pdz, pdu, G, C, n_sc, steps, hz, m, n_params, n_act, dev),
        dims=dict(lead=(G, C) if n_chains > 1 else (G,), n_sc=n_sc,
                  steps=steps, m=m, hz=hz, m_mpf=m_mpf, fields=LOG_FIELDS))


def run_sweep(runner, prepare, cache, counted, seeds, state0, theta0, args,
              kwargs, noise=None):
    """A sweep wrapper's call (the pendulum's `_sweep_groups`, the
    cart-pole's): `runner` runs the canonical inputs (the kernel or the
    plain version), `prepare(runner, seeds_shape, state0, theta0, *args,
    **kwargs)` makes the `Prepared` inputs of an argument set, kept in
    `cache`; `noise` is the host noise (eps, pdz, pdu) or None. The
    `sweep.inputs`, `sweep.launch` and `sweep.outputs` spans.

    A call reuses the inputs that an earlier call built from the same
    arguments (`ops/sweep_inputs.py`): every tensor the same object, or a
    view of the same base made alike (`v[None]`, `v[rows]`), at the same
    `_version`; every other argument but the seeds and the host noise
    equal in value; the same runner, device, current stream, seeds'
    shape (G and the given chains) and noise mode. It then builds only its
    seed rows (`SeedRows`, no host-to-device copy) and, in host-noise
    mode, its noise. A new tensor object, an in-place write to one,
    another value (an `exp` number, n_chains, n_sc, ...) or another G
    builds afresh, as does an argument that makes no key (a NumPy array,
    a list). A write that torch does not count (NumPy into a
    `torch.from_numpy` tensor's memory, DLPack, `data_ptr`, `.data`) is
    not seen: pass such a tensor as a new object. Counted in
    `counted.input_hits` / `.input_builds`."""
    with span("sweep.inputs"):
        dev = torch.as_tensor(theta0).device
        seeds = torch.as_tensor(seeds, dtype=torch.int64, device=dev)
        prep, hit = cache.get(
            head(runner, dev, seeds, noise is not None),
            (state0, theta0, *args), kwargs,
            lambda: prepare(runner, seeds.shape, state0, theta0, *args,
                            **kwargs))
        counted.input_hits += hit
        counted.input_builds += not hit
        inputs = dict(prep.inputs, **prep.rows(seeds))
        if noise is not None:
            inputs["eps"], inputs["pdz"], inputs["pdu"] = prep.noise(*noise)
    with span("sweep.launch"):
        log, theta, locs, amat, mpf_x = runner(inputs, prep.statics)
    with span("sweep.outputs"):
        d = prep.dims
        lead, n_sc, m, hz = d["lead"], d["n_sc"], d["m"], d["hz"]
        out = {k: v.reshape(*lead, n_sc, d["steps"]).transpose(-1, -2)
               for k, v in split_log(log, d["fields"]).items()}
        out.update(
            theta=theta.reshape(*lead, n_sc, m, hz),
            locs=locs.reshape(*lead, n_sc, m, hz),
            a_mat=amat.reshape(*lead, n_sc, m, hz),
            mpf_x=mpf_x.reshape(*lead, n_sc, d["m_mpf"], 2),
        )
    return out


def _sweep_groups(runner, seeds, state0, theta0, *args, host_eps=None,
                  host_pdz=None, host_pdu=None, **kwargs):
    """`fused_pendulum_sweep_groups`, with the runner of the canonical
    inputs (the kernel or the plain version) first (`run_sweep`; counted
    in `fused_pendulum_sweep_episode.input_hits` / `.input_builds`)."""
    noise = None if host_eps is None else (host_eps, host_pdz, host_pdu)
    return run_sweep(runner, _prepare, _INPUTS, fused_pendulum_sweep_episode,
                     seeds, state0, theta0, args, kwargs, noise)


def _launch_k5(inputs, st):
    return run_episodes(fused_pendulum_sweep_episode, inputs, st)


def fused_pendulum_sweep_groups(*args, **kwargs):
    """fused_pendulum_sweep_groups(seeds, *same arguments as
    fused_pendulum_sweep_episode after the seed*)

    G sweep groups in one launch. seeds [G, 2] or [G, k, 2];
    true_lengths/true_masses [G, n_sc] (or [n_sc], shared); host noise,
    when given, with a leading G axis (then the chain axis when
    n_chains > 1) before the layout of `fused_pendulum_sweep_episode`.
    Returns that function's dict with a leading G axis.
    Counted in `fused_pendulum_sweep_episode.launches`.

    A repeat call with the same argument objects (an adapter's, with the
    same true-parameter tensors, or views made alike of them) and new seeds
    reuses the kernel's inputs built by the first and builds only the seed
    rows; a new or in-place written tensor, another value or another G,
    n_chains or n_sc builds afresh (`_sweep_groups`). A tensor written
    outside torch (NumPy into a `torch.from_numpy` tensor's memory,
    DLPack, `data_ptr`, `.data`) leaves its version as it was: pass it as
    a new object after such a write."""
    return _sweep_groups(_launch_k5, *args, **kwargs)


def plain_pendulum_sweep_groups(*args, **kwargs):
    """`fused_pendulum_sweep_groups`'s plain version on the inputs' device,
    with the same arguments (the kernel's reference on the card)."""
    return _sweep_groups(episode_plain, *args, **kwargs)


def fused_pendulum_sweep_episode(
        seed, state0, theta0, locs0, a_mat0, mpfx0, prior_bw0,
        true_lengths, true_masses, ctrl_sigma, lr, alpha, temp,
        prior_sigma, mpf_lr, mpf_sigma, *, n_sc, steps, warm_up=0, hz,
        m, n_params, n_act, m_mpf, mpf_steps, dt=0.05, g_model=9.8,
        g_sim=10.0, exp_util=True, mpf_log_space=False,
        mpf_fixed_bw=None, mpf_bw_scale=1.0, unroll=True,
        host_eps=None, host_pdz=None, host_pdu=None,
        mpf_drive_layout="colbcast", probe_skip=(), n_chains=1):
    """Run n_sc x n_chains pendulum DuSt episodes in one launch.

    seed [2] (chain 0; chains past the given rows derive by +4099*c) or
    [k, 2]; state0 [2] shared initial state; theta0/locs0/a_mat0 [m, hz]
    shared across scenarios; mpfx0 [m_mpf, 2] shared or [n_sc, m_mpf, 2]
    per scenario; true_lengths/true_masses [n_sc]. The controller a_seq
    is zero. `unroll` and `mpf_drive_layout` select TPU loop forms and
    change no value (the layout is validated); `probe_skip` must be ().

    Host-noise mode: host_eps [steps, hz, smp, 128] (rows s*m + q,
    smp = n_sc*m rounded up to 8), host_pdz/host_pdu [steps, n_sc, 8, 128],
    each with a leading chain axis when n_chains > 1.

    Returns per-scenario logs cost/th/om/action/bw_sv/bw_mpf
    [steps, n_sc], final theta/locs/a_mat [n_sc, m, hz] and MPF particles
    [n_sc, m_mpf, 2], with a leading chain axis when n_chains > 1. CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (counted in `fused_pendulum_sweep_episode.launches`)."""
    noise = {k: (None if v is None else torch.as_tensor(v)[None])
             for k, v in (("host_eps", host_eps), ("host_pdz", host_pdz),
                          ("host_pdu", host_pdu))}
    out = fused_pendulum_sweep_groups(
        torch.as_tensor(seed)[None], state0, theta0, locs0, a_mat0, mpfx0,
        prior_bw0, torch.as_tensor(true_lengths)[None],
        torch.as_tensor(true_masses)[None], ctrl_sigma, lr, alpha, temp,
        prior_sigma, mpf_lr, mpf_sigma, n_sc=n_sc, steps=steps,
        warm_up=warm_up, hz=hz, m=m, n_params=n_params, n_act=n_act,
        m_mpf=m_mpf, mpf_steps=mpf_steps, dt=dt, g_model=g_model,
        g_sim=g_sim, exp_util=exp_util, mpf_log_space=mpf_log_space,
        mpf_fixed_bw=mpf_fixed_bw, mpf_bw_scale=mpf_bw_scale, unroll=unroll,
        mpf_drive_layout=mpf_drive_layout, probe_skip=probe_skip,
        n_chains=n_chains, **noise)
    return {k: v[0] for k, v in out.items()}


fused_pendulum_sweep_episode.launches = 0
fused_pendulum_sweep_episode.mpf_reg_launches = 0
fused_pendulum_sweep_episode.mpf_smem_launches = 0
fused_pendulum_sweep_episode.input_hits = 0
fused_pendulum_sweep_episode.input_builds = 0
# the prepared inputs of `_sweep_groups` (both runners)
_INPUTS = InputCache()
