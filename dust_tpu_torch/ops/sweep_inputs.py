"""The sweep call of the whole-episode kernels (`run_sweep`: K5's
`ops/sweep_episode.py`, K10's `ops/particle_sweep_episode.py`, K14's
`ops/cartpole_sweep_episode.py`), their limits (`check_sweep_dims`), and
what a sweep wrapper builds before its launch, kept for the next call with
the same arguments.

A sweep's arguments are the same objects on every call but the seeds: an
adapter (`simulation.megakernel_*_sweep_fn`) passes its stack's tensors and
its configuration's numbers, a caller its true-parameter tensors. So each
wrapper keeps the inputs it built (its `Prepared`) beside the arguments it
built them from, and a call reuses them where each of its arguments but
the seeds and the host-noise arrays matches the kept one:

* a tensor: the same object, or a view of the same base object with the
  same offset, sizes, strides and dtype (an adapter's `v[None]`, a mesh
  rank's `v[rows]`, made anew each call), at the same version
  (`_version`). The entry holds a reference to it, so its memory cannot
  be reused while the entry lives;
* None, a bool, an int, a float or a str, and tuples of them: the same
  object, or one of the same type and value (a float with its sign, so
  -0.0 and 0.0 differ);
* anything else (a NumPy array, a list, a tensor that tracks no version)
  makes the call build afresh and keep nothing.

The version counts the writes torch makes: an in-place operation on the
tensor or on any view of its base. A write torch does not see leaves it
as it was: NumPy writing into the memory of a `torch.from_numpy` tensor,
a write through DLPack, a `data_ptr` or a tensor's `.data`, a CUDA graph's
replay. A caller that writes a tensor so between calls passes a new
tensor object (`t.clone()`, or a fresh `torch.from_numpy`), which builds
afresh.

The wrapper adds a head: the runner, the device, the current stream, the
seeds' shape (G and the given chains) and whether host noise is given. A
kept entry's tensors are used only by launches on the stream it was built
for, so the caching allocator cannot hand their memory to another stream
while a launch may still read it. `ENTRIES` entries are kept, the least
recently used dropped first. Identity is checked first, so a call whose
arguments are the same objects costs a few microseconds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..utils.profiling import span
from .episode_kernel import kernel_statics, split_log

# a handful: a wrapper's kernel and plain runs, or a few stacks, alternate
# without rebuilding (at the demo shapes an entry holds under 2 MB)
ENTRIES = 4
_SCALARS = (type(None), bool, int, float, str)
_LAYOUTS = ("colbcast", "lanepack", "symm")
# the TPU kernels' chain-seed stride (`pallas_sweep_episode.py:1376-1392`)
_CHAIN_SEED_STRIDE = 4099


def _keyable(v, tensors):
    """Whether `v` can be matched later; its tensors go to `tensors`."""
    if isinstance(v, torch.Tensor):
        try:
            tensors.append((v, v._version))
        except RuntimeError:           # an inference tensor has none
            return False
        return True
    if type(v) is tuple:
        return all(_keyable(x, tensors) for x in v)
    return type(v) in _SCALARS


def _same(a, b):
    """Whether two arguments that are not the same object are equal as a
    key: scalars of one type and value (a float with its sign), tuples of
    such, tensors that are views of one base with one geometry; any other
    object is equal only to itself."""
    t = type(a)
    if t is not type(b):
        return False
    if isinstance(a, torch.Tensor):
        # two views made alike of one base; the version is checked apart
        # (views share their base's)
        return (a._base is not None and a._base is b._base
                and a.storage_offset() == b.storage_offset()
                and a.shape == b.shape and a.stride() == b.stride()
                and a.dtype == b.dtype)
    if t is float:
        return a == b and math.copysign(1.0, a) == math.copysign(1.0, b)
    if t is tuple:
        return len(a) == len(b) and all(
            x is y or _same(x, y) for x, y in zip(a, b))
    return t in _SCALARS and a == b


def head(runner, dev, seeds, host_noise):
    """The key of a call beside its arguments: the runner, the device, the
    current stream on a CUDA device (its handle), the seeds' shape and
    whether host noise is given."""
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else None)
    return runner, dev, stream, tuple(seeds.shape), host_noise


@dataclass
class Prepared:
    """One argument set's inputs: `inputs`, the static inputs in the
    runner's form; `statics`, the runner's statics; `rows(seeds)`, the
    call's per-episode seed inputs; `noise(eps, pdz, pdu)`, the call's
    host noise in the runner's layout; `dims`, the sizes the outputs are
    shaped by."""

    inputs: dict
    statics: dict
    rows: Callable
    noise: Callable
    dims: dict


@dataclass
class _Entry:
    head: tuple
    args: tuple
    kwargs: dict
    tensors: list          # (tensor, its version when the entry was built)
    prepared: Prepared

    def matches(self, head, args, kwargs):
        if head != self.head or len(args) != len(self.args) \
                or kwargs.keys() != self.kwargs.keys():
            return False
        # plain loops: this runs on every call, before the launch
        for a, b in zip(args, self.args):
            if a is not b and not _same(a, b):
                return False
        kept = self.kwargs
        for k, v in kwargs.items():
            if v is not kept[k] and not _same(v, kept[k]):
                return False
        for t, n in self.tensors:
            if t._version != n:
                return False
        return True


class InputCache:
    """A wrapper's `Prepared` inputs by their arguments, the most recently
    used first. An argument matches a kept one that is the same object
    or equal as `_same` says, a tensor also at the same version; an
    adapter passes the same tensors, tuples and numbers on every call, so
    most arguments match by identity."""

    def __init__(self):
        self.entries = []

    def get(self, head, args, kwargs, build):
        """(the `Prepared` of head + args + kwargs, whether it was kept):
        a miss calls `build()` and keeps its result where every argument
        can be matched later."""
        for i, entry in enumerate(self.entries):
            if entry.matches(head, args, kwargs):
                if i:
                    self.entries.insert(0, self.entries.pop(i))
                return entry.prepared, True
        tensors = []
        keyable = (_keyable(args, tensors)
                   and _keyable(tuple(kwargs.values()), tensors))
        prepared = build()
        if keyable:
            self.entries.insert(0, _Entry(head, tuple(args), dict(kwargs),
                                          tensors, prepared))
            del self.entries[ENTRIES:]
        return prepared, False

    def clear(self):
        self.entries.clear()


# -- the sweep call -----------------------------------------------------------


def _round8(n):
    return -(-n // 8) * 8


def check_sweep_dims(name, n_sc, hz, m, n_params, n_act, m_mpf, *, width=1,
                     plan_limit=128, mpf_drive_layout=None, probe_skip=None):
    """A sweep kernel's limits, the TPU adapters' as coded
    (`pallas_sweep_episode.py:1345-1371`,
    `pallas_particle_sweep_episode.py:1176-1200`), which the kernels'
    shared memory and one lane row of MPF particles also set: `name`
    begins each message; a plan holds `width` values per horizon step, at
    most 128 a step and `plan_limit` in all; the TPU-only arguments given
    (not None) are validated: `mpf_drive_layout` one of the TPU layouts,
    `probe_skip` ()."""
    h = "hz" if width == 1 else f"hz*{width}"
    if n_sc > 16:
        raise ValueError(f"{name}: n_sc <= 16 per program "
                         "(batch larger sweeps on the group axis)")
    if mpf_drive_layout is not None and mpf_drive_layout not in _LAYOUTS:
        raise ValueError(f"{name}: mpf_drive_layout must "
                         "be 'colbcast', 'lanepack' or 'symm'")
    if probe_skip is not None and tuple(probe_skip) != ():
        raise ValueError(f"{name}: probe_skip is a TPU "
                         "attribution probe; only () is supported")
    if hz * width > 128 or n_act > 128:
        raise ValueError(f"{name}: {h}<=128, n_act<=128")
    if n_params > 8:
        raise ValueError(f"{name}: n_params <= 8")
    if m * hz * width > plan_limit:
        raise ValueError(f"{name}: m*{h} <= {plan_limit}")
    if _round8(max(m_mpf, 8)) > 64:
        raise ValueError(f"{name}: m_mpf <= 64")


class SeedRows:
    """A call's per-episode seed inputs, from per-chain offsets and a
    scenario column made once. Called with seeds [G, 2] or [G, k, 2]
    int64 (G and k as made): chain c < k takes its given seed; a chain
    c >= k takes chain 0's plus 4099 c on the second word (the TPU
    kernel's chain-seed stride); episode b = (g * C + c) * n_sc + s takes
    its chain's seed and scenario s. With `packed` (the kernel's form)
    {"ep_i": [B, 3] int32}, the rows of `episode_kernel.episode_ids` (a
    copy of a kept scenario column, then one int64 add into its seed
    columns, cast as `.to` casts); else {"seeds": [B, 2], "scenario":
    [B]}."""

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


def prepared(kernel, launch, runner, inputs, st, seeds_shape, n_chains,
             n_sc, noise=None):
    """The `Prepared` of one argument set from a task's canonical static
    inputs and statics: in the kernel's form (`kernel_statics`) where the
    runner is the task's kernel launcher `launch` and the inputs lie on a
    CUDA device; its seed rows (`SeedRows`); the output shapes from
    `kernel`'s log fields, plan and MPF widths. `noise(eps, pdz, pdu)` lays
    out the call's host noise."""
    dev = inputs["theta0"].device
    packed = runner is launch and dev.type == "cuda"
    if packed:
        inputs = kernel_statics(inputs, st, kernel)
    inputs.update(eps=None, pdz=None, pdu=None)
    G = seeds_shape[0]
    k = seeds_shape[1] if len(seeds_shape) == 3 else 1
    m, hz, w = st["m"], st["hz"], kernel.plan_width
    return Prepared(
        inputs=inputs, statics=st,
        rows=SeedRows(G, k, n_chains, n_sc, dev, packed), noise=noise,
        dims=dict(lead=(G, n_chains) if n_chains > 1 else (G,), n_sc=n_sc,
                  steps=st["steps"], fields=kernel.log_fields,
                  plan=(m, hz) if w == 1 else (m, hz, w),
                  mpf=(st["m_mpf"], kernel.mpf_width)))


def run_sweep(runner, prepare, cache, counted, seeds, state0, theta0, args,
              kwargs, noise=None):
    """A sweep wrapper's call (each task's `_sweep_groups`): `runner` runs
    the canonical inputs (the kernel or the plain version), `prepare(runner,
    seeds_shape, state0, theta0, *args, **kwargs)` makes the `Prepared`
    inputs of an argument set, kept in `cache`; `noise` is the host noise
    (eps, pdz, pdu) or None. The `sweep.inputs`, `sweep.launch` and
    `sweep.outputs` spans. Returns {log field: [*lead, steps, n_sc]},
    theta/locs/a_mat [*lead, n_sc, *plan], log_mix [*lead, n_sc, m] where
    the runner gives it, and mpf_x [*lead, n_sc, *mpf] (`Prepared.dims`).

    A call reuses the inputs that an earlier call built from the same
    arguments: every tensor the same object, or a view of the same base
    made alike (`v[None]`, `v[rows]`), at the same `_version`; every other
    argument but the seeds and the host noise equal in value (the model's
    statics too); the same runner, device, current stream, seeds' shape (G
    and the given chains) and noise mode. It then builds only its seed
    rows (`SeedRows`, no host-to-device copy) and, in host-noise mode, its
    noise. A new tensor object, an in-place write to one, another value
    (an `exp` number, n_chains, n_sc, ...) or another G builds afresh, as
    does an argument that makes no key (a NumPy array, a list). A write
    that torch does not count (NumPy into a `torch.from_numpy` tensor's
    memory, DLPack, `data_ptr`, `.data`) is not seen: pass such a tensor
    as a new object. Counted in `counted.input_hits` / `.input_builds`."""
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
        log, theta, locs, amat, mpf_x, *log_mix = runner(inputs,
                                                         prep.statics)
    with span("sweep.outputs"):
        d = prep.dims
        lead = (*d["lead"], d["n_sc"])
        out = {k: v.reshape(*lead, d["steps"]).transpose(-1, -2)
               for k, v in split_log(log, d["fields"]).items()}
        out.update(theta=theta.reshape(*lead, *d["plan"]),
                   locs=locs.reshape(*lead, *d["plan"]),
                   a_mat=amat.reshape(*lead, *d["plan"]))
        if log_mix and log_mix[0] is not None:
            out["log_mix"] = log_mix[0].reshape(*lead, d["plan"][0])
        out["mpf_x"] = mpf_x.reshape(*lead, *d["mpf"])
    return out
