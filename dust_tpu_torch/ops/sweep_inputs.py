"""What a sweep wrapper builds before its launch, kept for the next call
with the same arguments (`ops/sweep_episode.py`,
`ops/particle_sweep_episode.py`).

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

# a handful: a wrapper's kernel and plain runs, or a few stacks, alternate
# without rebuilding (at the demo shapes an entry holds under 2 MB)
ENTRIES = 4
_SCALARS = (type(None), bool, int, float, str)


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
