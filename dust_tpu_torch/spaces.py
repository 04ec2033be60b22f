"""Box observation/action spaces (counterpart of `dust_tpu/spaces.py`).

Bounds are numpy arrays (static metadata); `clip` converts them to tensors
on the input's device."""

from __future__ import annotations

import numpy as np
import torch


class Box:
    """A bounded n-dimensional box: scalar or vector bounds, defaulting to
    +/- inf. `dim` is the number of coordinates (not the tensor rank)."""

    def __init__(self, dim, low=None, high=None, dtype=np.float32):
        if dim <= 0:
            raise ValueError("Dimension must be a strictly positive integer.")
        self._dim = int(dim)
        self.dtype = np.dtype(dtype)

        def _as_bound(value, default):
            if value is None:
                return np.full((self._dim,), default, dtype=self.dtype)
            arr = np.asarray(value, dtype=self.dtype)
            if arr.ndim == 0:
                return np.full((self._dim,), arr, dtype=self.dtype)
            if arr.shape != (self._dim,):
                raise ValueError(
                    f"Bound shape {arr.shape} must match space dim ({self._dim},)."
                )
            return arr

        self.low = _as_bound(low, -np.inf)
        self.high = _as_bound(high, np.inf)

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def shape(self) -> tuple[int, ...]:
        return (self._dim,)

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        """Clip `x` (broadcast over leading axes) to the box bounds."""
        low = torch.as_tensor(self.low, dtype=x.dtype, device=x.device)
        high = torch.as_tensor(self.high, dtype=x.dtype, device=x.device)
        return torch.clamp(x, low, high)

    def __repr__(self):
        return f"Box(dim={self._dim}, low={self.low}, high={self.high})"
