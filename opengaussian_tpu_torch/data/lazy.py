"""Lazy per-view array loading (SURVEY §7.2 M6: host-sharded data loading).

The reference's --save_memory keeps every view's tensors in host RAM and
shuttles one to the GPU per step (reference scene/cameras.py:94-107); this
repo's save_memory mode mirrors that, which still makes host RSS scale with
the FULL view count (ScanNet/LeRF at 4K-frame scale: tens of GB of decoded
float images). `lazy=True` scene loading goes one step further: a view's
pixels/sidecars are DECODED ON ACCESS from the source files, so steady-state
RSS holds one view, not V.

Two duck-typed ndarray stand-ins:

  * LazyArray — one view's field; `np.asarray(x)` (the __array__ protocol)
    decodes it. Carries shape/dtype/ndim so shape-probing code works
    without IO.
  * LazyStack — a [V, ...] stack of per-view fields; `stack[i:i+1]` decodes
    only those views (the save_memory hot loop's one-view window),
    `np.asarray(stack)` decodes everything (stage boundaries that need the
    full stack — pseudo sweeps, the SAM refiner — still work, at a
    transient RSS spike documented in the README).

Loaders must be pure (same bytes every call); nothing is cached here — the
OS page cache is the cache.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class LazyArray:
    """Duck-typed ndarray whose data loads on __array__."""

    def __init__(self, loader: Callable[[], np.ndarray], shape, dtype):
        self._loader = loader
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    @property
    def ndim(self):
        return len(self.shape)

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._loader(), self.dtype)
        assert a.shape == self.shape, (a.shape, self.shape)
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, idx):
        return np.asarray(self)[idx]

    def __repr__(self):
        return f"LazyArray(shape={self.shape}, dtype={self.dtype})"


class LazyStack:
    """[V, ...] stack of per-view loaders; slicing loads only those views."""

    def __init__(self, loaders: list[Callable[[], np.ndarray]], item_shape,
                 dtype):
        self._loaders = list(loaders)
        self.shape = (len(self._loaders), *item_shape)
        self.dtype = np.dtype(dtype)

    @property
    def ndim(self):
        return len(self.shape)

    def _load(self, i: int) -> np.ndarray:
        a = np.asarray(self._loaders[i](), self.dtype)
        assert a.shape == self.shape[1:], (a.shape, self.shape)
        return a

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self._load(int(idx))
        if isinstance(idx, slice):
            rng = range(*idx.indices(len(self)))
            return np.stack([self._load(i) for i in rng])
        raise TypeError(f"LazyStack index: {idx!r}")

    def __array__(self, dtype=None, copy=None):
        a = self[:]
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return f"LazyStack(shape={self.shape}, dtype={self.dtype})"


def is_lazy(x) -> bool:
    return isinstance(x, (LazyArray, LazyStack))
