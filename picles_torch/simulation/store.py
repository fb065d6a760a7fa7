"""Output stores (PyTorch port of ``picles_tpu/simulation/store.py``).

``StateStore`` writes the JAX package's HDF5 layout: group ``waves`` with
dataset ``data`` of shape ``[time, x, y, state]`` (``[time, layer, x, y,
state]`` for a layered model, the frames pushed then ``[L, x, y, state]``;
``[time, x, state]`` for the 1D model) (float64), coordinate
datasets, a ``dims`` attribute and ``var_names = ["e", "m_x", "m_y"]``.
``add_forcing`` adds the group ``forcing`` (float64 fields, their ``dims``
and coordinates).  ``CashStore`` keeps host copies of the states in memory;
``EmptyStore`` is the no-op default.  Writes happen on the host from copies of the device
tensors.  ``h5py`` is imported only when a ``StateStore`` is made, so the
package imports where it is not installed.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` (never a view of a CPU tensor's memory)."""
    return t.detach().to("cpu", copy=True).numpy()


class EmptyStore:
    iteration: int = 0

    def push(self, state) -> None:
        pass

    def reset(self) -> None:
        pass

    def close(self) -> None:
        pass


class CashStore:
    """In-memory list of state snapshots."""

    def __init__(self):
        self.store: List[np.ndarray] = []
        self.iteration = 0

    def push(self, state) -> None:
        self.store.append(host_copy(state))
        self.iteration += 1

    def reset(self) -> None:
        self.store.clear()
        self.iteration = 0

    def close(self) -> None:
        pass

    def as_array(self) -> np.ndarray:
        return np.stack(self.store, axis=0)


class StateStore:
    """HDF5-backed state history."""

    def __init__(self, path: str, coords: dict, name: str = "state",
                 replace: bool = True, var_names=("e", "m_x", "m_y")):
        try:
            import h5py
        except ImportError:
            raise RuntimeError("h5py is unavailable; use CashStore") from None
        os.makedirs(path, exist_ok=True)
        fpath = os.path.join(path, name + ".h5")
        if replace and os.path.exists(fpath):
            os.remove(fpath)
        self.path = fpath
        if not replace and os.path.exists(fpath):
            # re-attach an existing history (checkpoint-resume legs): the run
            # loop aligns the write cursor to the resumed state's iteration
            self.file = h5py.File(fpath, "a")
            grp = self.file["waves"]
            self.data = grp["data"]
            self.group = grp
            self.iteration = 0
            self.shape = self.data.shape
            return
        self.file = h5py.File(fpath, "w")
        shape = tuple(len(v) for v in coords.values())
        grp = self.file.create_group("waves")
        self.data = grp.create_dataset("data", shape, dtype="f8")
        grp.attrs["dims"] = [str(k) for k in coords.keys()]
        for k, v in coords.items():
            if k == "state":
                grp[k] = np.array([s.encode() for s in v])
            else:
                grp[k] = np.asarray(v, dtype="f8")
        grp["var_names"] = np.array([s.encode() for s in var_names])
        self.group = grp
        self.iteration = 0
        self.shape = shape

    def push(self, state) -> None:
        self.data[self.iteration, ...] = host_copy(state)
        self.iteration += 1

    def push_block(self, states) -> None:
        """Write a stacked ``[n, ...]`` block in one IO call."""
        arr = host_copy(states)
        n = arr.shape[0]
        self.data[self.iteration:self.iteration + n, ...] = arr
        self.iteration += n

    def add_forcing(self, forcing: dict, coords: dict) -> None:
        """Write the forcing fields (numpy arrays or tensors; None is
        skipped) into group ``forcing`` as float64 datasets, with its
        ``dims`` attribute and coordinate datasets written once, as the
        JAX package's ``StateStore.add_forcing`` writes them."""
        grp = (self.file["forcing"] if "forcing" in self.file
               else self.file.create_group("forcing"))
        for name, f in forcing.items():
            if f is None or name in grp:
                continue
            if isinstance(f, torch.Tensor):
                f = host_copy(f)
            grp[name] = np.asarray(f, dtype="f8")
        if "dims" not in grp.attrs:
            grp.attrs["dims"] = [str(k) for k in coords.keys()]
            for k, v in coords.items():
                if k not in grp:
                    grp[k] = np.asarray(v, dtype="f8")

    def reset(self, value: float = 0.0) -> None:
        self.data[...] = value
        self.iteration = 0

    def close(self) -> None:
        self.file.close()


def convert_store_to_tuple(store, sim=None):
    """The store's contents as a dict of numpy arrays (``data`` plus, for a
    ``StateStore``, the coordinates)."""
    if isinstance(store, CashStore):
        return dict(data=store.as_array())
    if isinstance(store, StateStore):
        out = dict(data=np.asarray(store.data))
        for k in store.group:
            if k != "data":
                out[k] = np.asarray(store.group[k])
        return out
    raise TypeError(type(store))
