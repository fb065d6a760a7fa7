"""NetCDF variable reader (PyTorch port of ``picles_tpu/utils/io.py``).

NetCDF-4 (HDF5) files through ``h5py``; NetCDF-3 files, and every file where
``h5py`` is not installed, through scipy's NetCDF-3 reader.  ``h5py`` is
imported inside the function, so the package imports without it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def read_netcdf_vars(path: str, names: Sequence[str]) -> Dict[str, np.ndarray]:
    """Read the named variables of a NetCDF-4 or NetCDF-3 file as numpy
    arrays: h5py first where it is installed, scipy's NetCDF-3 reader when
    it is not or when the file is not HDF5."""
    try:
        import h5py
    except ImportError:
        h5py = None
    if h5py is not None:
        try:
            with h5py.File(path, "r") as f:
                return {n: np.asarray(f[n]) for n in names}
        except (OSError, KeyError):
            pass
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return {n: np.asarray(f.variables[n].data) for n in names}
