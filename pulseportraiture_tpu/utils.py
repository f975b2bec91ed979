"""Small shared utilities.

DataBunch is kept for API familiarity with the reference (pplib.py:125-136),
but results flowing through jit/vmap code paths use typed NamedTuples/pytrees
instead (see fitters.results).
"""

from __future__ import annotations

import numpy as np


class DataBunch(dict):
    """dict with attribute access; universal result/record type.

    Expensive fields may be registered lazily (add_lazy): the thunk runs
    on first attribute access and the result is cached in place.  The
    TOA pipeline loads thousands of archives but never touches the
    diagnostic fields (masks, scrunched profile stats) — laziness keeps
    load_data's cost proportional to what a caller actually uses.

    Reference: pplib.py:125-136.
    """

    def __init__(self, **kwds):
        super().__init__(**kwds)
        self.__dict__ = self

    def add_lazy(self, name, thunk):
        self.setdefault("_lazy", {})[name] = thunk

    def __getattr__(self, name):
        thunks = dict.get(self, "_lazy")
        if thunks is not None and name in thunks:
            val = thunks.pop(name)()
            self[name] = val
            return val
        raise AttributeError(name)

    def __contains__(self, name):
        if dict.__contains__(self, name):
            return True
        thunks = dict.get(self, "_lazy")
        return bool(thunks) and name in thunks


def get_bin_centers(nbin: int, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """Return nbin bin centers with extremities at lo and hi.

    Reference: pplib.py:671-684.
    """
    lo = np.float64(lo)
    hi = np.float64(hi)
    diff = hi - lo
    return np.linspace(lo + diff / (nbin * 2), hi - diff / (nbin * 2), nbin)


def count_crossings(x: np.ndarray, x0: float) -> int:
    """Number of crossings of 1-D array x across threshold x0.

    Reference: pplib.py:686-694.
    """
    x = np.asarray(x)
    return int((np.diff(np.sign(x - x0)) != 0).sum() - ((x - x0) == 0).sum())


def weighted_mean(data, errs=1.0):
    """Weighted mean and its standard error; weights are errs**-2.

    Reference: pplib.py:696-709.
    """
    data = np.asarray(data, dtype=np.float64)
    if np.isscalar(errs) or getattr(errs, "ndim", 0) == 0:
        errs = np.ones(len(data))
    errs = np.asarray(errs, dtype=np.float64)
    ok = errs > 0.0
    w = errs[ok] ** -2.0
    mean = (data[ok] * w).sum() / w.sum()
    return mean, w.sum() ** -0.5


def get_WRMS(data, errs=1.0):
    """Weighted root-mean-square value.  Reference: pplib.py:711-725."""
    data = np.asarray(data, dtype=np.float64)
    if np.isscalar(errs) or getattr(errs, "ndim", 0) == 0:
        errs = np.ones(len(data))
    errs = np.asarray(errs, dtype=np.float64)
    ok = errs > 0.0
    w_mean = weighted_mean(data, errs)[0]
    w = errs[ok] ** -2.0
    return (((data[ok] - w_mean) ** 2.0 * w).sum() / w.sum()) ** 0.5


def use_compile_cache():
    """Turn on JAX's persistent compilation cache; returns its directory.

    A JAX_COMPILATION_CACHE_DIR set in the environment is left alone
    (JAX reads it itself).  Otherwise the cache goes to .jax_cache at
    the root of this checkout: a fixed path, so later runs hit it.
    """
    import os

    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_accelerator():
    """The first JAX device, or SystemExit when JAX found only the CPU:
    measurement scripts never fall back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise SystemExit("no accelerator: JAX found only the CPU")
    return dev


def card_report():
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`:
    each card's name and power limit, one line per card."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
