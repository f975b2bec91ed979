"""Profiling/tracing hooks (SURVEY.md section 5).

The reference only stamps wall-clock durations per fit (pplib.py:2084,
pptoaslib.py:1011); every fitter here records the same `duration` and
`nfeval` bookkeeping, and this module adds the device layer: JAX
profiler traces viewable in TensorBoard/Perfetto, plus a lightweight
section timer.

Usage:
    from pulseportraiture_tpu.profiling import trace, timed

    with trace("/tmp/pp_trace"):          # or PP_TRACE_DIR=/tmp/pp_trace
        gt.get_TOAs(...)

    with timed("model build"):
        dp.make_spline_model()
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir=None, create_perfetto_link=False):
    """jax.profiler.trace wrapper; no-op when no directory is given.

    Directory precedence: argument, then the PP_TRACE_DIR environment
    variable.
    """
    log_dir = log_dir or os.environ.get("PP_TRACE_DIR")
    if not log_dir:
        yield None
        return
    import jax
    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label, quiet=False, results=None):
    """Wall-clock section timer; appends (label, seconds) to `results`."""
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        if results is not None:
            results.append((label, dt))
        if not quiet:
            print(f"[pp] {label}: {dt:.3f} s")


def annotate(name):
    """jax.profiler.TraceAnnotation for labeling device regions."""
    import jax
    return jax.profiler.TraceAnnotation(name)
