"""pulseportraiture_tpu: accelerator-native wideband pulsar timing.

A from-scratch JAX/XLA rebuild of the capabilities of
PulsePortraiture (Pennucci, Demorest, & Ransom 2014; Pennucci 2019):
wideband TOA/DM measurement via an extended-FFTFIT likelihood, Gaussian and
PCA/B-spline portrait modeling, alignment/averaging, channel zapping, and
simulation — redesigned for batched, sharded execution on GPUs and
GPU meshes.

Layers (see SURVEY.md):
  ops/       L1 Fourier-domain portrait algebra (rotation, scattering, noise)
  fitters/   L2 jit/vmap fitters (FFTFIT, 2-param and 5-param portrait fits)
  models/    L3 model builders (Gaussian components, PCA + splines)
  io/        L0/L5 archive + model + TOA file formats
  sim/       synthetic data generation
  pipelines/ L4 measurement pipelines (TOAs, alignment, zapping)
  parallel/  device-mesh sharding helpers
"""

__version__ = "0.1.0"

# Lazy top-level API (PEP 562): keeps `import pulseportraiture_tpu`
# cheap — jax and the submodules load on first attribute access.
_API = {
    "DataPortrait": ("pulseportraiture_tpu.portrait", "DataPortrait"),
    "GetTOAs": ("pulseportraiture_tpu.pipelines.toas", "GetTOAs"),
    "align_archives": ("pulseportraiture_tpu.pipelines.align",
                       "align_archives"),
    "write_TOAs": ("pulseportraiture_tpu.io.tim", "write_TOAs"),
    "TOA": ("pulseportraiture_tpu.io.tim", "TOA"),
    "load_data": ("pulseportraiture_tpu.io.archive", "load_data"),
    "make_fake_pulsar": ("pulseportraiture_tpu.sim.fake",
                         "make_fake_pulsar"),
    "fit_portrait_full": ("pulseportraiture_tpu.fitters.portrait",
                          "fit_portrait_full"),
    "fit_portrait_full_batch": ("pulseportraiture_tpu.fitters.portrait",
                                "fit_portrait_full_batch"),
    "fit_phase_shift": ("pulseportraiture_tpu.fitters.phase_shift",
                        "fit_phase_shift"),
    "DataBunch": ("pulseportraiture_tpu.utils", "DataBunch"),
}


def __getattr__(name):
    if name in _API:
        import importlib
        module, attr = _API[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_API))
