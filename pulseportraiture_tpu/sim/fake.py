"""Fake-pulsar archive generation: the verification backend.

make_fake_pulsar mirrors the reference's PSRCHIVE-backed generator
(pplib.py:3183-3378): evaluate a .gmodel at the channel grid, optionally
scatter (analytic FT), add DM(nu) structure and scintillation, scale and
add Gaussian noise, then unload as an archive in the requested dispersion
state.  It writes our PSRFITS-subset format via io.archive.write_archive.
"""

from __future__ import annotations

import numpy as np

from pulseportraiture_tpu.config import SCATTERING_ALPHA
from pulseportraiture_tpu.io.mjd import MJD
from pulseportraiture_tpu.io.par import parse_par, period_at
from pulseportraiture_tpu.io.psrfits import Archive, write_psrfits
from pulseportraiture_tpu.utils import get_bin_centers


def add_scintillation(port, params=None, random=True, nsin=2, amax=1.0,
                      wmax=3.0, rng=None):
    """Sinusoid-based fake scintillation pattern across channels.

    Reference: pplib.py:1146-1174.
    """
    port = np.asarray(port)
    nchan = len(port)
    pattern = np.zeros(nchan)
    if params is None and random is False:
        return port
    if params is not None:
        nsin = len(params) // 3
        triplets = [params[i * 3:i * 3 + 3] for i in range(nsin)]
    else:
        rng = rng or np.random.default_rng()
        triplets = [(rng.uniform(0, amax), rng.chisquare(wmax),
                     rng.uniform(0, 1)) for _ in range(nsin)]
    for a, w, p in triplets:
        pattern += a * np.sin(np.linspace(0, w * np.pi, nchan) +
                              p * np.pi) ** 2
    return port * pattern[:, None]


def mean_C2N(nu, D, bw_scint):
    """Mean C_N^2 [m^-20/3] (Foster, Fairhead & Backer 1991).

    Reference: pplib.py:1176-1187.
    """
    return 2e-14 * nu ** (11 / 3.0) * D ** (-11 / 6.0) * \
        bw_scint ** (-5 / 6.0)


def dDM(D, D_screen, nu, bw_scint):
    """Predicted frequency-dependent delta-DM [cm^-3 pc].

    Reference: pplib.py:1189-1202.
    """
    SM = mean_C2N(nu, D, bw_scint) * D
    return 10 ** 4.45 * SM * D_screen ** (5 / 6.0) * nu ** (-11 / 6.0)


# Campaign generation (scripts/full_campaign.py) evaluates the *same*
# .gmodel at the same grid for every epoch; the eval is an eager-JAX
# portrait build that dominates per-archive cost at 4096x2048.  Memoize
# the last few (modelfile, grid, period) evals and their rFFTs so each
# epoch costs one ramp multiply + one irFFT.
_MODEL_EVAL_CACHE = {}


def _eval_model_portrait(modelfile, phases, freqs, P, ft=False):
    import os

    from pulseportraiture_tpu.models.gmodel_io import read_model
    key = (os.path.abspath(modelfile), os.path.getmtime(modelfile),
           len(phases), freqs.tobytes(), float(P))
    hit = _MODEL_EVAL_CACHE.get(key)
    if hit is None:
        _, _, model = read_model(modelfile, phases, freqs, P, quiet=True)
        model = np.asarray(model, dtype=np.float64)
        hit = [model, None]
        if len(_MODEL_EVAL_CACHE) >= 4:
            _MODEL_EVAL_CACHE.clear()
        _MODEL_EVAL_CACHE[key] = hit
    if ft and hit[1] is None:
        hit[1] = np.fft.rfft(hit[0], axis=-1)
    return hit[1] if ft else hit[0]


def _host_ramp(phis, nharm):
    """exp(2j*pi*phis[:, None]*k) in f64 with mod-1 argument reduction
    (glibc trig's large-argument path is far slower; the reduction
    error is <= k*eps ~ 1e-11 turns at k=1024)."""
    k = np.arange(nharm)
    theta = np.mod(phis[:, None] * k, 1.0)
    theta *= 2.0 * np.pi
    ramp = np.empty(theta.shape, np.complex128)
    np.cos(theta, out=ramp.real)
    np.sin(theta, out=ramp.imag)
    return ramp


def make_fake_pulsar(modelfile, ephemeris, outfile="fake_pulsar.fits",
                     nsub=1, npol=1, nchan=512, nbin=2048, nu0=1500.0,
                     bw=800.0, tsub=300.0, phase=0.0, dDM=0.0,
                     start_MJD=None, weights=None, noise_stds=1.0,
                     scales=1.0, dedispersed=False, t_scat=0.0,
                     alpha=SCATTERING_ALPHA, scint=False, xs=None, Cs=None,
                     nu_DM=np.inf, state="Stokes", telescope="GBT",
                     quiet=True, rng=None, dtype="i2"):
    """Generate a fake-pulsar archive.  Reference: pplib.py:3183-3378.

    The injected delay structure: the written archive claims header DM
    from the ephemeris, but the data are generated with an *extra* dDM
    (and optionally a DM(nu) power-law via xs/Cs), so downstream fits
    should recover DeltaDM ~= dDM.
    """
    import jax.numpy as jnp
    from pulseportraiture_tpu.config import DCONST
    from pulseportraiture_tpu.models.gmodel_io import read_model
    from pulseportraiture_tpu.ops.rotate import add_DM_nu
    from pulseportraiture_tpu.ops.scattering import (scattering_portrait_FT,
                                                     scattering_times)
    from pulseportraiture_tpu.ops.transform import phase_transform

    rng = rng or np.random.default_rng()
    chanwidth = bw / nchan
    lofreq = nu0 - bw / 2
    freqs = np.linspace(lofreq + chanwidth / 2.0,
                        lofreq + bw - chanwidth / 2.0, nchan)
    phases = get_bin_centers(nbin, lo=0.0, hi=1.0)
    noise_stds = np.broadcast_to(np.asarray(noise_stds, dtype=float),
                                 (nchan,))
    scales = np.broadcast_to(np.asarray(scales, dtype=float), (nchan,))
    par = parse_par(ephemeris)
    if start_MJD is None:
        start_MJD = MJD(float(par.PEPOCH))
    epochs = [start_MJD.add_seconds(tsub / 2.0 + isub * tsub)
              for isub in range(nsub)]
    Ps = np.array([period_at(par, ep.in_days()) for ep in epochs])
    if weights is None:
        weights = np.ones((nsub, nchan))
    (name, model_code, nu_ref_model, ngauss, params, fit_flags,
     scattering_index, fit_scat_index) = read_model(modelfile, quiet=True)

    # For dispersed output (dedispersed=False) on the achromatic path,
    # fold the header DM into the single model rotation and draw the
    # noise directly in the dispersed frame, instead of rotating
    # (signal + noise) back afterwards.  The stored signal is
    # mathematically identical (per-channel phase ramps compose and
    # commute with the per-channel scattering convolution and
    # scintillation scaling); the white noise realization differs by a
    # unitary per-channel rotation, i.e. is statistically identical.
    # This removes the full-archive f64 FFT pair in dededisperse() --
    # the dominant generation cost at campaign scale (4096x2048).
    # (One subtlety: sequential rotations project the Nyquist harmonic
    # to real at each intermediate irfft; the fold composes the ramps
    # exactly, which differs by O(|X_Nyquist|) -- negligible for any
    # band-limited profile, and the fold is the more accurate of the
    # two.  tests/test_end_to_end.py checks both statements.)
    fold_hdr_dm = (not dedispersed) and xs is None and par.DM != 0.0
    inv2 = np.where(np.isinf(freqs), 0.0, freqs) ** -2.0
    ref2 = 0.0 if np.isinf(nu0) else float(nu0) ** -2.0
    data = np.zeros((nsub, npol, nchan, nbin))
    for isub in range(nsub):
        P = Ps[isub]
        if xs is None:
            # achromatic rotation + extra dispersion (dedispersed frame
            # carries -phase, -dDM so fits recover +dDM; sign and
            # reference conventions == ops.rotate.rotate_data /
            # Archive.dededisperse): one combined Fourier-domain ramp
            # on the memoized model rFFT, one irFFT
            mft = _eval_model_portrait(modelfile, phases, freqs, P,
                                       ft=True)
            Dtot = DCONST * (dDM + (par.DM if fold_hdr_dm else 0.0)) / P
            phis = -phase - Dtot * (inv2 - ref2)
            spec = mft * _host_ramp(phis, mft.shape[-1])
        else:
            model = _eval_model_portrait(modelfile, phases, freqs, P)
            ph = float(phase_transform(phase, dDM, nu0, nu_DM, P))
            rotmodel = np.asarray(add_DM_nu(jnp.asarray(model), -ph, -dDM,
                                            P, jnp.asarray(freqs), xs=xs,
                                            Cs=Cs if Cs is not None
                                            else [1.0] * len(xs),
                                            nu_ref=nu_DM))
            spec = None
        if t_scat and not params[1]:  # modelfile tau overrides t_scat
            taus = np.asarray(scattering_times(t_scat / P, alpha, freqs,
                                               nu0))
            if spec is None:
                spec = np.fft.rfft(rotmodel, axis=-1)
            spec = spec * np.asarray(scattering_portrait_FT(
                jnp.asarray(taus), nbin))
        if spec is not None:
            rotmodel = np.fft.irfft(spec, n=nbin, axis=-1)
        if scint is not False:
            if scint is True:
                rotmodel = add_scintillation(rotmodel, random=True, nsin=3,
                                             amax=1.0, wmax=5.0, rng=rng)
            else:
                rotmodel = add_scintillation(rotmodel, scint)
        for ipol in range(npol):
            noise = rng.normal(0.0, 1.0, (nchan, nbin)) * \
                noise_stds[:, None]
            data[isub, ipol] = scales[:, None] * rotmodel + noise

    with open(ephemeris) as f:
        eph_lines = [ln.rstrip("\n") for ln in f.readlines()]
    arch = Archive(
        data=data, freqs=np.broadcast_to(freqs, (nsub, nchan)).copy(),
        weights=np.asarray(weights, dtype=float), Ps=Ps, epochs=epochs,
        subtimes=np.full(nsub, float(tsub)), DM=par.DM, dedispersed=True,
        nu0=float(nu0), bw=float(bw), source=par.PSR, telescope=telescope,
        frontend="fake_rx", backend="fake_be",
        state=state if npol == 4 else "Intensity",
        ephemeris_lines=eph_lines)
    if fold_hdr_dm:
        # data were generated in the dispersed frame directly
        arch.dedispersed = False
    elif not dedispersed:
        arch.dededisperse()
    # default i2: real PSRFITS archives store int16 DATA with per-channel
    # DAT_SCL/DAT_OFFS (what PSRCHIVE writes); this also feeds GetTOAs's
    # int16-native device ingest.  dtype="f4" opts out for exactness
    # tests.
    write_psrfits(outfile, arch, dtype=dtype, quiet=quiet)
    return arch


def make_constant_portrait(archive, outfile, profile=None, DM=0.0,
                           dmc=False, weights=None, quiet=False):
    """Fill a copy of an archive with one profile.

    Reference: pplib.py:958-994.
    """
    from pulseportraiture_tpu.io.psrfits import read_psrfits
    arch = read_psrfits(archive)
    nsub, npol, nchan, nbin = arch.data.shape
    if profile is None:
        prof_arch = arch.copy()
        prof_arch.tscrunch()
        prof_arch.pscrunch()
        prof_arch.fscrunch()
        profile = prof_arch.data[0, 0, 0]
    profile = np.asarray(profile)
    assert len(profile) == nbin, \
        "len(profile) != number of bins in dummy archive"
    if weights is None:
        weights = np.ones((nsub, nchan))
    out = arch.copy()
    out.data = np.broadcast_to(profile,
                               (nsub, npol, nchan, nbin)).copy()
    out.DM = DM
    out.weights = np.asarray(weights, dtype=float)
    out.dedispersed = bool(dmc)
    write_psrfits(outfile, out, quiet=quiet)
