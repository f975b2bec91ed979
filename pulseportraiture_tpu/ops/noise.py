"""Off-pulse noise / SNR estimators.

The production estimator is the 'PS' method (reference default,
pplib.py:62): the RMS of the highest 1/frac of the power spectrum.  It is
fully vectorized over channels (the reference loops in Python,
pplib.py:2239-2247).  The 'fit' method (noise floor located by brute-fitting
a decaying exponential to the log power spectrum, pplib.py:2255-2287 +
1448-1495) is provided as a host-side numpy implementation since it is only
used interactively.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pulseportraiture_tpu.config import SNR_FUDGE


def get_noise_PS(data, frac=4, chans=False):
    """Noise from the mean of the highest 1/frac of the power spectrum.

    data: (..., nbin) or (nchan, nbin) with chans=True; returns per-channel
    noise along the leading axes when chans=True, else a scalar computed on
    the raveled data.  Reference: pplib.py:2227-2253.

    Concrete (non-traced) inputs are estimated on the host in float64
    (numpy rfft): this is a load-time estimator.  Traced inputs use
    jnp.fft.
    """
    import jax

    if not isinstance(data, jax.core.Tracer):
        # keep a float32 input in float32: the estimate is an error bar
        # and the f32 rfft is ~2x cheaper on campaign loads
        d = np.asarray(data)
        if d.dtype not in (np.float32, np.float64):
            d = d.astype(np.float64)
        # only the top-1/frac tail of the power spectrum is used, so the
        # powers are formed on that slice alone (bitwise-identical to
        # slicing the full pows array; ~4x less elementwise work)
        if chans:
            n = d.shape[-1]
            FFT = np.fft.rfft(d, axis=-1)
            kc = int((1 - 1.0 / frac) * FFT.shape[-1])
            t = FFT[..., kc:]
            out = np.sqrt(np.mean((t.real ** 2 + t.imag ** 2) / n,
                                  axis=-1))
        else:
            raveld = d.ravel()
            n = raveld.shape[0]
            FFT = np.fft.rfft(raveld)
            kc = int((1 - 1.0 / frac) * FFT.shape[0])
            t = FFT[kc:]
            out = np.sqrt(np.mean((t.real ** 2 + t.imag ** 2) / n))
        dt = getattr(data, "dtype", None)
        if dt is not None and jnp.issubdtype(dt, jnp.floating):
            out = np.asarray(out, dtype=dt)
        return out    # host array: load-time callers stay off-device

    from pulseportraiture_tpu.ops.fourier import rfft_ri
    data = jnp.asarray(data)
    if chans:
        n = data.shape[-1]
        re, im = rfft_ri(data)
        pows = (re ** 2 + im ** 2) / n
        kc = int((1 - 1.0 / frac) * pows.shape[-1])
        return jnp.sqrt(jnp.mean(pows[..., kc:], axis=-1))
    raveld = data.ravel()
    n = raveld.shape[0]
    re, im = rfft_ri(raveld[None, :])
    pows = (re[0] ** 2 + im[0] ** 2) / n
    kc = int((1 - 1.0 / frac) * pows.shape[0])
    return jnp.sqrt(jnp.mean(pows[kc:]))


def get_noise_fit(data, fact=1.1, chans=False):
    """Noise with cutoff harmonic found by fitting the log power spectrum.

    Host-side numpy (diagnostic path).  Reference: pplib.py:2255-2287.
    """
    data = np.asarray(data)

    def one(prof):
        FFT = np.fft.rfft(prof)
        pows = np.real(FFT * np.conj(FFT)) / len(prof)
        k_crit = fact * _find_kc(pows)
        k_crit = min(int(0.99 * len(pows)), int(k_crit))
        return np.sqrt(np.mean(pows[int(k_crit):]))

    if chans:
        return np.array([one(prof) for prof in data])
    return one(data.ravel())


def _find_kc(pows, fn="exp_dc"):
    """Critical cutoff index from a decaying-exponential fit to log power.

    Reference: pplib.py:1448-1495 (find_kc / find_kc_function), brute grid.
    """
    data = np.log10(pows)
    N = len(data)
    a_grid = np.linspace(1.0 / N, 1.0, 20)
    b_grid = np.linspace(0.0, data.max() - data.min(), 20)
    dc_grid = np.linspace(data.min(), data.max(), 20)
    ii = np.arange(N)
    best = (np.inf, a_grid[0])
    for a in a_grid:
        e = np.exp(-a * ii)
        for b in b_grid:
            for dc in dc_grid:
                chi2 = np.sum((data - (b * e + dc)) ** 2)
                if chi2 < best[0]:
                    best = (chi2, a)
    a = best[1]
    idx = np.where(np.exp(-a * ii) < 0.005)[0]
    return idx.min() if len(idx) else N - 1


def get_noise(data, method="PS", **kwargs):
    """Dispatcher.  Reference: pplib.py:2206-2225."""
    if method == "PS":
        return get_noise_PS(data, **kwargs)
    if method == "fit":
        return get_noise_fit(data, **kwargs)
    raise ValueError(f"Unknown get_noise method {method!r}")


def get_SNR(prof, fudge=SNR_FUDGE, noise=None):
    """Equivalent-width SNR estimate (baseline assumed removed).

    Reference: pplib.py:2289-2308 (Lorimer & Kramer 2005).
    Concrete inputs compute on the host (load-time estimator; see
    get_noise_PS); traced inputs stay in jnp.

    noise: optional precomputed global noise scalar.  load_data passes
    the RMS of its per-channel PS estimates, skipping a second
    full-archive rfft (the raveled-spectrum scalar and the channel-RMS
    agree as white-noise estimators; every pipeline consumer uses SNRs
    only as relative weights, where a global scalar cancels exactly).
    """
    import jax

    if not isinstance(prof, jax.core.Tracer):
        p = np.asarray(prof)
        if p.dtype not in (np.float32, np.float64):
            p = p.astype(np.float64)
        if noise is None:
            noise = np.asarray(get_noise_PS(p))
        Weq = p.sum(-1) / p.max(-1)
        mask = np.where(Weq <= 0.0, 0.0, 1.0)
        Weq = np.where(Weq <= 0.0, 1.0, Weq)
        SNR = p.sum(-1) / (noise * Weq ** 0.5)
        out = SNR * mask / fudge
        dt = getattr(prof, "dtype", None)
        if dt is not None and jnp.issubdtype(dt, jnp.floating):
            out = np.asarray(out, dtype=dt)
        return out    # host array: load-time callers stay off-device
    prof = jnp.asarray(prof)
    noise = get_noise_PS(prof)
    Weq = prof.sum(-1) / prof.max(-1)
    mask = jnp.where(Weq <= 0.0, 0.0, 1.0)
    Weq = jnp.where(Weq <= 0.0, 1.0, Weq)
    SNR = prof.sum(-1) / (noise * Weq ** 0.5)
    return SNR * mask / fudge


def get_red_chi2(data, model, errs=None, dof=None):
    """Reduced chi-squared of data vs model.  Reference: pplib.py:727-750."""
    data = jnp.asarray(data)
    model = jnp.asarray(model)
    resids = data - model
    if errs is None:
        errs = get_noise_PS(data, chans=(data.ndim == 2))
    if dof is None:
        dof = sum(data.shape)
    if data.ndim == 1:
        return jnp.sum((resids / errs) ** 2) / dof
    return jnp.sum((resids / jnp.asarray(errs)[:, None]) ** 2) / dof
