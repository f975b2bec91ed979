"""PCA + B-spline portrait models (the ppspline model family).

pca / reconstruct_portrait / find_significant_eigvec mirror the reference
(pplib.py:1497-1619).  B-spline evaluation (splev equivalent) is a de Boor
recursion implemented in JAX, so spline models are differentiable and
vmappable over frequency grids.  Spline *fitting* (the reference's FITPACK
si.splprep, ppspline.py:143-155) is a weighted penalized least-squares fit
with FITPACK-style iterative knot insertion until the weighted sum of
squared residuals reaches the smoothing target s.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from pulseportraiture_tpu.ops.noise import get_noise_PS
from pulseportraiture_tpu.utils import count_crossings


def pca(port, mean_prof=None, weights=None, quiet=True):
    """Weighted principal components of (nchan, nbin) port.

    Returns (eigval, eigvec) sorted descending; eigvec columns are the
    components.  Matches np.cov(delta_port.T, aweights=weights, ddof=1)
    followed by eigh (reference pplib.py:1497-1534).
    """
    port = np.asarray(port)
    nmes, ndim = port.shape
    if weights is None:
        weights = np.ones(nmes)
    weights = np.asarray(weights, dtype=float)
    if mean_prof is None:
        mean_prof = (port * weights[:, None]).sum(0) / weights.sum()
    delta = port - mean_prof
    # np.cov with aweights w and ddof=1: C = (X^T W X) / (V1 - V2/V1),
    # V1 = sum w, V2 = sum w^2, X mean-removed with weighted mean
    wmean = (delta * weights[:, None]).sum(0) / weights.sum()
    X = delta - wmean
    V1 = weights.sum()
    V2 = (weights ** 2).sum()
    if X.size >= (1 << 22) and os.environ.get("PP_PCA_DEVICE", "") not in \
            ("", "0", "false"):
        # opt-in device Gram matrix at full f32 (TF32 would distort the
        # covariance the eigh diagonalizes); the eigh stays in LAPACK
        Xd = jnp.asarray(X)
        cov = np.asarray(jnp.matmul(
            Xd.T * jnp.asarray(weights, Xd.dtype), Xd,
            precision="highest")) / (V1 - V2 / V1)
    else:
        cov = (X.T * weights) @ X / (V1 - V2 / V1)
    eigval, eigvec = np.linalg.eigh(cov)
    isort = np.argsort(eigval)[::-1]
    return eigval[isort], eigvec[:, isort]


def reconstruct_portrait(port, mean_prof, eigvec):
    """Project port into the eigvec basis and reconstruct.

    Reference: pplib.py:1536-1553.
    """
    port = jnp.asarray(port)
    mean_prof = jnp.asarray(mean_prof)
    eigvec = jnp.asarray(eigvec)
    delta = port - mean_prof
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(delta, eigvec, precision=hi), eigvec.T,
                      precision=hi) + mean_prof


def find_significant_eigvec(eigvec, check_max=10, return_max=10,
                            snr_cutoff=150.0, check_crossings=True,
                            check_acorr=True, return_smooth=True,
                            evs_all=None, **kwargs):
    """Indices of significant eigenvectors by smoothing + Fourier S/N.

    Reference: pplib.py:1555-1619.

    evs_all: optional precomputed smart_smooth of eigvec.T[:nvec] —
    callers that also smooth other profiles (make_spline_model smooths
    the mean profile) batch everything into ONE smart_smooth call,
    since each wavelet level is a distinct compiled device program.
    """
    from pulseportraiture_tpu.models.wavelet import smart_smooth
    eigvec = np.asarray(eigvec)
    smooth_eigvec = np.zeros(eigvec.shape)
    ieig = []
    # one batched smart_smooth over the candidate eigenvectors (each is
    # a (nbin,) profile): the per-vector loop cost 10x the dispatches
    # and device round trips for identical results
    nvec = max(check_max, return_max)
    if evs_all is None:
        evs_all = np.asarray(smart_smooth(eigvec.T[:nvec], **kwargs))
    else:
        evs_all = np.asarray(evs_all)[:nvec]
    noises_all = np.asarray(get_noise_PS(eigvec.T[:nvec], chans=True)) * \
        np.sqrt(eigvec.shape[0] / 2.0)
    for ivec in range(nvec):
        add = False
        ev = evs_all[ivec]
        ev_noise = float(noises_all[ivec])
        ev_snr = np.sum(np.abs(np.fft.rfft(ev)[1:]) ** 2) / ev_noise \
            if ev_noise > 0 else 0.0
        if ev_snr >= snr_cutoff:
            if check_crossings and ev_snr < 3 * snr_cutoff:
                ncross = count_crossings(np.abs(ev), 0.1 * np.abs(ev).max())
                if ncross < int(0.02 * len(ev)):
                    add = True
            # NB: `and add` makes this branch unreachable (add is still
            # False here) — the REFERENCE has the identical dead branch
            # (pplib.py:1598 `elif check_acorr and ... and add_eigvec:`
            # with add_eigvec False), so its acorr FWHM filter never
            # runs either.  Kept bug-for-bug for behavior parity; see
            # PARITY.md.
            elif check_acorr and ev_snr < 3 * snr_cutoff and add:
                acorr = np.correlate(ev, ev, "same")
                fwhm = acorr.argmax() - \
                    np.where(acorr > acorr.max() / 2.0)[0].min()
                add = fwhm > 5
            else:
                add = True
        if add:
            ieig.append(ivec)
            if return_smooth:
                smooth_eigvec[:, ivec] = ev
        if ivec + 1 == check_max or len(ieig) == return_max:
            break
    ieig = np.array(ieig, dtype=int)
    if return_smooth:
        return ieig, smooth_eigvec
    return ieig


# ----------------------------------------------------------------------
# B-spline evaluation & fitting
# ----------------------------------------------------------------------

def _bspline_basis(x, t, k):
    """All B-spline basis values at points x for knot vector t, degree k.

    Returns (len(x), nbasis) dense basis matrix (host numpy; used for
    fitting).  Cox-de Boor with interval clamping for extrapolation.
    """
    x = np.asarray(x, dtype=float)
    t = np.asarray(t, dtype=float)
    n = len(t) - k - 1
    B = np.zeros((len(x), n))
    for j in range(n):
        B[:, j] = _deboor_one(x, t, k, j)
    return B


def _deboor_one(x, t, k, j):
    """Basis function B_{j,k} evaluated at x (recursive, numpy)."""
    if k == 0:
        # half-open [t_j, t_{j+1}); x == t_max belongs to the last
        # non-degenerate interval of the clamped knot vector
        in_interval = (x >= t[j]) & (x < t[j + 1])
        at_end = (x == t[-1]) & (t[j] < t[j + 1]) & (t[j + 1] == t[-1])
        return (in_interval | at_end).astype(float)
    out = np.zeros_like(x, dtype=float)
    d1 = t[j + k] - t[j]
    if d1 > 0:
        out += (x - t[j]) / d1 * _deboor_one(x, t, k - 1, j)
    d2 = t[j + k + 1] - t[j + 1]
    if d2 > 0:
        out += (t[j + k + 1] - x) / d2 * _deboor_one(x, t, k - 1, j + 1)
    return out


def splev(x, tck, der=0, ext=0):
    """Evaluate a (possibly parametric) B-spline: scipy splev equivalent.

    tck = (t, c, k) with c a (ndim, ncoef) array (parametric) or (ncoef,)
    vector.  JAX implementation (vmapped de Boor), differentiable in x.
    ext=0 extrapolates (same default as the reference usage,
    pplib.py:948).
    """
    t, c, k = tck
    t = jnp.asarray(t)
    c = jnp.atleast_2d(jnp.asarray(c))
    x = jnp.asarray(x)
    n = t.shape[0] - k - 1

    def eval_one(xv):
        # find knot interval i with t[i] <= x < t[i+1], clamped to valid
        i = jnp.clip(jnp.searchsorted(t, xv, side="right") - 1, k, n - 1)
        # de Boor's algorithm on the local control points
        idx = i - k + jnp.arange(k + 1)
        d = c[:, idx]  # (ndim, k+1)
        for r in range(1, k + 1):
            for j in range(k, r - 1, -1):
                denom = t[idx[j] + k - r + 1] - t[idx[j]]
                alpha = jnp.where(denom > 0, (xv - t[idx[j]]) /
                                  jnp.where(denom > 0, denom, 1.0), 0.0)
                d = d.at[:, j].set((1 - alpha) * d[:, j - 1] +
                                   alpha * d[:, j])
        return d[:, k]

    out = jax.vmap(eval_one)(jnp.atleast_1d(x))  # (npts, ndim)
    return out.T  # (ndim, npts) like scipy's parametric splev


def fit_parametric_spline(u, points, weights=None, k=3, s=None,
                          max_nbreak=None, nbreak_step=2, maxiter=30):
    """Weighted smoothing parametric spline through points(u).

    Approximates scipy's si.splprep (ppspline.py:143-155): least-squares
    B-spline fits with iterative interior-knot insertion until the
    weighted residual sum of squares <= s (FITPACK's stopping criterion).

    u: (npts,) strictly increasing parameter (frequency);
    points: (ndim, npts) curve coordinates; weights: (npts,);
    s: smoothing target (defaults to npts - sqrt(2*npts), FITPACK default).
    Returns (tck, fp) with tck = (t, c, k), c shape (ndim, ncoef).
    """
    u = np.asarray(u, dtype=float)
    points = np.atleast_2d(np.asarray(points, dtype=float))
    ndim, npts = points.shape
    if weights is None:
        weights = np.ones(npts)
    weights = np.asarray(weights, dtype=float)
    if s is None:
        s = npts - np.sqrt(2.0 * npts)
    k = int(k)

    def knots_with_interior(interior):
        return np.concatenate([np.full(k + 1, u[0]), interior,
                               np.full(k + 1, u[-1])])

    def fit_with_knots(t):
        B = _bspline_basis(u, t, k)  # (npts, ncoef)
        Bw = B * weights[:, None]
        # solve weighted LSQ per dim: (B^T W^2 B) c = B^T W^2 y
        A = Bw.T @ Bw
        coefs = np.zeros((ndim, B.shape[1]))
        for d in range(ndim):
            rhs = Bw.T @ (weights * points[d])
            coefs[d] = np.linalg.lstsq(A, rhs, rcond=None)[0]
        resid = points - coefs @ B.T
        fp = float((weights ** 2 * (resid ** 2).sum(0)).sum())
        return coefs, fp

    def fit_penalized(t, lam):
        """Weighted LSQ with a second-difference coefficient penalty
        (discrete thin-plate ridge), FITPACK's continuous smoothing
        control at a fixed knot set."""
        B = _bspline_basis(u, t, k)
        Bw = B * weights[:, None]
        ncoef = B.shape[1]
        D = np.diff(np.eye(ncoef), n=2, axis=0)
        A = Bw.T @ Bw + lam * (D.T @ D)
        coefs = np.zeros((ndim, ncoef))
        for d in range(ndim):
            rhs = Bw.T @ (weights * points[d])
            coefs[d] = np.linalg.lstsq(A, rhs, rcond=None)[0]
        resid = points - coefs @ B.T
        fp = float((weights ** 2 * (resid ** 2).sum(0)).sum())
        return coefs, fp

    interior = np.array([])
    t = knots_with_interior(interior)
    coefs, fp = fit_with_knots(t)
    it = 0
    while fp > s and it < maxiter:
        it += 1
        n_int = len(interior) + nbreak_step
        if max_nbreak is not None and n_int > max_nbreak:
            break
        if n_int > npts - k - 1:
            break
        # place interior knots at quantiles of the parameter values
        qs = np.linspace(0, 1, n_int + 2)[1:-1]
        interior = np.quantile(u, qs)
        t = knots_with_interior(interior)
        coefs, fp = fit_with_knots(t)

    if fp < s and len(interior):
        # knot insertion overshot the target: bisect a ridge penalty so
        # the residual lands ON s (FITPACK solves for its smoothing
        # parameter p the same way; avoids undersmoothing by up to one
        # knot batch)
        lo, hi = 0.0, 1.0
        _, fp_hi = fit_penalized(t, hi)
        grow = 0
        while fp_hi < s and grow < 60:
            hi *= 4.0
            _, fp_hi = fit_penalized(t, hi)
            grow += 1
        if fp_hi >= s:
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                c_mid, fp_mid = fit_penalized(t, mid)
                if fp_mid < s:
                    lo = mid
                else:
                    hi = mid
            coefs, fp = fit_penalized(t, lo)
    return (jnp.asarray(t), jnp.asarray(coefs), k), fp


def splev_np(x, tck):
    """Host-numpy splev (parametric): values (ndim, npts).

    Mirrors splev's de Boor recursion exactly — including ext=0
    EXTRAPOLATION outside the knot span (the interval index clamps to
    the edge span and the local polynomial extends), which the basis-
    matrix form used for FITTING cannot do (its Cox-de Boor indicators
    are zero outside the span).  Out-of-span evaluation is a
    production case: make_spline_model evaluates the model over ALL
    channels including zapped band edges outside the fitted ok-channel
    span, and read_spline_model evaluates saved models on new
    archives' frequency grids.  Used where the result is consumed on
    the HOST, where ~0.1 GFLOP of work does not pay a (nchan, nbin)
    device->host copy.
    """
    t, c, k = tck
    t = np.asarray(t, dtype=float)
    c = np.atleast_2d(np.asarray(c, dtype=float))
    x = np.atleast_1d(np.asarray(x, dtype=float))
    k = int(k)
    n = len(t) - k - 1
    # same interval clamp as splev: de Boor on the edge span
    # extrapolates for x outside [t[k], t[n]]
    i = np.clip(np.searchsorted(t, x, side="right") - 1, k, n - 1)
    idx = i[:, None] - k + np.arange(k + 1)[None, :]   # (npts, k+1)
    d = c[:, idx]                                      # (ndim, npts, k+1)
    d = np.ascontiguousarray(d)
    for r in range(1, k + 1):
        for j in range(k, r - 1, -1):
            denom = t[idx[:, j] + k - r + 1] - t[idx[:, j]]
            alpha = np.where(denom > 0,
                             (x - t[idx[:, j]]) /
                             np.where(denom > 0, denom, 1.0), 0.0)
            d[:, :, j] = (1.0 - alpha) * d[:, :, j - 1] + \
                alpha * d[:, :, j]
    return d[:, :, k]                                  # (ndim, npts)


def gen_spline_portrait_np(mean_prof, freqs, eigvec, tck, nbin=None):
    """Host-numpy gen_spline_portrait (same contract; see splev_np)."""
    mean_prof = np.asarray(mean_prof, dtype=float)
    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    eigvec = np.asarray(eigvec, dtype=float)
    if eigvec.shape[1] == 0:
        port = np.tile(mean_prof, (freqs.shape[0], 1))
    else:
        proj = splev_np(freqs, tck).T        # (nfreq, ncomp)
        port = proj @ eigvec.T + mean_prof
    if nbin is not None and mean_prof.shape[-1] != nbin:
        old_nbin = mean_prof.shape[-1]
        from scipy.signal import resample
        port = resample(port, nbin, axis=-1)
        shift = 0.5 * (1.0 / nbin - 1.0 / old_nbin)
        from pulseportraiture_tpu.ops.rotate import rotate_portrait_np
        port = rotate_portrait_np(port, shift)
    return port


def reconstruct_portrait_np(port, mean_prof, eigvec):
    """Host-numpy reconstruct_portrait (~0.2 GFLOP; see splev_np)."""
    port = np.asarray(port, dtype=float)
    mean_prof = np.asarray(mean_prof, dtype=float)
    eigvec = np.asarray(eigvec, dtype=float)
    delta = port - mean_prof
    return (delta @ eigvec) @ eigvec.T + mean_prof


def gen_spline_portrait(mean_prof, freqs, eigvec, tck, nbin=None):
    """Model portrait from a spline model: splev -> project -> + mean.

    Reference: pplib.py:932-956 (including the ss.resample half-bin shift
    correction when changing nbin).
    """
    mean_prof = jnp.asarray(mean_prof)
    freqs = jnp.atleast_1d(jnp.asarray(freqs))
    eigvec = jnp.asarray(eigvec)
    if eigvec.shape[1] == 0:
        port = jnp.tile(mean_prof, (freqs.shape[0], 1))
    else:
        proj = splev(freqs, tck).T        # (nfreq, ncomp)
        port = jnp.matmul(proj, eigvec.T,
                          precision=jax.lax.Precision.HIGHEST) + mean_prof
    if nbin is not None and mean_prof.shape[-1] != nbin:
        from pulseportraiture_tpu.ops.rotate import rotate_portrait
        old_nbin = mean_prof.shape[-1]
        port = _fourier_resample(port, nbin)
        shift = 0.5 * (1.0 / nbin - 1.0 / old_nbin)
        port = rotate_portrait(port, shift)
    return port


def _fourier_resample(port, nbin):
    """scipy.signal.resample equivalent (Fourier zero-pad/truncate).

    Split-real transforms (ops.fourier)."""
    from pulseportraiture_tpu.ops.fourier import irfft_ri, rfft_ri

    port = jnp.asarray(port)
    old = port.shape[-1]
    Fr, Fi = rfft_ri(port)
    nharm_new = nbin // 2 + 1
    if nharm_new <= Fr.shape[-1]:
        Fnr = Fr[..., :nharm_new]
        Fni = Fi[..., :nharm_new]
        # scipy folds the conjugate half onto the new Nyquist bin when
        # downsampling to an even length: Y[N/2] = 2 Re(X[N/2])
        if nbin % 2 == 0 and nharm_new < Fr.shape[-1]:
            Fnr = Fnr.at[..., -1].set(2.0 * Fnr[..., -1])
            Fni = Fni.at[..., -1].set(0.0)
    else:
        pad = nharm_new - Fr.shape[-1]
        zeros = jnp.zeros(port.shape[:-1] + (pad,), dtype=Fr.dtype)
        Fnr = jnp.concatenate([Fr, zeros], axis=-1)
        Fni = jnp.concatenate([Fi, zeros], axis=-1)
        if old % 2 == 0:
            # split the old Nyquist bin when upsampling from even length
            Fnr = Fnr.at[..., old // 2].set(Fnr[..., old // 2] * 0.5)
            Fni = Fni.at[..., old // 2].set(Fni[..., old // 2] * 0.5)
    return irfft_ri(Fnr, Fni, n=nbin) * (nbin / old)
