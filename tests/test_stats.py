"""Sufficient-statistics correctness: analytic gradient/Hessian vs autodiff
and a direct numpy transcription of the reference objective."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pulseportraiture_tpu.fitters import stats
from pulseportraiture_tpu.config import DCONST
from pulseportraiture_tpu.ops import gaussian_profile, rotate_portrait_full
from pulseportraiture_tpu.ops.scattering import (scattering_times,
                                                 scattering_portrait_FT)

RNG = np.random.default_rng(7)


def build_problem(nchan=16, nbin=128, tau=0.01, noise=0.05):
    freqs = np.linspace(1100.0, 1900.0, nchan)
    phases = (np.arange(nbin) + 0.5) / nbin
    model = np.zeros((nchan, nbin))
    for i, f in enumerate(freqs):
        wid = 0.04 * (f / 1500.0) ** -0.3
        model[i] = np.asarray(gaussian_profile(nbin, 0.4, wid)) * \
            (f / 1500.0) ** -1.2
    # scatter the data portrait
    taus = scattering_times(tau, -4.0, freqs, 1500.0)
    B = np.asarray(scattering_portrait_FT(jnp.asarray(taus), nbin))
    data = np.fft.irfft(B * np.fft.rfft(model, axis=-1), n=nbin, axis=-1)
    data = np.asarray(rotate_portrait_full(jnp.asarray(data), -0.1, -0.003,
                                           0.0, jnp.asarray(freqs), 1500.0,
                                           np.inf, P=0.003))
    data = data + RNG.normal(0, noise, data.shape)
    errs = np.full(nchan, noise)
    setup = stats.make_setup(jnp.asarray(data), jnp.asarray(model),
                             jnp.asarray(errs), 0.003, jnp.asarray(freqs),
                             1500.0, 1500.0, 1500.0)
    return setup, freqs


def numpy_chi2_prime(params, setup, log10_tau=True):
    """Direct numpy transcription of pptoaslib.py:525-542."""
    phi, DM, GM, x_tau, alpha = params
    tau = 10 ** x_tau if log10_tau else x_tau
    G = np.asarray(setup.Gr) + 1j * np.asarray(setup.Gi)
    M2 = np.asarray(setup.M2)
    w = np.asarray(setup.w)
    freqs = np.asarray(setup.freqs)
    P = float(setup.P)
    nharm = G.shape[-1]
    nbin = 2 * (nharm - 1)
    phis = phi + DCONST * DM * (freqs ** -2 - float(setup.nu_DM) ** -2) / P \
        + DCONST ** 2 * GM * (freqs ** -4 - float(setup.nu_GM) ** -4) / P
    k = np.arange(nharm)
    phsr = np.exp(2.0j * np.pi * np.outer(phis, k))
    taus = tau * (freqs / float(setup.nu_tau)) ** alpha
    B = np.array([(1.0 + 2j * np.pi * k * t) ** -1 for t in taus])
    S = w * np.sum(np.abs(B) ** 2 * M2, axis=-1)
    C = w * np.real(np.sum(G * np.conj(B) * phsr, axis=-1))
    ok = S > 0
    return -np.sum(C[ok] ** 2 / S[ok])


PARAMS = jnp.asarray([0.1, 0.003, 1e-7, -2.0, -4.2])


def test_chi2_matches_numpy_transcription():
    setup, _ = build_problem()
    got = float(stats.chi2_prime(PARAMS, setup, log10_tau=True))
    expected = numpy_chi2_prime(np.asarray(PARAMS), setup, log10_tau=True)
    np.testing.assert_allclose(got, expected, rtol=1e-12)


def test_analytic_gradient_matches_autodiff():
    setup, _ = build_problem()
    for log10_tau in (True, False):
        p = PARAMS if log10_tau else PARAMS.at[3].set(0.01)
        _, g, _ = stats.chi2_value_grad_hess(p, setup,
                                             fit_flags=(1, 1, 1, 1, 1),
                                             log10_tau=log10_tau)
        g_auto = jax.grad(lambda q: stats.chi2_prime(q, setup,
                                                     log10_tau=log10_tau))(p)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_auto),
                                   rtol=1e-8, atol=1e-10)


def test_analytic_hessian_matches_autodiff():
    setup, _ = build_problem(nchan=8, nbin=64)
    for log10_tau in (True, False):
        p = PARAMS if log10_tau else PARAMS.at[3].set(0.01)
        _, _, H = stats.chi2_value_grad_hess(p, setup,
                                             fit_flags=(1, 1, 1, 1, 1),
                                             log10_tau=log10_tau)
        H_auto = jax.hessian(lambda q: stats.chi2_prime(
            q, setup, log10_tau=log10_tau))(p)
        np.testing.assert_allclose(np.asarray(H), np.asarray(H_auto),
                                   rtol=1e-6, atol=1e-6)


def test_fit_flags_mask_gradient_and_hessian():
    setup, _ = build_problem(nchan=8, nbin=64)
    flags = (1, 1, 0, 1, 0)
    _, g, H = stats.chi2_value_grad_hess(PARAMS, setup, fit_flags=flags,
                                         log10_tau=True)
    assert float(g[2]) == 0.0 and float(g[4]) == 0.0
    assert float(H[2, 2]) == 1.0 and float(H[4, 4]) == 1.0
    assert float(H[2, 0]) == 0.0 and float(H[0, 4]) == 0.0


def test_masked_channels_equal_dropped_channels():
    setup, freqs = build_problem(nchan=16, nbin=64)
    # zero out weights of 4 channels
    w = np.asarray(setup.w).copy()
    w[[2, 5, 11, 13]] = 0.0
    setup_masked = setup._replace(w=jnp.asarray(w))
    keep = np.asarray([i for i in range(16) if i not in (2, 5, 11, 13)])
    setup_dropped = stats.FitSetup(
        Gr=setup.Gr[keep], Gi=setup.Gi[keep],
        M2=setup.M2[keep], w=setup.w[keep],
        freqs=setup.freqs[keep], P=setup.P, nu_DM=setup.nu_DM,
        nu_GM=setup.nu_GM, nu_tau=setup.nu_tau,
        Sd=jnp.asarray(0.0),  # Sd unused by value_grad_hess
        S0=jnp.sum(setup.M2[keep], axis=-1), nbin=setup.nbin)
    f1, g1, H1 = stats.chi2_value_grad_hess(PARAMS, setup_masked,
                                            log10_tau=True)
    f2, g2, H2 = stats.chi2_value_grad_hess(PARAMS, setup_dropped,
                                            log10_tau=True)
    np.testing.assert_allclose(float(f1), float(f2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-11)
    np.testing.assert_allclose(np.asarray(H1), np.asarray(H2), rtol=1e-10)


def test_woodbury_covariance_vs_dense_inverse():
    setup, _ = build_problem(nchan=8, nbin=64)
    flags = (1, 1, 1, 1, 1)
    cov, perrs, scales, scale_errs, S = stats.covariance_with_scales(
        PARAMS, setup, fit_flags=flags, log10_tau=True)
    # dense (5 + nchan) Hessian built from the same pieces
    m = stats._moments(PARAMS, setup, True, order=2)
    C, Sn = np.asarray(m["C"]), np.asarray(m["S"])
    r = C / Sn
    dC, dS = stats._grad_stack(m)
    d2C, d2S = stats._hess_stacks(m)
    dC, dS, d2C, d2S = map(np.asarray, (dC, dS, d2C, d2S))
    nchan = len(C)
    H = np.zeros((5 + nchan, 5 + nchan))
    A = (-2 * (r * np.asarray(d2C) - 0.5 * r ** 2 * np.asarray(d2S))).sum(-1)
    H[:5, :5] = A
    cross = -2 * (dC - r * dS)
    for n in range(nchan):
        H[5 + n, 5 + n] = 2 * Sn[n]
        H[:5, 5 + n] = H[5 + n, :5] = cross[:, n]
    dense_cov = np.linalg.inv(0.5 * H)
    np.testing.assert_allclose(np.asarray(cov), dense_cov[:5, :5],
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(scale_errs),
                               np.sqrt(np.diag(dense_cov)[5:]), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(scales), r, rtol=1e-12)


def test_no_scattering_specialization_matches_full_graph():
    """scattering=False must equal the full path when tau == 0."""
    import jax.numpy as jnp
    import numpy as np
    from pulseportraiture_tpu.fitters import stats

    rng = np.random.default_rng(3)
    nchan, nbin = 8, 64
    freqs = jnp.asarray(np.linspace(1100.0, 1900.0, nchan))
    data = jnp.asarray(rng.normal(1.0, 0.3, (nchan, nbin)))
    model = jnp.asarray(rng.normal(1.0, 0.3, (nchan, nbin)))
    setup = stats.make_setup(data, model, jnp.full(nchan, 0.1), 0.003,
                             freqs, 1500.0, 1500.0, 1500.0)
    params = jnp.asarray([0.01, 1e-4, 0.0, 0.0, -4.0])
    for ff in [(1, 1, 0, 0, 0), (1, 0, 0, 0, 0), (1, 1, 1, 0, 0)]:
        f1, g1, H1 = stats.chi2_value_grad_hess(
            params, setup, fit_flags=ff, log10_tau=False, scattering=True)
        f2, g2, H2 = stats.chi2_value_grad_hess(
            params, setup, fit_flags=ff, log10_tau=False, scattering=False)
        np.testing.assert_allclose(float(f1), float(f2), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np.asarray(H1), np.asarray(H2),
                                   rtol=1e-10, atol=1e-12)
    s1, S1 = stats.get_scales(params, setup, log10_tau=False,
                              scattering=True)
    s2, S2 = stats.get_scales(params, setup, log10_tau=False,
                              scattering=False)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S2), rtol=1e-12)


def _numpy_moments(params, setup, log10_tau=True):
    """fitters.reference.moments on a FitSetup's spectra."""
    from pulseportraiture_tpu.fitters import reference

    G = np.asarray(setup.Gr) + 1j * np.asarray(setup.Gi)
    return reference.moments(params, G, setup.M2, setup.w, setup.freqs,
                             float(setup.P), float(setup.nu_DM),
                             float(setup.nu_GM), float(setup.nu_tau),
                             log10_tau=log10_tau)


@pytest.mark.parametrize("scattering", [False, True])
def test_moments_match_numpy(scattering):
    """The XLA harmonic reductions (phase-only and the 9 scattering
    moments) equal an independent f64 NumPy transcription."""
    setup, _ = build_problem(nchan=8, nbin=128)
    params = PARAMS.at[2].set(0.0)
    if not scattering:
        params = params.at[3].set(-np.inf)
    got = stats._moments(params, setup, True, order=2,
                         scattering=scattering)
    want = _numpy_moments(np.asarray(params), setup)
    keys = ("C", "S", "Cp", "Cpp") + (
        ("Rf", "S1", "If1", "Rg", "S2") if scattering else ())
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key]), want[key],
                                   rtol=1e-9,
                                   atol=1e-10 * np.abs(want[key]).max(),
                                   err_msg=key)


def test_moments_batch_under_vmap():
    """vmapped fgh over a batch of setups equals the per-item calls."""
    items = [build_problem(nchan=8, nbin=64, tau=t)[0]
             for t in (0.005, 0.01, 0.02)]
    batch = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[
        s._replace(nbin=0) for s in items])
    batch = batch._replace(nbin=items[0].nbin)
    axes = stats.FitSetup(Gr=0, Gi=0, M2=0, w=0, freqs=0, P=0, nu_DM=0,
                          nu_GM=0, nu_tau=0, Sd=0, S0=0, nbin=None,
                          kvec=None, sd_chan=0)
    fgh = jax.vmap(lambda s: stats.chi2_value_grad_hess(PARAMS, s),
                   in_axes=(axes,))
    fb, gb, Hb = fgh(batch)
    for i, s in enumerate(items):
        f1, g1, H1 = stats.chi2_value_grad_hess(PARAMS, s)
        np.testing.assert_allclose(float(fb[i]), float(f1), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(gb[i]), np.asarray(g1),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np.asarray(Hb[i]), np.asarray(H1),
                                   rtol=1e-10, atol=1e-12)


def _dot_precisions(jaxpr):
    """The precision of every dot_general in a jaxpr, sub-jaxprs
    (while/cond/pjit bodies) included."""
    from jax.extend import core as jcore

    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("fit_flags,scattering", [
    ((1, 1, 0, 0, 0), False), ((1, 1, 0, 1, 1), True),
    ((1, 1, 1, 0, 0), False)])
def test_fit_dots_are_full_precision(fit_flags, scattering):
    """Every dot_general in one item's fit — trust-region Newton steps,
    nu_zero solve, Woodbury covariance — asks for HIGHEST precision:
    the GPU's default float32 dot is TF32."""
    from pulseportraiture_tpu.fitters.portrait import _make_fit_one

    setup, _ = build_problem(nchan=8, nbin=64)
    fit_one = _make_fit_one(fit_flags, True, 20, scattering)
    jaxpr = jax.make_jaxpr(fit_one)(setup, PARAMS)
    precs = _dot_precisions(jaxpr.jaxpr)
    assert precs, "no dot_general traced"
    hi = jax.lax.Precision.HIGHEST
    assert all(p == (hi, hi) for p in precs), precs
