"""Fit setups against a float64 NumPy reference: the natural-order rFFT
cross-spectrum (fitters/stats.py), the capped direct-DFT setup and the
CT-permuted layout (ops/ct_dft.py), and the fits built on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pulseportraiture_tpu.fitters import reference, stats
from pulseportraiture_tpu.ops.ct_dft import (band_cap_model_ft, ct_geometry,
                                             ct_kvec, ct_perm_np,
                                             ct_supported,
                                             direct_capped_setup,
                                             permute_spectrum,
                                             unpermute_spectrum)


def _np_cross(x, m, f0_fact=False, scale=None):
    return reference.cross_spectrum(x, m, f0_fact=f0_fact, scale=scale)


def _relmax(a, b, scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.abs(b).max() if scale is None else scale
    return np.abs(a - b).max() / (s + 1e-300)


def _capped_problem(nbin=512, nchan=24, width=0.05, seed=17):
    freqs = np.linspace(1100.0, 1900.0, nchan)
    xg = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((xg - 0.4) / width) ** 2)
    model64 = prof[None, :] * (freqs[:, None] / 1500.0) ** -1.5
    mf64 = np.fft.rfft(model64, axis=-1)
    mr, mi, mh = band_cap_model_ft(mf64.real, mf64.imag, nbin)
    assert mh is not None and mh % 8 == 0
    return np.random.default_rng(seed), freqs, model64, mr, mi, mh


@pytest.mark.parametrize("nbin", [256, 1024, 2048, 4096])
def test_natural_setup_matches_numpy(nbin):
    """make_setup's f32 Gr/Gi/sd equal the f64 NumPy cross-spectrum to
    f32 rounding at every production nbin."""
    rng = np.random.default_rng(0)
    nchan = 16
    x = rng.normal(0, 1, (nchan, nbin)).astype(np.float32)
    m = rng.normal(0, 1, (nchan, nbin)).astype(np.float32)
    s = stats.make_setup(jnp.asarray(x), jnp.asarray(m),
                         jnp.full(nchan, 1.0, jnp.float32), 0.003,
                         jnp.linspace(1100.0, 1900.0, nchan), 1500.0,
                         1500.0, 1500.0)
    G, sd = _np_cross(x, m)
    scale = np.abs(G).max()
    assert _relmax(s.Gr, G.real, scale) < 2e-6
    assert _relmax(s.Gi, G.imag, scale) < 2e-6
    w = float(np.asarray(s.w)[0])
    assert _relmax(np.asarray(s.sd_chan) / w, sd) < 2e-6
    M2 = np.abs(np.fft.rfft(m.astype(np.float64), axis=-1)) ** 2
    M2[:, 0] = 0.0
    assert _relmax(s.M2, M2) < 2e-6


def test_setup_batched_shares_model(nbin=512):
    """The shared-model batched setup (one model_ft, vmapped make_setup)
    equals the per-item setup with the model passed in time domain."""
    rng = np.random.default_rng(1)
    B, nchan = 3, 8
    x = rng.normal(0, 1, (B, nchan, nbin)).astype(np.float32)
    m = rng.normal(0, 1, (nchan, nbin)).astype(np.float32)
    errs = jnp.full(nchan, 0.5, jnp.float32)
    fr = jnp.linspace(1100.0, 1900.0, nchan)
    mft = stats.model_ft(jnp.asarray(m))
    Gb = jax.vmap(lambda d: stats.make_setup(
        d, None, errs, 0.003, fr, 1500.0, 1500.0, 1500.0,
        model_ft_ri=mft).Gr)(jnp.asarray(x))
    for b in range(B):
        s1 = stats.make_setup(jnp.asarray(x[b]), jnp.asarray(m), errs,
                              0.003, fr, 1500.0, 1500.0, 1500.0)
        np.testing.assert_allclose(np.asarray(Gb[b]), np.asarray(s1.Gr),
                                   rtol=0, atol=1e-5)


def _moments_in_order(setup, params, perm, scattering):
    """stats._moments on a setup whose spectra are gathered into `perm`
    order (kvec = perm), or natural order when perm is None."""
    if perm is not None:
        setup = setup._replace(
            Gr=setup.Gr[..., perm], Gi=setup.Gi[..., perm],
            M2=setup.M2[..., perm], S0=jnp.sum(setup.M2, -1),
            kvec=jnp.asarray(perm, setup.Gr.dtype))
    return stats._moments(params, setup, True, order=2,
                          scattering=scattering)


@pytest.mark.parametrize("scattering", [False, True])
def test_kvec_moments_match_natural_order(scattering, nbin=512):
    """Every harmonic reduction is order-free given kvec: the moments
    over CT-permuted spectra equal the natural-order moments."""
    rng = np.random.default_rng(2)
    nchan = 8
    x = rng.normal(0, 1, (nchan, nbin))
    m = rng.normal(0, 1, (nchan, nbin))
    setup = stats.make_setup(jnp.asarray(x), jnp.asarray(m),
                             jnp.full(nchan, 1.0), 0.003,
                             jnp.linspace(1100.0, 1900.0, nchan), 1500.0,
                             1500.0, 1500.0)
    params = jnp.asarray([0.13, 2e-3, 0.0, -3.0, -4.0])
    nat = _moments_in_order(setup, params, None, scattering)
    per = _moments_in_order(setup, params, ct_perm_np(nbin), scattering)
    for key in ("C", "S", "Cp", "Cpp", "Rf", "S1", "If1", "Rg", "S2"):
        np.testing.assert_allclose(np.asarray(per[key]),
                                   np.asarray(nat[key]), rtol=1e-9,
                                   atol=1e-9 * np.abs(
                                       np.asarray(nat[key])).max(),
                                   err_msg=key)


def test_ct_supported_gates():
    assert ct_supported(2048) and ct_supported(256)
    assert not ct_supported(100) and not ct_supported(128)
    NQ, M0, NH = ct_geometry(2048)
    assert NQ == 16 and M0 == 64 and NH == 1025
    kv = ct_kvec(2048)
    assert kv.shape == (1025,)
    assert int(kv[0]) == 0 and kv.max() == 1024
    # the layout is a permutation of 0..nbin/2 with Nyquist last
    assert int(kv[-1]) == 1024
    assert sorted(int(v) for v in kv) == list(range(1025))
    re = np.arange(1025.0)
    np.testing.assert_array_equal(
        unpermute_spectrum(*permute_spectrum(re, -re, 2048), 2048)[0], re)


@pytest.mark.parametrize("f0_fact,with_scale", [(False, False),
                                                (True, False),
                                                (False, True)])
def test_direct_capped_setup_matches_numpy(f0_fact, with_scale, nbin=512):
    """direct_capped_setup reproduces the f64 NumPy cross-spectrum at the
    kept harmonics, in CT-permuted order, with the Parseval sd over ALL
    harmonics, for every ingest variant — batched and squeezed."""
    rng, freqs, model64, mr, mi, mh = _capped_problem()
    B, nchan = 3, len(freqs)
    if f0_fact:
        mf = np.fft.rfft(model64, axis=-1)
        mr, mi = mf.real.astype(np.float32), mf.imag.astype(np.float32)
    mrp, mip = permute_spectrum(jnp.asarray(mr), jnp.asarray(mi), nbin,
                                mharm=mh)
    scale = None
    if with_scale:
        x = rng.integers(-3000, 3000, (B, nchan, nbin), dtype=np.int16)
        scale = rng.uniform(1e-4, 5e-4, (B, nchan)).astype(np.float32)
    else:
        x = (model64[None] +
             rng.normal(0, 0.1, (B, nchan, nbin))).astype(np.float32)
    G, sd = _np_cross(x, model64, f0_fact=f0_fact, scale=scale)
    kv = ct_perm_np(nbin, mh)
    Gt = G[..., kv]
    for sl in (slice(None), 0):
        out = direct_capped_setup(
            jnp.asarray(x[sl]), mrp, mip, mharm=mh,
            dft_precision="highest", f0_fact=f0_fact,
            scale=None if scale is None else jnp.asarray(scale[sl]))
        Gr, Gi, sdo = [np.asarray(a) for a in out]
        assert Gr.shape == Gt[sl].shape and sdo.shape == sd[sl].shape
        gs = np.abs(Gt).max()
        assert _relmax(Gr, Gt[sl].real, gs) < 2e-5
        assert _relmax(Gi, Gt[sl].imag, gs) < 2e-5
        assert _relmax(sdo, sd[sl]) < 2e-5


def test_direct_capped_seed_outputs(nbin=512):
    """direct_capped_setup(w=...) returns the weighted band sums
    sum_c w_c G_c (the brute-seed input) against NumPy; zero-weight
    channels contribute nothing and the plain outputs are unchanged."""
    rng, freqs, model64, mr, mi, mh = _capped_problem(seed=7)
    B, nchan = 3, len(freqs)
    x = rng.normal(0, 1, (B, nchan, nbin)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, (B, nchan)).astype(np.float32)
    w[:, 5] = 0.0
    mrp, mip = permute_spectrum(jnp.asarray(mr), jnp.asarray(mi), nbin,
                                mharm=mh)
    Gr, Gi, sd, gsr, gsi = direct_capped_setup(
        jnp.asarray(x), mrp, mip, mharm=mh, dft_precision="highest",
        w=jnp.asarray(w))
    G, _ = _np_cross(x, model64)
    Gt = G[..., ct_perm_np(nbin, mh)]
    gsr_t = (w[..., None] * Gt.real).sum(axis=1)
    gsi_t = (w[..., None] * Gt.imag).sum(axis=1)
    s = np.abs(gsr_t).max()
    assert _relmax(gsr, gsr_t, s) < 1e-5
    assert _relmax(gsi, gsi_t, s) < 1e-5
    Gr2, _, sd2 = direct_capped_setup(jnp.asarray(x), mrp, mip, mharm=mh,
                                      dft_precision="highest")
    np.testing.assert_array_equal(np.asarray(Gr), np.asarray(Gr2))
    np.testing.assert_array_equal(np.asarray(sd), np.asarray(sd2))


def test_direct_capped_i2_scale_ingest(nbin=512):
    """int16-native ingest: direct_capped_setup(x_i2, scale=...) equals
    the f32 path on scale*x up to f32 rounding; per-channel offsets never
    enter (DC is zeroed under f0_fact falsy)."""
    rng, freqs, model64, mr, mi, mh = _capped_problem(seed=9)
    B, nchan = 2, len(freqs)
    xi = rng.integers(-32768, 32767, (B, nchan, nbin), dtype=np.int16)
    scl = rng.uniform(1e-4, 5e-4, (B, nchan)).astype(np.float32)
    mrp, mip = permute_spectrum(jnp.asarray(mr), jnp.asarray(mi), nbin,
                                mharm=mh)
    w = jnp.ones((B, nchan), jnp.float32)
    kw = dict(mharm=mh, dft_precision="highest", w=w)
    out_i2 = direct_capped_setup(jnp.asarray(xi), mrp, mip,
                                 scale=jnp.asarray(scl), **kw)
    xf = xi.astype(np.float32) * scl[..., None]
    out_f32 = direct_capped_setup(jnp.asarray(xf), mrp, mip, **kw)
    for a, b in zip(out_i2, out_f32):
        assert _relmax(a, b) < 2e-6


def test_model_band_harmonic_cap_exact(nbin=256):
    """Capped layout: the kept positions hold exactly the harmonics
    k < NQ*mharm of the NumPy cross-spectrum, every dropped harmonic is
    zero in the model (so contributes nothing), and sd keeps the FULL
    data power."""
    from pulseportraiture_tpu.ops.ct_dft import suggest_mharm

    rng = np.random.default_rng(11)
    B, nchan = 3, 24
    NQ, M0, _ = ct_geometry(nbin)
    x = rng.normal(0, 1, (B, nchan, nbin)).astype(np.float32)
    prof = np.exp(-0.5 * ((np.arange(nbin) / nbin - 0.4) / 0.05) ** 2)
    m = (prof[None, :] * rng.uniform(0.5, 2, (nchan, 1)))
    mf = np.fft.rfft(m, axis=-1)
    mf[:, 25:] = 0.0                       # band-limited template
    mf[:, 0] = 0.0
    mh = suggest_mharm(mf.real, mf.imag, nbin)
    assert mh is not None and mh * NQ >= 25 and mh < M0
    mrp, mip = permute_spectrum(jnp.asarray(mf.real, jnp.float32),
                                jnp.asarray(mf.imag, jnp.float32), nbin,
                                mharm=mh)
    Gr, Gi, sd = direct_capped_setup(jnp.asarray(x), mrp, mip, mharm=mh,
                                     dft_precision="highest")
    D = np.fft.rfft(x.astype(np.float64), axis=-1)
    D[..., 0] = 0.0
    G = D * np.conj(mf)
    kv = ct_perm_np(nbin, mh)
    assert sorted(kv) == list(range(NQ * mh))
    assert np.abs(G[..., NQ * mh:]).max() == 0.0
    gs = np.abs(G).max()
    assert _relmax(Gr, G[..., kv].real, gs) < 2e-6
    assert _relmax(Gi, G[..., kv].imag, gs) < 2e-6
    assert _relmax(sd, (np.abs(D) ** 2).sum(-1)) < 1e-5


def test_dot_precision_map():
    """"high" is three bf16 passes with f32 accumulation, "highest" full
    f32; anything else (TF32 included) is refused."""
    from pulseportraiture_tpu.ops.ct_dft import dot_precision

    assert dot_precision("high") == \
        jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    assert dot_precision("HIGHEST") == jax.lax.Precision.HIGHEST
    for bad in ("default", "tf32", "fastest"):
        with pytest.raises(ValueError):
            dot_precision(bad)


def test_direct_capped_high_precision_class(nbin=512):
    """dft_precision="high" stays in the f32 accuracy class against an
    f64 truth (the bf16 x3 split loses ~2^-21 relative)."""
    rng, freqs, model64, mr, mi, mh = _capped_problem(seed=5, nchan=16)
    mrp, mip = permute_spectrum(jnp.asarray(mr), jnp.asarray(mi), nbin,
                                mharm=mh)
    x = (np.roll(model64[None], 37, axis=-1) +
         rng.normal(0, 0.1, (2, len(freqs), nbin))).astype(np.float32)
    Gr, _, _ = direct_capped_setup(jnp.asarray(x), mrp, mip, mharm=mh,
                                   dft_precision="high")
    D = np.fft.rfft(x.astype(np.float64), axis=-1)[..., ct_perm_np(nbin, mh)]
    Gr64 = D.real * np.asarray(mrp, np.float64) + \
        D.imag * np.asarray(mip, np.float64)
    Gr64[..., 0] = 0.0
    assert _relmax(Gr, Gr64) < 3e-6


def _shifted_problem(nbin, nchan, B, width, noise, seed):
    from pulseportraiture_tpu.config import DCONST

    rng = np.random.default_rng(seed)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    xg = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((xg - 0.4) / width) ** 2)
    model64 = prof[None, :] * (freqs[:, None] / 1500.0) ** -1.5
    mf64 = np.fft.rfft(model64, axis=-1)
    mr, mi, mh = band_cap_model_ft(mf64.real, mf64.imag, nbin)
    assert mh is not None
    P = 0.003
    k = 2j * np.pi * np.arange(nbin // 2 + 1)
    phis0 = rng.uniform(-0.01, 0.01, B)
    dms0 = rng.uniform(-2e-4, 2e-4, B)
    nu_fit = freqs.mean()
    data = np.empty((B, nchan, nbin), np.float32)
    for i in range(B):
        sh = phis0[i] + DCONST * dms0[i] / P * (freqs ** -2 -
                                                nu_fit ** -2)
        data[i] = np.fft.irfft(mf64 * np.exp(-k * sh[:, None]),
                               n=nbin, axis=-1)
    data += rng.normal(0, noise, data.shape).astype(np.float32)
    args = (jnp.asarray(data), jnp.asarray(model64, jnp.float32),
            jnp.zeros((B, 5), jnp.float32), jnp.full(B, P, jnp.float32),
            jnp.asarray(freqs, jnp.float32),
            jnp.full((B, nchan), noise, jnp.float32))
    kw = dict(nu_fits=jnp.full((B, 3), nu_fit, jnp.float32),
              fit_flags=(1, 1, 0, 0, 0), log10_tau=False, max_iter=20,
              scattering=False,
              model_ft_ri=(jnp.asarray(mr), jnp.asarray(mi)))
    return args, kw, mh, (mr, mi), freqs, P, nu_fit


@pytest.mark.parametrize("prec", ["highest", "high"])
def test_capped_fit_matches_full_band(prec, nbin=512):
    """fit_portrait_full_batch(ct=True, mharm=...) — the capped direct
    setup — recovers the same (phi, DM) as the natural-order full-band
    fit when the model is band-limited, at either DFT precision."""
    from pulseportraiture_tpu.fitters.portrait import \
        fit_portrait_full_batch

    args, kw, mh, _, _, _, _ = _shifted_problem(nbin, 24, 2, 0.04, 0.05,
                                                13)
    r_full = fit_portrait_full_batch(*args, seed_phase=True, **kw)
    r_cap = fit_portrait_full_batch(*args, seed_phase=True, ct=True,
                                    mharm=mh, dft_precision=prec, **kw)
    pf = np.asarray(r_full.params)
    pc = np.asarray(r_cap.params)
    assert np.abs(pc[:, 0] - pf[:, 0]).max() < 2e-6          # phi
    assert np.abs(pc[:, 1] - pf[:, 1]).max() < 2e-6          # DM
    assert np.allclose(np.asarray(r_cap.chi2), np.asarray(r_full.chi2),
                       rtol=1e-4)
    assert np.allclose(np.asarray(r_cap.snr), np.asarray(r_full.snr),
                       rtol=1e-3)


def test_capped_fit_requires_cap(nbin=256):
    """ct=True without a model-band cap (or with per-item models) is an
    error, never a silent fallback."""
    from pulseportraiture_tpu.fitters.portrait import \
        fit_portrait_full_batch

    args, kw, mh, _, _, _, _ = _shifted_problem(nbin, 8, 2, 0.05, 0.05, 3)
    with pytest.raises(ValueError):
        fit_portrait_full_batch(*args, ct=True, **kw)
    model3 = jnp.broadcast_to(args[1], (2,) + args[1].shape)
    kw.pop("model_ft_ri")
    with pytest.raises(ValueError):
        fit_portrait_full_batch(args[0], model3, *args[2:], ct=True,
                                mharm=mh, **kw)


def test_band_cap_model_ft_zeroes_dc_like_model_ft(nbin=512):
    """band_cap_model_ft applies the F0_FACT DC-zeroing convention
    (stats.model_ft) — callers feed raw np.fft.rfft output, and a
    retained model-DC term silently inflates S0/chi2/scales (a model's
    mean-flux DC in M2 once gave chi2 ~19x high)."""
    from pulseportraiture_tpu.fitters.portrait import \
        fit_portrait_full_batch

    rng = np.random.default_rng(7)
    B, nchan = 2, 16
    freqs = np.linspace(1100.0, 1900.0, nchan)
    xg = (np.arange(nbin) + 0.5) / nbin
    prof = 4.0 * np.exp(-0.5 * ((xg - 0.3) / 0.03) ** 2) + 0.7
    model64 = prof[None, :] * (freqs[:, None] / 1500.0) ** -1.0
    mf64 = np.fft.rfft(model64, axis=-1)
    mr, mi, mh = band_cap_model_ft(mf64.real, mf64.imag, nbin)
    # the convention itself: DC is zeroed (config F0_FACT == 0)
    assert np.all(mr[..., 0] == 0.0) and np.all(mi[..., 0] == 0.0)
    assert mh is not None
    data = (model64[None] +
            rng.normal(0, 0.1, (B, nchan, nbin))).astype(np.float32)
    args = (jnp.asarray(data), jnp.asarray(model64, jnp.float32),
            jnp.zeros((B, 5), jnp.float32),
            jnp.full(B, 0.003, jnp.float32),
            jnp.asarray(freqs, jnp.float32),
            jnp.full((B, nchan), 0.1, jnp.float32))
    kw = dict(fit_flags=(1, 1, 0, 0, 0), log10_tau=False, max_iter=20,
              scattering=False, seed_phase=True)
    # truly independent baseline: the fit computes its own model FT
    # through stats.model_ft (DC zeroed there)
    r_ref = fit_portrait_full_batch(*args, **kw)
    for extra in ({}, dict(ct=True, mharm=mh)):
        r_cap = fit_portrait_full_batch(
            *args, model_ft_ri=(jnp.asarray(mr), jnp.asarray(mi)),
            **extra, **kw)
        assert np.allclose(np.asarray(r_cap.chi2), np.asarray(r_ref.chi2),
                           rtol=1e-4)
        assert np.allclose(np.asarray(r_cap.scales),
                           np.asarray(r_ref.scales), rtol=1e-4)
        assert np.abs(np.asarray(r_cap.params)[:, :2] -
                      np.asarray(r_ref.params)[:, :2]).max() < 1e-6


def test_stacked_seed_weights_match_single(nbin=512):
    """(B, nchan, K) stacked seed weights: row 0 reproduces the single-w
    band sum; row k equals the explicit NumPy einsum of its weight
    vector with Gr/Gi."""
    rng, freqs, model64, mr, mi, mh = _capped_problem(seed=11, nchan=16,
                                                      width=0.03)
    B, nchan = 2, len(freqs)
    x = rng.normal(0, 1, (B, nchan, nbin)).astype(np.float32)
    w1 = rng.uniform(0.5, 2.0, (B, nchan)).astype(np.float32)
    hi = (np.arange(nchan) >= nchan // 2).astype(np.float32)
    w2 = (w1 * hi[None, :]).astype(np.float32)
    wst = np.stack([w1, w2], axis=-1)
    mrp, mip = permute_spectrum(jnp.asarray(mr), jnp.asarray(mi), nbin,
                                mharm=mh)
    kw = dict(mharm=mh, dft_precision="highest")
    Gr, Gi, sd, gsr1, gsi1 = direct_capped_setup(
        jnp.asarray(x), mrp, mip, w=jnp.asarray(w1), **kw)
    Gr2, Gi2, sd2, gsrS, gsiS = direct_capped_setup(
        jnp.asarray(x), mrp, mip, w=jnp.asarray(wst), **kw)
    assert gsrS.shape[1] == 2 and gsiS.shape[1] == 2
    np.testing.assert_array_equal(np.asarray(Gr2), np.asarray(Gr))
    np.testing.assert_array_equal(np.asarray(sd2), np.asarray(sd))
    np.testing.assert_allclose(np.asarray(gsrS[:, 0]), np.asarray(gsr1),
                               rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(gsr1)).max())
    ref_r = np.einsum("bc,bck->bk", w2, np.asarray(Gr, np.float64))
    ref_i = np.einsum("bc,bck->bk", w2, np.asarray(Gi, np.float64))
    scale = max(np.abs(ref_r).max(), np.abs(ref_i).max(), 1.0)
    assert np.abs(np.asarray(gsrS[:, 1]) - ref_r).max() / scale < 1e-5
    assert np.abs(np.asarray(gsiS[:, 1]) - ref_i).max() / scale < 1e-5


def test_seed_dm_matches_phase_seed_fit(nbin=512):
    """seed_dm=True seeds (phi, DM) jointly from the stacked half-band
    cross-spectra; the converged fit is unchanged (the seed only moves
    the Newton start) and the seeded DM lands near the injected value."""
    from pulseportraiture_tpu.config import DCONST
    from pulseportraiture_tpu.fitters.portrait import (
        _seed_phi_dm, fit_portrait_full_batch)

    B, nchan = 4, 64
    args, kw, mh, (mr, mi), freqs, P, nu_fit = _shifted_problem(
        nbin, nchan, B, 0.02, 0.02, 5)
    kw.update(ct=True, dft_precision="high", mharm=mh)
    r_ph = fit_portrait_full_batch(*args, seed_phase=True, **kw)
    r_dm = fit_portrait_full_batch(*args, seed_phase=True, seed_dm=True,
                                   **kw)
    p0 = np.asarray(r_ph.params)
    p1 = np.asarray(r_dm.params)
    assert np.abs(p1[:, 0] - p0[:, 0]).max() < 1e-6
    assert np.abs(p1[:, 1] - p0[:, 1]).max() < 1e-6
    assert np.asarray(r_dm.niter).mean() <= np.asarray(r_ph.niter).mean()

    # the raw seed itself: run the seed math on the stacked setup sums
    w = np.full((B, nchan), (0.02 * np.sqrt(nbin / 2.0)) ** -2.0,
                np.float32)
    hi = (np.arange(nchan) >= nchan // 2).astype(np.float32)
    wst = np.stack([w, w * hi[None, :]], axis=-1)
    mrp, mip = permute_spectrum(jnp.asarray(mr), jnp.asarray(mi), nbin,
                                mharm=mh)
    _, _, _, gsr, gsi = direct_capped_setup(
        args[0], mrp, mip, mharm=mh, dft_precision="highest",
        w=jnp.asarray(wst))
    kv = jnp.asarray(ct_kvec(nbin, mharm=mh))
    M2 = np.asarray(mrp) ** 2 + np.asarray(mip) ** 2
    wcurv = jnp.asarray(w * (M2 * np.asarray(kv) ** 2).sum(-1)[None, :])
    beta = jnp.asarray((freqs ** -2 - nu_fit ** -2)[None, :] *
                       np.ones((B, 1)), jnp.float32)
    kdm = jnp.full(B, DCONST / P, jnp.float32)
    phi0, dm0 = _seed_phi_dm(gsr, gsi, kv, wcurv, beta, kdm)
    # the seed is a Newton START, not an estimator: at this shape
    # (64 ch, noise 0.02) the half-band phase-difference DM carries a
    # ~1e-4 statistical error — assert it lands within the injected
    # offset scale (so it beats the DM=0 start it replaces), and the
    # phase within a few grid steps
    assert np.abs(np.asarray(dm0) - p0[:, 1]).max() < 4e-4
    assert np.abs(np.asarray(phi0) - p0[:, 0]).max() < 1e-3
