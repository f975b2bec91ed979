"""End-to-end integration: the reference's examples/example.py flow
(SURVEY.md section 4, item 1) — the designated parity suite.

make_fake_pulsar (injected per-epoch dDMs) -> align_archives ->
spline/gaussian model -> GetTOAs -> recovered DeltaDM_means vs injected.
"""

import os

import numpy as np
import pytest

from pulseportraiture_tpu.io.archive import load_data
from pulseportraiture_tpu.io.mjd import MJD
from pulseportraiture_tpu.io.psrfits import read_psrfits
from pulseportraiture_tpu.io.tim import write_TOAs
from pulseportraiture_tpu.models.gmodel_io import write_model
from pulseportraiture_tpu.pipelines.align import align_archives
from pulseportraiture_tpu.pipelines.toas import GetTOAs
from pulseportraiture_tpu.sim.fake import make_fake_pulsar

PAR_LINES = [
    "PSR             J1234-5678",
    "RAJ      01:02:03.45678901  1",
    "DECJ     -04:05:06.7890123  1",
    "F0      345.67890123456789  1",
    "F1       -1.2345679978D-13  1",
    "PEPOCH        50000.000000",
    "DM                34.56789",
]

MODEL_PARAMS = [0.0, 0.0,
                0.2193, -0.0052, 0.0482, -2.08, 5.13, -1.66,
                0.2341, -0.0027, 0.0157, 1.615, 9.46, -2.08]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("e2e")
    par = str(ws / "test.par")
    with open(par, "w") as f:
        f.write("\n".join(PAR_LINES) + "\n")
    gmodel = str(ws / "test.gmodel")
    write_model(gmodel, "TEST", "000", 1500.0, MODEL_PARAMS,
                [1] * len(MODEL_PARAMS), -4.0, 0, quiet=True)
    return ws, par, gmodel


def _make_epochs(ws, par, gmodel, nfiles=3, nsub=2, nchan=32, nbin=256,
                 noise=0.5, dDMs=None, scint=False):
    rng = np.random.default_rng(2026)
    if dDMs is None:
        dDMs = rng.normal(3e-4, 2e-4, nfiles)
    files = []
    for i in range(nfiles):
        path = str(ws / f"epoch-{i + 1}.fits")
        make_fake_pulsar(gmodel, par, outfile=path, nsub=nsub, npol=1,
                         nchan=nchan, nbin=nbin, nu0=1500.0, bw=800.0,
                         tsub=60.0, phase=0.0, dDM=dDMs[i],
                         start_MJD=MJD(57202.0 + 20.0 * i),
                         noise_stds=noise, dedispersed=False, scint=scint,
                         quiet=True, rng=rng)
        files.append(path)
    return files, dDMs


def test_psrfits_roundtrip(workspace):
    ws, par, gmodel = workspace
    files, dDMs = _make_epochs(ws, par, gmodel, nfiles=1, nsub=2)
    arch = read_psrfits(files[0])
    assert arch.data.shape == (2, 1, 32, 256)
    assert not arch.dedispersed
    assert abs(arch.DM - 34.56789) < 1e-9
    assert arch.source == "J1234-5678"
    assert arch.ephemeris_lines[0].startswith("PSR")
    # folding period from F0/F1 near PEPOCH-era value
    assert abs(arch.Ps[0] - 1.0 / 345.6789) < 1e-6
    # epochs at subint midpoints, tsub apart
    assert abs((arch.epochs[1] - arch.epochs[0]) - 60.0) < 1e-9


def test_folded_dm_generation_matches_two_rotation_composition(workspace):
    """make_fake_pulsar's dispersed-frame fast path (header DM folded
    into ONE Fourier-domain ramp, sim/fake.py) must match the explicit
    composition rotate(-phase,-dDM) then dededisperse(-DM) used before
    round 3 (reference semantics pplib.py:3183-3378).

    The sequential composition is NOT bit-identical in general: each
    intermediate irfft discards the imaginary part of the rotated
    Nyquist harmonic, while the fold composes the ramps exactly.  So:
    (a) against an independent exact one-ramp NumPy composition the
    fold must agree to f64 accuracy at any nbin; (b) against the
    sequential rotate_data composition it must agree wherever the model
    has negligible Nyquist power (any realistic profile/nbin)."""
    import jax.numpy as jnp

    from pulseportraiture_tpu.config import DCONST
    from pulseportraiture_tpu.io.par import parse_par, period_at
    from pulseportraiture_tpu.models.gmodel_io import read_model
    from pulseportraiture_tpu.ops.rotate import rotate_data
    from pulseportraiture_tpu.utils import get_bin_centers

    ws, par, gmodel = workspace
    p = parse_par(par)
    phase, dDM = 0.0123, 3e-4

    def make(nchan, nbin, tag):
        path = str(ws / f"folded-{tag}.fits")
        arch = make_fake_pulsar(gmodel, par, outfile=path, nsub=1,
                                npol=1, nchan=nchan, nbin=nbin,
                                nu0=1500.0, bw=800.0, tsub=60.0,
                                phase=phase, dDM=dDM,
                                start_MJD=MJD(57202.0), noise_stds=0.0,
                                dedispersed=False, quiet=True,
                                dtype="f4", rng=np.random.default_rng(7))
        assert not arch.dedispersed
        cw = 800.0 / nchan
        freqs = np.linspace(1100.0 + cw / 2, 1900.0 - cw / 2, nchan)
        P = period_at(p, MJD(57202.0).add_seconds(30.0).in_days())
        _, _, model = read_model(gmodel, get_bin_centers(nbin), freqs, P,
                                 quiet=True)
        return arch, np.asarray(model), freqs, P

    # (a) exact one-ramp composition, independent formulation (no mod
    # reduction), small nbin where the Nyquist harmonic is non-trivial
    arch, model, freqs, P = make(24, 128, "a")
    k = np.arange(128 // 2 + 1)
    phis = -phase - DCONST * (dDM + p.DM) / P * \
        (freqs ** -2.0 - 1500.0 ** -2.0)
    want = np.fft.irfft(np.fft.rfft(model, axis=-1) *
                        np.exp(2j * np.pi * phis[:, None] * k),
                        n=128, axis=-1)
    assert np.abs(arch.data[0, 0] - want).max() < 1e-9

    # (b) sequential rotate_data composition at a realistic nbin
    arch, model, freqs, P = make(24, 512, "b")
    r1 = rotate_data(jnp.asarray(model), -phase, -dDM, P,
                     jnp.asarray(freqs), 1500.0)
    want = np.asarray(rotate_data(r1, 0.0, -p.DM, P, jnp.asarray(freqs),
                                  1500.0))
    assert np.abs(arch.data[0, 0] - want).max() < 1e-8


def test_load_data_schema(workspace):
    ws, par, gmodel = workspace
    files, _ = _make_epochs(ws, par, gmodel, nfiles=1, nsub=2)
    data = load_data(files[0], dededisperse=True, pscrunch=True,
                     rm_baseline=True, quiet=True)
    for key in ("subints", "freqs", "weights", "masks", "noise_stds",
                "SNRs", "epochs", "Ps", "ok_isubs", "ok_ichans", "phases",
                "prof", "prof_SNR", "doppler_factors", "backend_delay",
                "telescope_code", "nu0", "bw", "state", "source"):
        assert key in data, key
    assert data.subints.shape == (2, 1, 32, 256)
    assert len(data.ok_isubs) == 2
    # baseline removed: profile medians near zero vs pulse peak
    prof = data.subints[0, 0, 16]
    assert abs(np.median(prof)) < 0.2 * prof.max()


def test_full_pipeline_recovers_injected_dDMs(workspace):
    ws, par, gmodel = workspace
    files, dDMs = _make_epochs(ws, par, gmodel, nfiles=3, nsub=2,
                               noise=0.3)
    # 1. align + average epochs into a high-S/N portrait
    port_file = str(ws / "aligned.port")
    align_archives(datafiles=files, initial_guess=files[0], tscrunch=True,
                   outfile=port_file, niter=1, quiet=True)
    arch = read_psrfits(port_file)
    assert arch.data.shape[2:] == (32, 256)
    # 2. measure TOAs with the true gmodel (model-build tested separately)
    gt = GetTOAs(files, gmodel, quiet=True)
    gt.get_TOAs(quiet=True)
    assert len(gt.TOA_list) == 6
    recovered = np.asarray(gt.DeltaDM_means)
    assert len(recovered) == 3
    # injected dDMs recovered within a few sigma
    errs = np.asarray(gt.DeltaDM_errs)
    resid = recovered - dDMs
    assert np.all(np.abs(resid) < 6 * errs + 5e-6), (recovered, dDMs, errs)
    # 3. TOA output format
    tim = str(ws / "test.tim")
    lines = write_TOAs(gt.TOA_list, outfile=tim, append=False)
    assert len(lines) == 6
    toks = lines[0].split()
    assert toks[0].endswith(".fits")
    float(toks[1])           # frequency
    mjd = float(toks[2])
    assert 57190 < mjd < 57260
    assert "-pp_dm" in lines[0] and "-gof" in lines[0] and \
        "-snr" in lines[0]
    # written MJD string preserves 15 decimals
    assert len(toks[2].split(".")[1]) == 15


def test_toas_with_scattering_fit(workspace):
    ws, par, gmodel = workspace
    rng = np.random.default_rng(7)
    path = str(ws / "scat.fits")
    make_fake_pulsar(gmodel, par, outfile=path, nsub=1, npol=1, nchan=32,
                     nbin=256, nu0=1500.0, bw=800.0, tsub=60.0, dDM=0.0,
                     start_MJD=MJD(57202.0), noise_stds=0.2,
                     t_scat=2e-5, dedispersed=False, quiet=True, rng=rng)
    gt = GetTOAs([path], gmodel, quiet=True)
    gt.get_TOAs(fit_scat=True, quiet=True)
    assert len(gt.TOA_list) == 1
    toa = gt.TOA_list[0]
    # scat_time flag ~ injected 2e-5 s = 20 us at nu0 (fit ref differs;
    # just sanity-check order of magnitude and flag presence)
    assert "scat_time" in toa.flags
    assert 1.0 < toa.flags["scat_time"] < 400.0
    assert toa.flags["gof"] < 2.0


def test_model_built_pipeline_aligned_template_is_dedispersed(workspace):
    """ppalign -> ppspline -> pptoas: the averaged template must be
    dedispersed (align loads the initial guess with dedisperse=True,
    reference ppalign.py:103-106) so DeltaDMs measured against the
    built model carry no systematic dispersion offset."""
    ws, par, gmodel = workspace
    files, dDMs = _make_epochs(ws, par, gmodel, nfiles=3, nsub=2,
                               noise=0.2)
    port_file = str(ws / "built.port")
    align_archives(datafiles=files, initial_guess=files[0], tscrunch=True,
                   outfile=port_file, niter=1, quiet=True)
    from pulseportraiture_tpu.portrait import DataPortrait
    dp = DataPortrait(port_file, quiet=True)
    dp.normalize_portrait("prof")
    dp.make_spline_model(max_ncomp=3, smooth=False, quiet=True)
    spl = str(ws / "built.spl")
    dp.write_model(spl, quiet=True)
    gt = GetTOAs(files, spl, quiet=True)
    gt.get_TOAs(quiet=True)
    rec = np.asarray(gt.DeltaDM_means)
    # no systematic dispersion offset: the mean fitted dDM must sit at the
    # template's absorbed dDM scale (~injected mean, < 1e-3), not O(1e-2)
    assert abs(rec.mean()) < 1.5e-3, rec
    # relative structure tracks the injection to a few sigma
    errs = np.asarray(gt.DeltaDM_errs) + 1e-5
    rel = (rec - rec.mean()) - (dDMs - dDMs.mean())
    assert np.all(np.abs(rel) < 8 * errs), (rec, dDMs, errs)


def test_narrowband_scattering_fit(workspace):
    """Per-channel (phi, tau) narrowband fits recover the injected
    scattering timescale (beyond-reference: upstream scaffolds but
    disables this, pptoas.py:988-994)."""
    ws, par, gmodel = workspace
    rng = np.random.default_rng(17)
    path = str(ws / "nbscat.fits")
    make_fake_pulsar(gmodel, par, outfile=path, nsub=1, npol=1, nchan=16,
                     nbin=256, nu0=1500.0, bw=800.0, tsub=60.0, dDM=0.0,
                     start_MJD=MJD(57202.0), noise_stds=0.05,
                     t_scat=3e-5, dedispersed=True, quiet=True, rng=rng)
    gt = GetTOAs([path], gmodel, quiet=True)
    gt.get_narrowband_TOAs(fit_scat=True, quiet=True)
    assert len(gt.TOA_list) == 16
    for toa in gt.TOA_list[4:12]:  # mid-band channels (best S/N)
        exp_us = 3e-5 * (toa.frequency / 1500.0) ** -4 * 1e6
        assert 0.3 * exp_us < toa.flags["scat_time"] < 3 * exp_us, \
            (toa.frequency, toa.flags["scat_time"], exp_us)


def test_fits_archive_as_model_template(workspace):
    """An aligned+averaged archive can serve directly as the model
    (reference pptoas.py:320-339 FITS-template path)."""
    ws, par, gmodel = workspace
    files, _ = _make_epochs(ws, par, gmodel, nfiles=2, nsub=2, noise=0.2)
    port_file = str(ws / "tmpl.port")
    align_archives(datafiles=files, initial_guess=files[0], tscrunch=True,
                   outfile=port_file, niter=1, quiet=True)
    gt = GetTOAs([files[0]], port_file, quiet=True)
    gt.get_TOAs(quiet=True)
    assert len(gt.TOA_list) == 2
    for toa in gt.TOA_list:
        assert toa.flags["gof"] < 2.0, toa.flags["gof"]


def test_align_final_transforms(workspace):
    """norm/place/smooth options of align_archives (ppalign.py:216-243)."""
    ws, par, gmodel = workspace
    files, _ = _make_epochs(ws, par, gmodel, nfiles=2, nsub=1, noise=0.2)
    out = str(ws / "placed.port")
    align_archives(datafiles=files, initial_guess=files[0], tscrunch=True,
                   outfile=out, niter=1, norm="max", place=0.5,
                   quiet=True)
    from pulseportraiture_tpu.io.psrfits import read_psrfits
    arch = read_psrfits(out)
    prof = arch.data[0, 0].mean(0)
    peak_phase = (np.argmax(prof) + 0.5) / len(prof)
    assert abs(peak_phase - 0.5) < 0.05, peak_phase
    # norm='max': every live channel peaks at ~1
    live = arch.weights[0] > 0
    maxes = arch.data[0, 0][live].max(-1)
    assert np.all(np.abs(maxes - 1.0) < 0.5), maxes


def test_fit_scat_with_scattered_gmodel_measures_total_tau(workspace):
    """When the .gmodel itself has nonzero TAU, fit_scat must measure
    the TOTAL scattering (model tau zeroed before fitting, reference
    pptoas.py:365-375), not convolve the kernel twice."""
    ws, par, gmodel = workspace
    # model with intrinsic tau = 20 us at 1500 MHz
    scat_gmodel = str(ws / "scat.gmodel")
    write_model(scat_gmodel, "S", "000", 1500.0,
                [0.0, 2e-5] + MODEL_PARAMS[2:],
                [1] * len(MODEL_PARAMS), -4.0, 0, quiet=True)
    rng = np.random.default_rng(21)
    path = str(ws / "scatdata.fits")
    make_fake_pulsar(scat_gmodel, par, outfile=path, nsub=1, npol=1,
                     nchan=32, nbin=256, nu0=1500.0, bw=800.0, tsub=60.0,
                     dDM=0.0, start_MJD=MJD(57202.0), noise_stds=0.2,
                     dedispersed=True, quiet=True, rng=rng)
    gt = GetTOAs([path], scat_gmodel, quiet=True)
    gt.get_TOAs(fit_scat=True, scat_guess=(2e-5, 1500.0, -4.0),
                quiet=True)
    toa = gt.TOA_list[0]
    # expected total tau ~ 20 us referenced near the fit frequency
    nu_tau = toa.flags["scat_ref_freq"]
    exp_us = 2e-5 * (nu_tau / 1500.0) ** -4 * 1e6
    assert 0.5 * exp_us < toa.flags["scat_time"] < 1.5 * exp_us, \
        (toa.flags["scat_time"], exp_us)
    assert toa.flags["gof"] < 2.0


def test_i2_native_ingest_matches_f32_path(workspace):
    """int16-native device ingest (GetTOAs uploads raw i2 + DAT_SCL)
    agrees with the dequantize-on-host f32 path on the same file: the
    dropped per-channel offsets only feed the DC harmonic, which
    F0_FACT zeroing discards."""
    ws, par, gmodel = workspace
    files, _ = _make_epochs(ws, par, gmodel, nfiles=2, nsub=2,
                            noise=0.3)
    d = load_data(files[0])
    assert getattr(d, "raw_i2", None) is not None    # i2 on disk
    gt_i2 = GetTOAs(files, gmodel, quiet=True)
    gt_i2.get_TOAs(quiet=True)
    os.environ["PP_I2"] = "0"
    try:
        gt_f = GetTOAs(files, gmodel, quiet=True)
        gt_f.get_TOAs(quiet=True)
    finally:
        del os.environ["PP_I2"]
    assert len(gt_i2.TOA_list) == len(gt_f.TOA_list) == 4
    for a, b in zip(gt_i2.TOA_list, gt_f.TOA_list):
        da = (a.MJD - b.MJD) * 1e6      # MJD.__sub__ is seconds -> us
        assert abs(da) < 0.05 * b.TOA_error, (da, b.TOA_error)
        assert abs(a.DM - b.DM) < 0.05 * b.DM_error


def test_zap_fast_path_flags_bad_channels_like_legacy(workspace):
    """get_channels_to_zap's fast path (per-channel red-chi2 from the
    fit epilogue, no archive re-read) flags an injected corrupted
    channel and agrees with the legacy reload+time-domain path on the
    high-S/N decisions.  Conventions: fast path is Fourier-domain with
    DC excluded (fitters/portrait.py channel_red_chi2); reference
    semantics pptoas.py:1208-1285."""
    ws, par, gmodel = workspace
    rng = np.random.default_rng(5)
    files, _ = _make_epochs(ws, par, gmodel, nfiles=1, nsub=2,
                            noise=0.3)
    # corrupt one channel with structured (low-harmonic) garbage: a
    # displaced pulse the model cannot fit.  (Broadband white garbage
    # would be absorbed into that channel's noise estimate and its
    # red-chi2 would correctly stay ~1.)
    from pulseportraiture_tpu.io.psrfits import read_psrfits, \
        write_psrfits
    arch = read_psrfits(files[0])
    bad_chan = 11
    nbin = arch.data.shape[-1]
    x = (np.arange(nbin) + 0.5) / nbin
    ghost = 8.0 * np.exp(-0.5 * ((x - 0.75) / 0.03) ** 2)
    arch.data[:, :, bad_chan] += ghost
    write_psrfits(files[0], arch, dtype="i2", quiet=True)

    gt = GetTOAs(files, gmodel, quiet=True)
    gt.get_TOAs(quiet=True)
    assert len(gt.fit_channel_red_chi2s[0]) == 2
    zaps_fast = [list(z) for z in gt.get_channels_to_zap(
        SNR_threshold=0.0, rchi2_threshold=1.5, show=False)[0]]
    for z in zaps_fast:
        assert bad_chan in z, (z, bad_chan)
    rchi2_fast = [np.asarray(r) for r in gt.channel_red_chi2s[0]]

    # legacy path: drop the stored epilogue values
    gt.fit_channel_red_chi2s = []
    zaps_legacy = [list(z) for z in gt.get_channels_to_zap(
        SNR_threshold=0.0, rchi2_threshold=1.5, show=False)[0]]
    for z in zaps_legacy:
        assert bad_chan in z, (z, bad_chan)
    rchi2_legacy = [np.asarray(r) for r in gt.channel_red_chi2s[0]]
    # the two chi2 conventions (Fourier/DC-less vs time-domain) agree
    # where it matters: same order of magnitude per channel, identical
    # flagging of the corrupted channel
    for rf, rl in zip(rchi2_fast, rchi2_legacy):
        ratio = rf / np.where(rl > 0, rl, 1.0)
        assert np.all((ratio > 0.5) & (ratio < 2.0)), (rf, rl)


def test_pipeline_harmonic_cap_f32_matches_uncapped(workspace):
    """The f32 pipeline's model-band harmonic cap (pipelines/toas.py
    mft prep + ops/ct_dft.band_cap_model_ft) leaves TOA phases and DMs
    within their statistical errors of the uncapped run.  x64 runs
    never cap (the cleaning floor is only below f32 noise)."""
    import os

    import jax

    ws, par, gmodel = workspace
    files, _ = _make_epochs(ws, par, gmodel, nfiles=2, nsub=2,
                            nchan=24, nbin=512, noise=0.3)
    assert jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        def run():
            gt = GetTOAs(files, gmodel, quiet=True)
            gt.get_TOAs(quiet=True)
            return gt.TOA_list

    # capped (default) vs uncapped
        toas_cap = run()
        os.environ["PP_MHARM"] = "0"
        try:
            toas_full = run()
        finally:
            os.environ.pop("PP_MHARM", None)
    finally:
        jax.config.update("jax_enable_x64", True)
    assert len(toas_cap) == len(toas_full) == 4
    # the two routes share the Newton loop but build the model FT
    # differently (host f64 rFFT, cleaned + f32-cast, vs in-fit f32
    # FFT), so agreement is bounded by f32 convergence noise (~5e-6
    # rot, same scale as test_parallel's tolerance) — observed max
    # 0.31 sigma; before the P-key cache fix this comparison was
    # vacuous (per-subint spin-down forked the model cache, so the
    # cap never actually applied and both runs were uncapped)
    for a, b in zip(toas_cap, toas_full):
        dt_us = abs(a.MJD - b.MJD) * 1e6          # MJD diff is seconds
        assert dt_us < 0.5 * b.TOA_error, (dt_us, b.TOA_error)
        assert abs(a.DM - b.DM) < 0.5 * b.DM_error


def test_mesh_campaign_matches_single_device(workspace, monkeypatch):
    """GetTOAs over a ('batch','chan') virtual mesh — int16-native
    ingest, on-device packed result (one fetch per chunk), and channel
    padding (nchan=22 on a 4-device chan axis) — yields the same TOAs
    as the single-device campaign."""
    import jax

    from pulseportraiture_tpu.parallel import mesh as pmesh

    ws, par, gmodel = workspace
    files, _ = _make_epochs(ws, par, gmodel, nfiles=2, nsub=2, nchan=22,
                            noise=0.3)
    assert jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    # the fixture model's band needs mharm ~ 50+, above the direct cap:
    # the pipeline must take the full-band shard_map route
    calls = []
    real_sharded = pmesh.fit_portrait_full_sharded

    def spy_sharded(*a, **k):
        calls.append((k.get("scales") is not None, k.get("packed")))
        return real_sharded(*a, **k)

    monkeypatch.setattr(pmesh, "fit_portrait_full_sharded", spy_sharded)
    monkeypatch.setattr(
        pmesh, "fit_portrait_full_sharded_direct",
        lambda *a, **k: pytest.fail("direct route for a wide model band"))
    try:
        gt_ref = GetTOAs(files, gmodel, quiet=True)
        gt_ref.get_TOAs(quiet=True)
        m = pmesh.make_mesh(n_batch=2, n_chan=4)
        gt_m = GetTOAs(files, gmodel, quiet=True)
        gt_m.get_TOAs(quiet=True, mesh=m)
    finally:
        jax.config.update("jax_enable_x64", True)
    # the sharded route ran, packed, with int16 scales live (the files
    # are i2 on disk; f32 fit dtype)
    assert calls and all(c == (True, True) for c in calls), calls
    assert len(gt_m.TOA_list) == len(gt_ref.TOA_list) == 4
    # the mesh sums the f32 setup reductions in a different order than
    # the single-device fit, so agreement is bounded by the f32
    # convergence noise (~5e-6 rot, same scale as test_parallel's
    # helper-level tolerance) — well inside the statistical error
    for a, b in zip(gt_m.TOA_list, gt_ref.TOA_list):
        da_us = abs(a.MJD - b.MJD) * 1e6     # MJD diff is seconds
        assert da_us < 0.5 * b.TOA_error, (da_us, b.TOA_error)
        assert abs(a.DM - b.DM) < 0.5 * b.DM_error
    # per-channel epilogue stats come back at TRUE nchan (the mesh
    # pad columns are stripped before assembly)
    for r in gt_m.fit_channel_red_chi2s[0]:
        assert len(np.asarray(r)) == 22


def test_mesh_campaign_direct_capped_route(workspace, monkeypatch):
    """A wide-duty-cycle template caps at mharm < 16, so the mesh
    campaign must dispatch the DIRECT capped setup (one GSPMD jit over
    setup + seed + Newton; shard-local i2 dequantize; packed fetch) and
    agree with the single-device run (the multi-chip route through the
    pipeline, not just the fit helper)."""
    import jax

    from pulseportraiture_tpu.ops.ct_dft import DIRECT_MHARM_MAX
    from pulseportraiture_tpu.parallel import mesh as pmesh

    ws, par, _ = workspace
    wide = str(ws / "wide.gmodel")
    write_model(wide, "TESTW", "000", 1500.0,
                [0.0, 0.0, 0.40, 0.0, 0.20, 0.0, 5.0, 0.0],
                [1] * 8, -4.0, 0, quiet=True)
    files, _ = _make_epochs(ws, par, wide, nfiles=1, nsub=2, nchan=22,
                            noise=0.3)
    assert jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    calls = []
    real_direct = pmesh.fit_portrait_full_sharded_direct

    def spy_direct(*a, **k):
        calls.append((k.get("mharm"), k.get("scales") is not None,
                      k.get("packed")))
        return real_direct(*a, **k)

    monkeypatch.setattr(pmesh, "fit_portrait_full_sharded_direct",
                        spy_direct)
    try:
        gt_ref = GetTOAs(files, wide, quiet=True)
        gt_ref.get_TOAs(quiet=True)
        m = pmesh.make_mesh(n_batch=2, n_chan=4)
        gt_m = GetTOAs(files, wide, quiet=True)
        gt_m.get_TOAs(quiet=True, mesh=m)
    finally:
        jax.config.update("jax_enable_x64", True)
    assert calls, "direct capped route did not dispatch"
    for mh, has_scales, packed in calls:
        assert mh is not None and mh < DIRECT_MHARM_MAX and has_scales \
            and packed, calls
    assert len(gt_m.TOA_list) == len(gt_ref.TOA_list) == 2
    for a, b in zip(gt_m.TOA_list, gt_ref.TOA_list):
        da_us = abs(a.MJD - b.MJD) * 1e6
        assert da_us < 0.2 * b.TOA_error, (da_us, b.TOA_error)
        assert abs(a.DM - b.DM) < 0.2 * b.DM_error
