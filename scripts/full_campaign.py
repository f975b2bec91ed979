#!/usr/bin/env python
"""The BASELINE.json full-scale campaign: 1000 epochs x 4096ch x 2048bin
with ppalign template averaging and ppzap channel flagging.

Flow (BASELINE.json config 5; reference workflow pptoas.py:18-23's
~1000-file runs):
  1. synthesize N single-subint epochs with injected per-epoch dDMs
     (CPU subprocess; reused across runs via --workdir)
  2. ppalign: align + average the first --ntmpl epochs into a template
     archive (pipelines/align.align_archives)
  3. pptoas: GetTOAs over ALL epochs against that template (streamed
     load -> chunked batched device fits -> incremental assembly)
  4. ppzap: post-fit chi2 channel flagging (get_channels_to_zap)
  5. report TOAs/s + dDM-recovery accuracy vs the injected values

Needs an accelerator; generation runs in children pinned to the CPU, so
that only this process opens the card.  Prints ONE JSON line.  Scale
down with --narchive/--nchan/--nbin for smoke runs; the official
configuration is the default.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

ap = argparse.ArgumentParser()
ap.add_argument("--narchive", type=int, default=1000)
ap.add_argument("--ntmpl", type=int, default=16,
                help="epochs averaged into the ppalign template")
ap.add_argument("--nchan", type=int, default=4096)
ap.add_argument("--nbin", type=int, default=2048)
ap.add_argument("--workdir", default=None,
                help="workspace, reused across runs (default: a new "
                "temporary directory)")
ap.add_argument("--gen-only", action="store_true")
ap.add_argument("--spline", action="store_true",
                help="insert the ppspline smoothing stage: build a .spl "
                "model from the averaged template and fit against that "
                "(the reference's production flow — a raw averaged "
                "archive carries its own noise into every epoch's fit; "
                "see BASELINE.md template-noise analysis)")
args = ap.parse_args()

import jax

from pulseportraiture_tpu.utils import (card_report, require_accelerator,
                                        use_compile_cache)

dev = require_accelerator()
use_compile_cache()
print(card_report(), flush=True)
DEVICE = {"platform": dev.platform, "kind": dev.device_kind,
          "count": len(jax.devices())}

import numpy as np

work = args.workdir or tempfile.mkdtemp(prefix="pp_full_campaign_")
os.makedirs(work, exist_ok=True)
print(f"workspace: {work}; device: {DEVICE}", flush=True)

from pulseportraiture_tpu import GetTOAs, write_TOAs  # noqa: E402
from pulseportraiture_tpu.models.gmodel_io import write_model  # noqa: E402

gmodel = os.path.join(work, "c.gmodel")
write_model(gmodel, "C", "000", 1500.0,
            [0.0, 0.0, 0.2193, -0.0052, 0.0482, -2.08, 5.13, -1.66,
             0.2341, -0.0027, 0.0157, 1.615, 9.46, -2.08],
            [1] * 14, -4.0, 0, quiet=True)
par = os.path.join(work, "c.par")
with open(par, "w") as f:
    f.write("PSR J0000+00\nRAJ 00:01:02\nDECJ 03:04:05\n"
            "F0 345.678901234\nPEPOCH 50000\nDM 34.5678\n")

rng = np.random.default_rng(0)
dDMs = rng.normal(3e-4, 2e-4, args.narchive)
files = [os.path.join(work, f"c{i:04d}.fits")
         for i in range(args.narchive)]
missing = [i for i, f in enumerate(files) if not os.path.exists(f)]
if missing:
    t0 = time.time()
    # generation in CPU subprocesses, a slice at a time so a partial
    # run resumes where it stopped
    CH = 50
    for lo in range(0, len(missing), CH):
        idxs = missing[lo:lo + CH]
        code = f"""
import sys; sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
import numpy as np
from pulseportraiture_tpu.io.mjd import MJD
from pulseportraiture_tpu.sim.fake import make_fake_pulsar
rng = np.random.default_rng(0)
dDMs = rng.normal(3e-4, 2e-4, {args.narchive})
for i in {idxs!r}:
    make_fake_pulsar({gmodel!r}, {par!r},
                     outfile={work!r} + "/c%04d.fits" % i,
                     nsub=1, npol=1, nchan={args.nchan},
                     nbin={args.nbin}, nu0=1500.0, bw=800.0, tsub=300.0,
                     dDM=dDMs[i], start_MJD=MJD(57000.0 + 2.0 * i),
                     noise_stds=0.5, dedispersed=False, quiet=True,
                     rng=np.random.default_rng(1000 + i))
print("gen chunk done")
"""
        gen = subprocess.run([sys.executable, "-u", "-c", code],
                             capture_output=True, text=True,
                             env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert "gen chunk done" in gen.stdout, gen.stderr[-2000:]
        print(f"  generated {min(lo + CH, len(missing))}/{len(missing)} "
              f"missing archives ({time.time() - t0:.0f}s)", flush=True)
    print(f"generation: {time.time() - t0:.1f}s", flush=True)
else:
    print("reusing existing archives", flush=True)
if args.gen_only:
    sys.exit(0)

# ---- ppalign: template from the first ntmpl epochs ----
from pulseportraiture_tpu.pipelines.align import align_archives  # noqa

tmpl = os.path.join(work, "template.fits")
t_align0 = time.time()
if not os.path.exists(tmpl):
    align_archives(datafiles=files[:args.ntmpl], outfile=tmpl,
                   niter=1, quiet=True)
t_align = time.time() - t_align0
print(f"ppalign template ({args.ntmpl} epochs): {t_align:.1f}s",
      flush=True)

# ---- optional ppspline smoothing stage ----
t_spline = 0.0
model_for_toas = tmpl
suffix = ""
if args.spline:
    from pulseportraiture_tpu.portrait import DataPortrait  # noqa: E402
    spl = os.path.join(work, "template.spl")
    t_s0 = time.time()
    if not os.path.exists(spl):
        dp = DataPortrait(tmpl, quiet=True)
        dp.normalize_portrait("prof")
        dp.make_spline_model(max_ncomp=10, smooth=True,
                             snr_cutoff=150.0, quiet=True)
        dp.write_model(spl, quiet=True)
    t_spline = time.time() - t_s0
    print(f"ppspline model: {t_spline:.1f}s", flush=True)
    model_for_toas = spl
    suffix = "_spline"

# ---- pptoas over the full campaign, in resumable slices ----
# A 1000-epoch x 4096ch x 2048bin run moves ~17 GB of i2 samples to
# the device; slicing gives progress visibility and lets a killed run
# resume where it stopped (state + per-slice .tim appended under
# workdir).  The reference itself chunks big runs this way
# (max_nfile=999 cfitsio workaround, pptoas.py:18-23).
state_path = os.path.join(work, f"campaign_state{suffix}.json")
# 128 = two exact 64-item stream chunks per slice: no tail padding
# (power-of-two bucketing pads ragged tails with duplicate lanes)
SL = int(os.environ.get("PP_CAMPAIGN_SLICE", "128"))
state = {"slice": SL, "slices": {}}
if os.path.exists(state_path):
    with open(state_path) as f:
        prev = json.load(f)
    if prev.get("slice") == SL:
        state = prev
    else:
        print(f"slice size changed ({prev.get('slice')} -> {SL}); "
              "restarting TOA stage", flush=True)

tim_path = os.path.join(work, f"campaign{suffix}.tim")
dd_all, err_all, nzap = [], [], 0
t_run = 0.0
t_zap = 0.0
ntoa = 0
for lo in range(0, len(files), SL):
    key = str(lo)
    if key in state["slices"]:
        rec = state["slices"][key]
        dd_all += rec["dd"]
        err_all += rec["err"]
        ntoa += rec["ntoa"]
        t_run += rec["t_run"]
        t_zap += rec["t_zap"]
        nzap += rec["nzap"]
        print(f"slice {lo}: reused ({rec['ntoa']} TOAs, "
              f"{rec['t_run']:.0f}s)", flush=True)
        continue
    t0 = time.time()
    gt = GetTOAs(files[lo:lo + SL], model_for_toas, quiet=True)
    gt.get_TOAs(quiet=True)
    write_TOAs(gt.TOA_list, outfile=tim_path, append=(lo > 0))
    t_sl = time.time() - t0
    # ppzap: post-fit chi2 channel flagging on this slice
    t_z0 = time.time()
    gt.get_channels_to_zap(SNR_threshold=8.0, rchi2_threshold=1.3,
                           show=False)
    nz = sum(len(ch) for arch in getattr(gt, "zap_channels", [])
             for ch in arch)
    t_z = time.time() - t_z0
    rec = {"dd": [float(x) for x in gt.DeltaDM_means],
           "err": [float(x) for x in gt.DeltaDM_errs],
           "ntoa": len(gt.TOA_list), "t_run": t_sl, "t_zap": t_z,
           "nzap": int(nz),
           # per-stage breakdown (pipelines/toas.py fit_timing): CPU-
           # attributed costs; load overlaps the rest on the prefetch
           # thread, so buckets need not sum to t_run — a slow slice is
           # diagnosable as host-load vs upload vs device vs assembly
           "timing": {k: round(v, 2) for k, v in
                      getattr(gt, "fit_timing", {}).items()}}
    state["slices"][key] = rec
    with open(state_path, "w") as f:
        json.dump(state, f)
    dd_all += rec["dd"]
    err_all += rec["err"]
    ntoa += rec["ntoa"]
    t_run += t_sl
    t_zap += t_z
    nzap += nz
    print(f"slice {lo}..{min(lo + SL, len(files))}: "
          f"{rec['ntoa']} TOAs in {t_sl:.0f}s "
          f"({rec['ntoa'] / t_sl:.1f} TOAs/s), zap {t_z:.0f}s",
          flush=True)

# accuracy: fitted DeltaDM means vs injected dDMs (the template carries
# the aligned epochs' mean dDM, so compare against the injected values
# relative to their mean over the template subset)
dd = np.asarray(dd_all)
resid = dd - dDMs[:len(dd)]
resid = resid - np.median(resid)        # template zero-point
err = np.asarray(err_all)
frac_5sig = float(np.mean(np.abs(resid) <= 5.0 * err + 1e-9))
# chi_rms = rms(resid/err): ~1 when the fit errors describe the
# scatter.  Reported overall AND on non-template epochs only — the
# first ntmpl epochs' noise is inside the template, which correlates
# their residuals (BASELINE.md template-noise analysis).
chi = resid / np.where(err > 0, err, np.inf)
chi_rms = float(np.sqrt(np.mean(chi ** 2)))
chi_nt = chi[args.ntmpl:]
chi_rms_nontmpl = float(np.sqrt(np.mean(chi_nt ** 2))) if len(chi_nt) \
    else float("nan")
print(json.dumps({
    "metric": f"full campaign TOAs/sec ({args.narchive} epochs x "
              f"{args.nchan}ch x {args.nbin}bin, "
              f"ppalign+{'ppspline+' if args.spline else ''}pptoas+ppzap)",
    "value": round(ntoa / t_run, 2),
    "unit": "TOAs/sec",
    "extra": {"ntoa": ntoa, "wall_s": round(t_run, 1),
              "align_s": round(t_align, 1), "spline_s": round(t_spline, 1),
              "zap_s": round(t_zap, 1),
              "nzap_channels": int(nzap),
              "dDM_resid_rms": float(np.sqrt(np.mean(resid ** 2))),
              "dDM_resid_within_5sigma": frac_5sig,
              "chi_rms": round(chi_rms, 3),
              "chi_rms_nontemplate": round(chi_rms_nontmpl, 3)},
    "device": DEVICE,
}), flush=True)
