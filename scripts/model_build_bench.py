#!/usr/bin/env python
"""Model-build wall time at campaign scale (VERDICT r2 #9).

Times the two model builders on an averaged archive:
  - ppspline: DataPortrait.make_spline_model (PCA -> smart_smooth ->
    B-spline over the mean-subtracted eigenprofiles; ppspline.py:24-232)
  - ppgauss: DataPortrait.make_gaussian_model, one iteration
    (ppgauss.py:19-372)

Usage: python scripts/model_build_bench.py [--nchan 4096] [--nbin 2048]
          [--archive path.fits]
Needs an accelerator.  Prints one JSON line per builder.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

ap = argparse.ArgumentParser()
ap.add_argument("--nchan", type=int, default=4096)
ap.add_argument("--nbin", type=int, default=2048)
ap.add_argument("--archive", default=None,
                help="use this averaged archive instead of synthesizing")
ap.add_argument("--gauss", action="store_true",
                help="also time make_gaussian_model (slow at 4096ch)")
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

from pulseportraiture_tpu.models.gmodel_io import write_model
from pulseportraiture_tpu.portrait import DataPortrait
from pulseportraiture_tpu.sim.fake import make_fake_pulsar

if args.archive:
    path = args.archive
else:
    work = tempfile.mkdtemp(prefix="pp_modelbuild_")
    gmodel = os.path.join(work, "m.gmodel")
    write_model(gmodel, "M", "000", 1500.0,
                [0.0, 0.0, 0.2193, -0.0052, 0.0482, -2.08, 5.13, -1.66,
                 0.2341, -0.0027, 0.0157, 1.615, 9.46, -2.08],
                [1] * 14, -4.0, 0, quiet=True)
    par = os.path.join(work, "m.par")
    with open(par, "w") as f:
        f.write("PSR J0000+00\nRAJ 00:01:02\nDECJ 03:04:05\n"
                "F0 345.678901234\nPEPOCH 50000\nDM 34.5678\n")
    path = os.path.join(work, "avg.fits")
    t0 = time.time()
    make_fake_pulsar(gmodel, par, outfile=path, nsub=1, npol=1,
                     nchan=args.nchan, nbin=args.nbin, nu0=1500.0,
                     bw=800.0, tsub=1800.0, noise_stds=0.05,
                     dedispersed=True, quiet=True,
                     rng=np.random.default_rng(7))
    print(f"synthesized averaged archive in {time.time() - t0:.1f}s",
          flush=True)


# ---- ppspline ----
dp = DataPortrait(path, quiet=True)
t0 = time.time()
dp.make_spline_model(max_ncomp=10, smooth=True, snr_cutoff=150.0,
                     quiet=True)
t_spline = time.time() - t0
dp.write_model(path + ".spl", quiet=True)
print(json.dumps({
    "metric": f"ppspline model build wall time ({args.nchan}ch x "
              f"{args.nbin}bin)",
    "value": round(t_spline, 2), "unit": "s", "device": DEVICE}),
    flush=True)

# ---- ppgauss (one iteration) ----
if args.gauss:
    dp2 = DataPortrait(path, quiet=True)
    t0 = time.time()
    dp2.make_gaussian_model(ngauss=3, niter=1, writemodel=False,
                            quiet=True)
    t_gauss = time.time() - t0
    print(json.dumps({
        "metric": f"ppgauss model build wall time, 1 iter "
                  f"({args.nchan}ch x {args.nbin}bin)",
        "value": round(t_gauss, 2), "unit": "s", "device": DEVICE}),
        flush=True)
