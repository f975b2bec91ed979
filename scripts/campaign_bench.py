#!/usr/bin/env python
"""End-to-end campaign benchmark: archives on disk -> .tim file.

Measures the full production path (native-I/O load, host prep with f64
base rotation, chunked cross-archive batched fits, TOA assembly), unlike
bench.py which times the device fit kernel alone.

Usage:
  python scripts/campaign_bench.py [--narchive 50] [--nsub 4]
      [--nchan 128] [--nbin 512] [--chunk 256]

Needs an accelerator.  The archives are generated, outside the timed
window, by a child process pinned to the CPU, so that only this process
opens the card.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

ap = argparse.ArgumentParser()
ap.add_argument("--narchive", type=int, default=50)
ap.add_argument("--nsub", type=int, default=4)
ap.add_argument("--nchan", type=int, default=128)
ap.add_argument("--nbin", type=int, default=512)
ap.add_argument("--chunk", type=int, default=256)
ap.add_argument("--keep", action="store_true")
ap.add_argument("--workdir", default=None,
                help="reuse this workspace (skip generation if the "
                     "archives already exist)")
ap.add_argument("--skip-warm", action="store_true")
args = ap.parse_args()
os.environ["PP_FIT_CHUNK"] = str(args.chunk)

import jax

from pulseportraiture_tpu.utils import (card_report, require_accelerator,
                                        use_compile_cache)

dev = require_accelerator()
use_compile_cache()
print(card_report(), flush=True)
DEVICE = {"platform": dev.platform, "kind": dev.device_kind,
          "count": len(jax.devices())}

import numpy as np

from pulseportraiture_tpu import GetTOAs, write_TOAs
from pulseportraiture_tpu.io.mjd import MJD
from pulseportraiture_tpu.models.gmodel_io import write_model
from pulseportraiture_tpu.sim.fake import make_fake_pulsar

work = args.workdir or tempfile.mkdtemp(prefix="pp_campaign_")
os.makedirs(work, exist_ok=True)
print(f"workspace: {work}; device: {DEVICE}", flush=True)
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
if not all(os.path.exists(f) for f in files):
    # archive synthesis runs in a child pinned to the CPU: only this
    # process opens the card
    t0 = time.time()
    gen = subprocess.run(
        [sys.executable, "-u", "-c", f"""
import sys; sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
import numpy as np
from pulseportraiture_tpu.io.mjd import MJD
from pulseportraiture_tpu.sim.fake import make_fake_pulsar
rng = np.random.default_rng(0)
dDMs = rng.normal(3e-4, 2e-4, {args.narchive})
for i in range({args.narchive}):
    make_fake_pulsar({gmodel!r}, {par!r},
                     outfile={work!r} + "/c%04d.fits" % i,
                     nsub={args.nsub}, npol=1, nchan={args.nchan},
                     nbin={args.nbin}, nu0=1500.0, bw=800.0, tsub=60.0,
                     dDM=dDMs[i], start_MJD=MJD(57000.0 + 2.0 * i),
                     noise_stds=0.5, dedispersed=False, quiet=True,
                     rng=rng)
print("gen done")
"""], capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert "gen done" in gen.stdout, gen.stderr[-2000:]
    print(f"generated {args.narchive} archives in "
          f"{time.time() - t0:.1f}s", flush=True)
else:
    print("reusing existing archives", flush=True)

# warm pass (compiles the bucketed batch shapes; persistent cache
# makes later processes skip this too)
if not args.skip_warm:
    gt0 = GetTOAs(files, gmodel, quiet=True)
    gt0.get_TOAs(quiet=True)

t0 = time.time()
gt = GetTOAs(files, gmodel, quiet=True)
gt.get_TOAs(quiet=True)
write_TOAs(gt.TOA_list, outfile=os.path.join(work, "campaign.tim"),
           append=False)
t_run = time.time() - t0
ntoa = len(gt.TOA_list)
resid = np.asarray(gt.DeltaDM_means) - dDMs[:len(gt.DeltaDM_means)]
print(json.dumps({
    "metric": f"end-to-end wideband TOAs/sec ({args.nchan}ch x "
              f"{args.nbin}bin, {args.narchive} archives x {args.nsub} "
              "subints, load->fit->tim)",
    "value": round(ntoa / t_run, 2),
    "unit": "TOAs/sec",
    "extra": {"ntoa": ntoa, "wall_s": round(t_run, 2),
              "fit_s": round(sum(gt.fit_durations), 2),
              "max_abs_dDM_resid": float(np.abs(resid).max())},
    "device": DEVICE,
}), flush=True)
if not args.keep and args.workdir is None:
    shutil.rmtree(work, ignore_errors=True)
