#!/usr/bin/env python3
"""Probe: receiver chain vs calibrated AWGN (C/N0 sweep).

Synthesizes the 19 s PVT scene once (CPU XLA engine), then for each
C/N0 runs the full receiver chain and reports fix error / stage
failures.  Guides the rx hardening for noise (VERDICT round-2 item 2).

Usage: JAX_PLATFORMS=cpu python tools/probe_noise_rx.py [cn0 ...]
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from galileo_sdr_sim_tpu import geodesy
from galileo_sdr_sim_tpu.constants import NUM_IQ_SAMPLES, R2D
from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
from galileo_sdr_sim_tpu.noise import add_awgn
from galileo_sdr_sim_tpu.ops.synth_kp import synth_batch_kp_host
from galileo_sdr_sim_tpu.rinex import NAV_FILE, read_rinex_v3
from galileo_sdr_sim_tpu.rx_pvt import receiver_fix
from galileo_sdr_sim_tpu.rx_track import acquire, iq_to_complex
from galileo_sdr_sim_tpu.scenario import (
    PositionProvider,
    ScenarioEngine,
    scenario_start_time,
)

STATIC = np.array([42.3601, -71.0589, 100.0])

nav = read_rinex_v3(NAV_FILE)
g0 = scenario_start_time(nav, date2gal(DateTime(2022, 2, 20, 8, 0, 18)))
eng = ScenarioEngine(nav, PositionProvider(llh_deg=STATIC), g0, duration_s=19.0)
iq = []
t0 = time.time()
for batch in eng.batches(8):
    if batch.f_code.shape[0] != 8:
        break
    iq.append(synth_batch_kp_host(batch, NUM_IQ_SAMPLES))
x16 = np.concatenate(iq).reshape(-1).astype(np.int16)
print(f"scene: {len(iq) * 0.8:.1f} s in {time.time() - t0:.0f} s wall", flush=True)
truth = geodesy.llh2xyz(np.array([STATIC[0] / R2D, STATIC[1] / R2D, STATIC[2]]))

present = sorted(c.prn for c in eng.bank.channels if c.prn > 0)
print("present PRNs:", present, flush=True)

for cn0 in [float(v) for v in sys.argv[1:]] or [45.0, 42.0, 40.0, 38.0]:
    xn = add_awgn(x16, cn0, rng=1234)
    x = iq_to_complex(xn)
    t0 = time.time()
    # acquisition detail on present + a few absent PRNs
    mets = {}
    for prn in present + [6, 17]:
        a = acquire(x, prn, n_noncoh=8)
        mets[prn] = round(a.metric, 1)
    print(f"[{cn0} dB-Hz] acq metrics (M=8): {mets}", flush=True)
    fix = receiver_fix(x, n_noncoh=8)
    if fix is None:
        print(f"[{cn0} dB-Hz] NO FIX ({time.time()-t0:.0f} s)", flush=True)
        continue
    err = np.linalg.norm(fix.solution.xyz - truth)
    print(
        f"[{cn0} dB-Hz] fix err {err:.2f} m, {fix.solution.n_sats} sats "
        f"{fix.solution.prns}, resid max {np.abs(fix.solution.residuals).max():.2f} "
        f"({time.time()-t0:.0f} s)",
        flush=True,
    )
