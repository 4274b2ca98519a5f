"""Moving-receiver PVT acceptance: the user-motion path carried through
the full chain.

The reference advertises dynamic operation two ways — a `-u` user-motion
file (advertised but unimplemented, SURVEY §Quirks / main.cpp:216) and
live UDP 7533 position updates consumed each epoch
(src/galileo-sdr.cpp:443).  This repo implements both; existing tests
pin the Doppler response (test_baseline_configs config 4) and the live
closed loop at the sample level.  This test closes the remaining gap:
a receiver moving at constant velocity for the whole scene must still
acquire, track, decode, and fix — and the fix must land at the position
the transmitter used at the measurement instant, not at the scene start.

A correlated transmit-side error in the motion path (e.g. position
picked up but pseudoranges computed from a stale epoch, or a Doppler
sign error that only cancels for a static user) would shift or smear
the fix by the travel distance (~370 m here) and fail loudly.
"""

import numpy as np
import pytest

from galileo_sdr_sim_tpu import geodesy
from galileo_sdr_sim_tpu.constants import (
    EPOCH_DT,
    NUM_IQ_SAMPLES,
    R2D,
    SAMP_RATE,
)
from galileo_sdr_sim_tpu.rx_pvt import receiver_fix
from galileo_sdr_sim_tpu.rx_track import iq_to_complex

from conftest import PVT_STATIC

V_EAST = 20.0  # m/s, ~72 km/h — brisk vehicle speed
DUR_S = 19.0
R_E = 6378137.0  # WGS-84 semi-major axis


@pytest.fixture(scope="module")
def motion_scene(nav):
    """Same 18.4+ s scene as conftest.pvt_scene (every ephemeris word
    type on air), but the receiver drives east at 20 m/s throughout."""
    from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
    from galileo_sdr_sim_tpu.ops.synth_kp import synth_batch_kp_host
    from galileo_sdr_sim_tpu.scenario import (
        PositionProvider,
        ScenarioEngine,
        scenario_start_time,
    )

    lat0, lon0, hgt = PVT_STATIC
    n_epochs = int(DUR_S * 10) + 2
    t = EPOCH_DT * np.arange(n_epochs)
    dlon_per_m = R2D / (R_E * np.cos(lat0 / R2D))
    traj = np.stack(
        [
            np.full(n_epochs, lat0),
            lon0 + V_EAST * t * dlon_per_m,
            np.full(n_epochs, hgt),
        ],
        axis=1,
    )
    g0 = scenario_start_time(nav, date2gal(DateTime(2022, 2, 20, 8, 0, 18)))
    eng = ScenarioEngine(
        nav, PositionProvider(trajectory=traj), g0, duration_s=DUR_S
    )
    iq = []
    for batch in eng.batches(8):
        if batch.f_code.shape[0] != 8:
            break  # keep one compile (see conftest.pvt_scene)
        iq.append(synth_batch_kp_host(batch, NUM_IQ_SAMPLES))
    assert len(iq) * 8 * 0.1 >= 18.0, f"scene too short: {len(iq) * 0.8:.1f} s"
    x16 = np.concatenate(iq).reshape(-1).astype(np.int16)
    return traj, x16


@pytest.fixture(scope="module")
def motion_fix(motion_scene):
    _, x16 = motion_scene
    return receiver_fix(iq_to_complex(x16))


def test_moving_receiver_fixes_at_motion_position(motion_scene, motion_fix):
    traj, x16 = motion_scene
    fix = motion_fix
    assert fix is not None, "moving receiver did not produce a fix"
    sol = fix.solution
    assert sol.n_sats >= 5, sol.prns

    # truth = the trajectory position the transmitter used at the
    # measurement sample's epoch (position pickup is per 0.1 s epoch,
    # like the reference's llhr memcpy at galileo-sdr.cpp:443)
    n_meas = 0.5 * (len(x16) // 2)
    epoch = int(n_meas // NUM_IQ_SAMPLES)
    llh = traj[epoch]
    truth = geodesy.llh2xyz(np.array([llh[0] / R2D, llh[1] / R2D, llh[2]]))
    err = np.linalg.norm(sol.xyz - truth)
    assert err < 30.0, f"moving fix error {err:.1f} m (prns {sol.prns})"

    # and the fix must NOT be at the scene-start position: the receiver
    # has genuinely followed ~185 m of travel by mid-scene
    start = geodesy.llh2xyz(
        np.array([traj[0][0] / R2D, traj[0][1] / R2D, traj[0][2]])
    )
    moved = np.linalg.norm(truth - start)
    err_from_start = np.linalg.norm(sol.xyz - start)
    assert moved > 150.0  # scene sanity
    assert err_from_start > moved - 30.0, (
        f"fix stuck near scene start ({err_from_start:.1f} m of "
        f"{moved:.1f} m traveled)"
    )


def test_moving_receiver_time_recovered(nav, motion_scene, motion_fix):
    """Receive-time recovery holds under motion too (µs-level)."""
    from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
    from galileo_sdr_sim_tpu.scenario import scenario_start_time

    traj, x16 = motion_scene
    fix = motion_fix
    g0 = scenario_start_time(nav, date2gal(DateTime(2022, 2, 20, 8, 0, 18)))
    n_meas = 0.5 * (len(x16) // 2)
    t_true = g0.sec + 2 * EPOCH_DT + n_meas / SAMP_RATE
    assert abs(fix.solution.t_rx - t_true) < 1e-5
