"""BASELINE.md configuration matrix — one integration test per supported
configuration (BASELINE.md "Configs to support" 1-5), plus the
long-duration soak and the live-position latency guarantee.

Reference behaviors pinned here:
* config 1: the README's canonical static file-sink run
  (upstream README.md:49-60: `-l -6,51,100 -e <rinex> -U 1 -b 1`).
* config 2: all visible SVs of 20feb2022.rnx allocated at the tv/
  capture epoch (src/channel.cpp:21-119 allocation over MAX_SAT).
* config 3: live I/NAV generation under `-T` TOC/TOE overwrite
  (src/gnss-time.cpp:101-137; our overwrite is effective, the
  reference's is a no-op — SURVEY Quirks).
* config 4: dynamic user motion with per-epoch Doppler updates
  (`-u`, advertised in the reference but unimplemented there).
* config 5: long-duration streaming (STATIC_MAX_DURATION=86400,
  include/constants.h:18) — soak gated behind GALILEO_SOAK=1 because it
  synthesizes >= 600 s of signal at full rate (see test docstring for
  the invocation; results recorded in docs/soak.md).
* live latency: a UDP 7533 position update must land in the NEXT 0.1 s
  epoch's observables (src/galileo-sdr.cpp:443 reads llhr every epoch).
"""

import os
import socket
import time

import numpy as np
import pytest

from galileo_sdr_sim_tpu.constants import NUM_IQ_SAMPLES
from galileo_sdr_sim_tpu.rinex import NAV_FILE
from galileo_sdr_sim_tpu.scenario import PositionProvider, ScenarioEngine

RINEX = str(NAV_FILE)
STATIC = np.array([42.3601, -71.0589, 100.0])


# --------------------------------------------------------------------
# Config 1: static file-sink run at the README's example location
# --------------------------------------------------------------------
def test_config1_static_file_sink(tmp_path):
    from galileo_sdr_sim_tpu.cli import main

    out = tmp_path / "c1.ishort"
    rc = main([
        "-e", RINEX, "-l", "-6,51,100", "-t", "2022/02/20,08:00:01",
        "-d", "0.5", "-U", "1", "-b", "1", "-o", str(out),
        "--block-epochs", "2",
    ])
    assert rc == 0
    data = np.fromfile(out, dtype=np.int16)
    assert data.size == 4 * NUM_IQ_SAMPLES * 2
    assert np.any(data != 0)


# --------------------------------------------------------------------
# Config 2: all-visible-SV static scene at the tv/ capture epoch
# --------------------------------------------------------------------
def test_config2_all_visible_svs_allocated(nav, g0):
    from galileo_sdr_sim_tpu import geodesy
    from galileo_sdr_sim_tpu.channels import check_visibility
    from galileo_sdr_sim_tpu.constants import EPOCH_DT, MAX_SAT, R2D

    eng = ScenarioEngine(
        nav, PositionProvider(llh_deg=STATIC), g0, duration_s=1.0
    )
    allocated = {c.prn for c in eng.bank.channels if c.prn > 0}

    # oracle: every SV with a matching ephemeris and elevation > 10 deg
    # at the allocation epoch (g0 + dt) must hold a channel
    xyz = geodesy.llh2xyz(
        np.array([STATIC[0] / R2D, STATIC[1] / R2D, STATIC[2]])
    )
    t_alloc = g0 + EPOCH_DT
    visible = set()
    for sv in range(MAX_SAT):
        idx = nav.epoch_match(sv, g0)
        if idx < 0:
            continue
        vis, _ = check_visibility(nav.eph[sv][idx], t_alloc, xyz, 10.0)
        if vis:
            visible.add(sv + 1)
    assert allocated == visible
    assert len(allocated) >= 4  # enough for a PVT fix

    # each allocated channel carries a live page (config 2 pairs the
    # scene with tv/ golden messages; bit-exactness of those pages vs
    # the compiled reference encoder is pinned in test_inav_ref_ab.py)
    for c in eng.bank.channels:
        if c.prn > 0:
            assert c.page is not None and len(c.page) == 500


# --------------------------------------------------------------------
# Config 3: live I/NAV generation under -T TOC/TOE overwrite
# --------------------------------------------------------------------
def test_config3_time_overwrite_cli(tmp_path):
    from galileo_sdr_sim_tpu.cli import main

    out = tmp_path / "c3.ishort"
    rc = main([
        "-e", RINEX, "-l", "42.3601,-71.0589,100",
        "-T", "2022/02/21,10:00:00", "-d", "0.4", "-U", "1", "-b", "1",
        "-o", str(out), "--block-epochs", "2",
    ])
    assert rc == 0
    data = np.fromfile(out, dtype=np.int16)
    assert data.size == 3 * NUM_IQ_SAMPLES * 2
    assert np.any(data != 0)


# --------------------------------------------------------------------
# Config 4: dynamic user motion -> per-epoch Doppler updates
# --------------------------------------------------------------------
def test_config4_user_motion_updates_doppler(nav, g0):
    # a receiver moving east at ~75 m/s vs static: Doppler must diverge
    # across epochs while the static engine's stays put
    lat, lon, hgt = STATIC
    steps = 12
    traj = np.stack([
        np.full(steps, lat),
        lon + np.arange(steps) * 1e-4,  # ~8.3 m/epoch eastward
        np.full(steps, hgt),
    ], axis=1)
    eng_m = ScenarioEngine(
        nav, PositionProvider(trajectory=traj), g0, duration_s=1.0
    )
    eng_s = ScenarioEngine(
        nav, PositionProvider(llh_deg=STATIC), g0, duration_s=1.0
    )
    tabs_m = list(eng_m.epochs())
    tabs_s = list(eng_s.epochs())
    active = tabs_m[0].prn > 0
    assert np.array_equal(tabs_m[0].prn, tabs_s[0].prn)
    # motion-induced Doppler: ~82 m/s eastward projects to O(100) Hz on
    # E1 for every visible satellite, present in every emitted epoch
    for tm, ts in zip(tabs_m, tabs_s):
        d = np.abs(tm.f_carr - ts.f_carr)[active]
        assert np.all(d > 10.0), d
    # and the receiver genuinely moves: code phase diverges over the run
    d0 = np.abs(tabs_m[0].code_phase0 - tabs_s[0].code_phase0)[active]
    d9 = np.abs(tabs_m[-1].code_phase0 - tabs_s[-1].code_phase0)[active]
    assert np.median(d9) > np.median(d0)


# --------------------------------------------------------------------
# Config 5: long-duration streaming soak (gated: >= 600 s of signal)
# --------------------------------------------------------------------
@pytest.mark.skipif(
    not os.environ.get("GALILEO_SOAK"),
    reason="soak synthesizes >= 600 s of signal; run with GALILEO_SOAK=1 "
    "(evidence from the last run is recorded in docs/soak.md)",
)
def test_config5_soak_600s_stream():
    import resource

    from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
    from galileo_sdr_sim_tpu.io.sinks import NullSink
    from galileo_sdr_sim_tpu.io.stream import StreamingSynthesizer
    from galileo_sdr_sim_tpu.rinex import read_rinex_v3
    from galileo_sdr_sim_tpu.scenario import scenario_start_time

    nav = read_rinex_v3(RINEX)
    g0 = scenario_start_time(nav, date2gal(DateTime(2022, 2, 20, 8, 0, 1)))
    eng = ScenarioEngine(
        nav, PositionProvider(llh_deg=STATIC), g0, duration_s=600.0
    )
    synth = StreamingSynthesizer(eng, NullSink(), block_epochs=64)
    t0 = time.perf_counter()
    stats = synth.run()
    wall = time.perf_counter() - t0

    assert stats.epochs == 5999
    assert stats.samples == 5999 * NUM_IQ_SAMPLES
    assert stats.realtime_factor > 1.0  # even on a 2-CPU host
    # memory bounded over the whole run (docs/soak.md records history)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert peak < 4e6, f"peak rss {peak} kB"  # ru_maxrss is kB on linux
    print(f"soak: {stats.epochs} epochs in {wall:.1f} s "
          f"({stats.realtime_factor:.1f}x realtime), peak rss {peak/1e6:.2f} GB")


def test_config5_week_rollover_mid_run():
    """Signal time must roll cleanly across a GST week boundary mid-run
    (the reference supports 86400 s static runs; a Saturday-night start
    crosses weeks).  Uses -T overwrite to pin the scenario at week end.
    Loads a private nav copy: the -T overwrite mutates TOC/TOE in place."""
    from galileo_sdr_sim_tpu.constants import SECONDS_IN_WEEK
    from galileo_sdr_sim_tpu.gnss_time import GalTime
    from galileo_sdr_sim_tpu.rinex import read_rinex_v3
    from galileo_sdr_sim_tpu.scenario import scenario_start_time

    nav = read_rinex_v3(RINEX)
    wn = nav.eph[0][0].toe.week if nav.eph[0] else 2198
    g0 = GalTime(wn, SECONDS_IN_WEEK - 1.0)
    g0 = scenario_start_time(nav, g0, timeoverwrite=True)
    eng = ScenarioEngine(
        nav, PositionProvider(llh_deg=STATIC), g0, duration_s=3.0
    )
    tabs = list(eng.epochs())
    assert len(tabs) == 29
    secs = np.array([t.grx_sec for t in tabs])
    # grx_sec wraps into [0, 604800) exactly once, with continuous dt
    assert secs.max() < SECONDS_IN_WEEK
    wrapped = np.where(np.diff(secs) < 0)[0]
    assert len(wrapped) == 1
    deltas = np.diff(secs)
    deltas[wrapped] += SECONDS_IN_WEEK
    np.testing.assert_allclose(deltas, 0.10000002314, atol=1e-9)
    active = tabs[0].prn > 0
    assert np.any(active)
    for t in tabs:
        assert np.array_equal(t.prn > 0, active)  # channels survive the roll


# --------------------------------------------------------------------
# Live latency: UDP 7533 position lands in the next epoch (0.1 s)
# --------------------------------------------------------------------
def test_live_position_latency_one_epoch(nav, g0):
    """Reference guarantee: the epoch loop re-reads the live position
    every 0.1 s (src/galileo-sdr.cpp:443).  A position datagram received
    between epochs k and k+1 must be reflected in epoch k+1's
    observables — az/el is a stateless function of (sat, rx position),
    so it must match a from-scratch engine placed at the new position."""
    from galileo_sdr_sim_tpu.io.udp import UdpServers

    # ports of their own: test_bit_relay runs 17531-17533 in parallel
    ports = (17733, 17731, 17732)
    servers = UdpServers(STATIC, ports=ports).start()
    try:
        eng = ScenarioEngine(
            nav, PositionProvider(live=lambda: servers.state.llh),
            g0, duration_s=1.0,
        )
        it = eng.epochs()
        next(it)  # epoch 1 at the initial position

        moved = np.array([43.0, -70.0, 50.0])  # ~110 km away
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # wire format: 3 little-endian doubles (socket.h:165-180)
        import struct

        sock.sendto(struct.pack("<3d", *moved), ("127.0.0.1", ports[0]))
        sock.close()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if np.allclose(servers.state.llh, moved):
                break
            time.sleep(0.01)
        assert np.allclose(servers.state.llh, moved), "UDP update not received"

        tab = next(it)  # epoch 2: must already use the new position
        ref = ScenarioEngine(
            nav, PositionProvider(llh_deg=moved), g0, duration_s=1.0
        )
        ref_tabs = list(ref.epochs())
        active = tab.prn > 0
        assert np.array_equal(tab.prn, ref_tabs[1].prn)
        np.testing.assert_allclose(
            tab.azel[active], ref_tabs[1].azel[active], rtol=0, atol=1e-9
        )
    finally:
        servers.stop()


# --------------------------------------------------------------------
# Live loop closed through synthesis: UDP 7533 -> emitted samples
# --------------------------------------------------------------------
def test_live_position_reaches_samples_b1(nav, g0):
    """Close the interactive (-i) loop through the production pipeline:
    a UDP 7533 position update sent while block k drains must be
    reflected in the EMITTED SAMPLES of block k+2 at the latest (B=1
    pipelines one block ahead, so k+1 may still carry the old position
    -- the 0.2 s budget of the reference's 0.2 s FIFO depth,
    src/galileo-sdr.cpp:443 + constants.h:82-83).  Sample-level
    evidence: PCPS acquisition on the block recovers the transmitted
    code phase, which the ~110 km move shifts by hundreds of chips."""
    import struct

    from galileo_sdr_sim_tpu.constants import CA_SEQ_LEN_E1
    from galileo_sdr_sim_tpu.io.stream import StreamingSynthesizer
    from galileo_sdr_sim_tpu.io.udp import UdpServers
    from galileo_sdr_sim_tpu.rx_track import acquire, iq_to_complex

    moved = np.array([43.0, -70.0, 50.0])
    ports = (17633, 17631, 17632)
    servers = UdpServers(STATIC, ports=ports).start()
    blocks, batches = [], []

    class _Collect:
        def write(self, b):
            blocks.append(np.asarray(b).reshape(-1))

        def close(self):
            pass

    def cb(batch, stats):
        batches.append(batch)
        if stats.epochs == 1:  # during block 1's drain: send the move
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.sendto(struct.pack("<3d", *moved), ("127.0.0.1", ports[0]))
            sock.close()
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if np.allclose(servers.state.llh, moved):
                    return
                time.sleep(0.01)
            raise AssertionError("UDP update not received")

    try:
        eng = ScenarioEngine(
            nav, PositionProvider(live=lambda: servers.state.llh),
            g0, duration_s=0.5,
        )
        StreamingSynthesizer(
            eng, _Collect(), synth_engine="kp", block_epochs=1, status_cb=cb
        ).run()
    finally:
        servers.stop()

    assert len(blocks) >= 4
    # strongest channel of the initial epoch
    ch = int(np.argmax(batches[0].prn > 0))
    prn = int(batches[0].prn[ch])

    def circ(a, b):
        d = (a - b) % CA_SEQ_LEN_E1
        return min(d, CA_SEQ_LEN_E1 - d)

    # block 1 (pre-move): acquisition recovers the transmitted code phase
    a1 = acquire(iq_to_complex(blocks[0]), prn)
    assert a1.metric > 8.0
    tx1 = float(batches[0].code_phase0[0, ch]) % CA_SEQ_LEN_E1
    assert circ(a1.code_phase, tx1) < 1.0, (a1.code_phase, tx1)

    # block 3 = epoch of pickup (<= 0.2 s after the update): the
    # scenario already uses the moved position...
    ref = ScenarioEngine(
        nav, PositionProvider(llh_deg=STATIC), g0, duration_s=0.5
    )
    ref_tabs = list(ref.epochs())
    stay3 = float(ref_tabs[2].code_phase0[ch]) % CA_SEQ_LEN_E1
    tx3 = float(batches[2].code_phase0[0, ch]) % CA_SEQ_LEN_E1
    assert circ(tx3, stay3) > 20.0, (tx3, stay3)
    # ...and the transition epoch's samples stay BOUNDED: the 110 km
    # teleport makes its pseudorange-rate-derived Doppler exceed the
    # (K,p) engines' |mu| envelope, so the executor must fall back to
    # the direct engine for that block (one epoch of extreme but
    # in-model Doppler, exactly what the reference's rate derivation
    # would transmit) instead of emitting out-of-envelope garbage.
    rms = float(np.sqrt(np.mean(blocks[2].astype(np.float64) ** 2)))
    assert rms < 2000.0, rms

    # block 4 (rate settled at the new position): sample-level proof -
    # acquisition on the emitted samples recovers the MOVED geometry,
    # far from the no-move prediction
    a4 = acquire(iq_to_complex(blocks[3]), prn)
    tx4 = float(batches[3].code_phase0[0, ch]) % CA_SEQ_LEN_E1
    stay4 = float(ref_tabs[3].code_phase0[ch]) % CA_SEQ_LEN_E1
    assert a4.metric > 8.0
    assert circ(a4.code_phase, tx4) < 1.0, (a4.code_phase, tx4)
    assert circ(a4.code_phase, stay4) > 20.0, (a4.code_phase, stay4)
