"""Test configuration: force an 8-device virtual CPU mesh before JAX
backends initialize.

Sharding tests exercise real Mesh/shard_map paths on virtual CPU devices
(several GPUs are not needed to validate the partitioning).  Both the
env vars and the jax config are set here, in case jax was imported
already — backends are created lazily, so this works as long as no array
op ran yet."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

from pathlib import Path

import numpy as np
import pytest

from galileo_sdr_sim_tpu.rinex import NAV_FILE as RINEX  # noqa: E402

# The upstream project's checkout, named only by GALILEO_UPSTREAM_DIR;
# tests that need its sources or live-sky captures skip when it is unset.
UPSTREAM = Path(os.environ["GALILEO_UPSTREAM_DIR"]) if os.environ.get(
    "GALILEO_UPSTREAM_DIR") else None
TV_DIR = UPSTREAM / "tv" / "20_FEB_2022_GST_08_00_01" if UPSTREAM else None
needs_tv = pytest.mark.skipif(
    TV_DIR is None or not TV_DIR.is_dir(),
    reason="needs the upstream project's tv/ live-sky I/NAV captures "
    "(set GALILEO_UPSTREAM_DIR to its checkout)",
)
needs_upstream_src = pytest.mark.skipif(
    UPSTREAM is None or not (UPSTREAM / "src" / "inav-msg.cpp").exists(),
    reason="needs the upstream project's sources "
    "(set GALILEO_UPSTREAM_DIR to its checkout)",
)


@pytest.fixture(scope="session")
def nav():
    from galileo_sdr_sim_tpu.rinex import read_rinex_v3

    return read_rinex_v3(RINEX)


@pytest.fixture(scope="session")
def g0(nav):
    from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
    from galileo_sdr_sim_tpu.scenario import scenario_start_time

    return scenario_start_time(nav, date2gal(DateTime(2022, 2, 20, 8, 0, 1)))


@pytest.fixture(scope="session")
def engine_1s(nav, g0):
    from galileo_sdr_sim_tpu.scenario import PositionProvider, ScenarioEngine

    return ScenarioEngine(
        nav,
        PositionProvider(llh_deg=np.array([42.3601, -71.0589, 100.0])),
        g0,
        duration_s=1.0,
    )


@pytest.fixture(scope="session")
def batch_1s(engine_1s):
    return list(engine_1s.batches(8))[0]


PVT_STATIC = np.array([42.3601, -71.0589, 100.0])  # deg, deg, m


@pytest.fixture(scope="session")
def pvt_scene(nav):
    """18.4 s noise-free int16 stream + its start time, shared by the
    PVT acceptance test (test_e2e_pvt) and the AWGN margin test
    (test_e2e_noise).  Scene start 2022-02-20 08:00:18 (tow 28818): the
    I/NAV schedule delivers words 0,1,3,5,0 at transmit seconds
    28819-28827 and words 2,4 at 28831-28835, so every ephemeris word
    type lands inside the stream."""
    from galileo_sdr_sim_tpu.constants import NUM_IQ_SAMPLES
    from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
    from galileo_sdr_sim_tpu.ops.synth_kp import synth_batch_kp_host
    from galileo_sdr_sim_tpu.scenario import (
        PositionProvider,
        ScenarioEngine,
        scenario_start_time,
    )

    g0 = scenario_start_time(nav, date2gal(DateTime(2022, 2, 20, 8, 0, 18)))
    eng = ScenarioEngine(
        nav, PositionProvider(llh_deg=PVT_STATIC), g0, duration_s=19.0
    )
    iq = []
    dropped = 0
    for batch in eng.batches(8):
        if batch.f_code.shape[0] != 8:
            # keep a single (B=8) compile: stop at the first channel-map
            # change / partial batch instead of recompiling for its shape
            dropped += batch.f_code.shape[0]
            break
        iq.append(synth_batch_kp_host(batch, NUM_IQ_SAMPLES))
    # the decode chain needs every ephemeris word type on air (>= 18 s).
    # If allocation timing shifts and the tail-drop shortens the scene
    # below that, fail loudly instead of flaking downstream.
    assert len(iq) * 8 * 0.1 >= 18.0, (
        f"scene too short: {len(iq) * 8 * 0.1:.1f} s kept "
        f"({dropped} tail epochs dropped to keep one compile)"
    )
    x16 = np.concatenate(iq).reshape(-1).astype(np.int16)
    return g0, x16


class CollectSink:
    """Test sink that stores written blocks (host copies); optionally
    stops its synthesizer after N writes to simulate a crash."""

    def __init__(self, stop_after=None):
        self.blocks = []
        self.stop_after = stop_after
        self.synth = None

    def write(self, b):
        self.blocks.append(np.asarray(b).copy())
        if self.stop_after and len(self.blocks) >= self.stop_after:
            self.synth.stop()

    def close(self):
        pass
