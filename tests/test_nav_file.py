"""The in-repo navigation file (rinex.NAV_FILE) against its source.

tools/gen_nav_rinex.py writes the file from the 25 broadcast ephemerides
of tests/data/obs_ref_fixture.json, re-referenced to 08:00, 10:00 and
12:00 GST.  These tests pin that the committed file is what the tool
writes, and that every re-referenced record puts its satellite where the
original record's own propagation puts it.

Tolerances: the RINEX D19.12 format keeps 13 significant digits, so the
advanced mean anomaly (up to ~7 rad) is rounded to ~1e-12 rad, ~3e-5 m
along a 29,600 km orbit; position 1e-3 m, velocity 1e-6 m/s and clock
1e-14 s (3 mm of range) leave a wide margin over that rounding while
any error in the re-reference (a wrong node or week term) moves the
satellite by kilometres.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from galileo_sdr_sim_tpu import geodesy
from galileo_sdr_sim_tpu.constants import (
    OMEGA_EARTH,
    SECONDS_IN_HALF_WEEK,
    SECONDS_IN_WEEK,
    WGS_SQRT_GM,
)
from galileo_sdr_sim_tpu.rinex import NAV_FILE, read_rinex_v3

REPO = Path(__file__).resolve().parent.parent
FIXTURE = Path(__file__).parent / "data" / "obs_ref_fixture.json"
EPH = json.loads(FIXTURE.read_text())["eph"]


class _Orig:
    """A fixture record with the parser's derived terms, for satpos."""

    def __init__(self, f: dict):
        self.__dict__.update(f)
        self.A = f["sqrta"] ** 2
        self.n = WGS_SQRT_GM / (f["sqrta"] * self.A) + f["deltan"]
        self.sq1e2 = float(np.sqrt(1.0 - f["ecc"] ** 2))
        self.omgkdot = f["omgdot"] - OMEGA_EARTH
        self.week = 2197 if f["toe_sec"] > SECONDS_IN_HALF_WEEK else 2198


@pytest.fixture(scope="module")
def nav():
    return read_rinex_v3(NAV_FILE)


def test_generator_reproduces_committed_file(tmp_path):
    out = tmp_path / "nav.rnx"
    subprocess.run(
        [sys.executable, str(REPO / "tools" / "gen_nav_rinex.py"),
         "--out", str(out)],
        check=True, capture_output=True, timeout=120,
    )
    assert out.read_bytes() == NAV_FILE.read_bytes()


@pytest.mark.parametrize("sv", sorted(int(k) for k in EPH))
def test_rereferenced_record_keeps_orbit(nav, sv):
    orig = _Orig(EPH[str(sv)])
    recs = nav.eph[sv]
    assert [r.toe.sec for r in recs] == [28800.0, 36000.0, 43200.0]
    for rec in recs:
        assert rec.toc == rec.toe and rec.week == rec.toe.week == 2198
        # satpos wraps time differences into +-half a week, so the
        # original record is evaluated at the same instant expressed in
        # its own week
        t_orig = rec.toe.sec + (rec.toe.week - orig.week) * SECONDS_IN_WEEK
        pos0, vel0, clk0 = geodesy.satpos(orig, t_orig)
        pos1, vel1, clk1 = geodesy.satpos(rec, rec.toe.sec)
        assert np.abs(pos1 - pos0).max() < 1e-3, (sv, pos1 - pos0)
        assert np.abs(vel1 - vel0).max() < 1e-6, (sv, vel1 - vel0)
        assert np.abs(clk1 - clk0).max() < 1e-14, (sv, clk1 - clk0)


def test_scene_finds_every_satellite(nav):
    """The scenes of the tests, docs and CLI examples (08:00:01 and
    08:00:18 GST) match a record for every satellite in the file."""
    from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
    from galileo_sdr_sim_tpu.scenario import scenario_start_time

    for sec in (1, 18):
        g0 = scenario_start_time(nav, date2gal(DateTime(2022, 2, 20, 8, 0, sec)))
        for sv in (int(k) for k in EPH):
            assert nav.epoch_match(sv, g0) == 0, (sec, sv)
