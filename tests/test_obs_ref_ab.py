"""A/B parity of the observables/orbit layer against the *compiled
reference binary*.

tests/data/obs_ref_fixture.json holds golden values emitted by the
reference's own satpos / computeRange / computeCodePhase /
checkSatVisibility (geodesy.cpp:161-273, gal-sig.cpp:242-347,
geodesy.cpp:318-343), compiled unmodified by tools/gen_obs_fixture.py.
This file asserts the repo's geodesy.py / observables.py / channels.py
reproduce every value to float64 round-off, retiring the
correlated-oracle risk: the transmitter and the in-repo receiver share
observables.compute_range, so only an external oracle can catch a
systematic convention bug (Earth-rotation sign, BGD-on-clock,
relativistic term, light-time direction).

Measured agreement (tools/gen_obs_fixture.py grid, 1075 cases):
pos <= 2.7e-8 m, vel <= 5e-12 m/s, clk exact, pseudorange <= 3.8e-8 m,
az/el <= 4e-11 rad, f_carr <= 4e-7 Hz, code_phase exact, counters exact.
Bounds below carry ~30x margin and are still orders of magnitude below
anything receiver-visible.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from galileo_sdr_sim_tpu import geodesy, observables
from galileo_sdr_sim_tpu.channels import check_visibility
from galileo_sdr_sim_tpu.constants import (
    OMEGA_EARTH,
    SECONDS_IN_HALF_WEEK,
    WGS_SQRT_GM,
)
from galileo_sdr_sim_tpu.gnss_time import GalTime
from galileo_sdr_sim_tpu.rinex import NAV_FILE, read_rinex_v3

# fields tools/gen_nav_rinex.py re-references to the scene epoch
REREFERENCED = {"m0", "omg0", "inc0", "af0", "af1", "toe_sec", "toc_sec"}
FIXTURE = Path(__file__).parent / "data" / "obs_ref_fixture.json"

D2R = np.pi / 180.0

POS_TOL = 2e-6  # m
VEL_TOL = 1e-9  # m/s
CLK_TOL = 1e-16  # s
RANGE_TOL = 2e-6  # m
AZEL_TOL = 1e-8  # rad
FCARR_TOL = 1e-4  # Hz
FCODE_TOL = 1e-7  # chips/s
CODEPHASE_TOL = 1e-6  # chips
IONO_REL_TOL = 1e-9


@pytest.fixture(scope="module")
def fix():
    return json.loads(FIXTURE.read_text())


@pytest.fixture(scope="module")
def nav(fix):
    """The in-repo file's header, with each satellite's records replaced
    by the original 20feb2022.rnx record the fixture was generated from
    (the file holds it re-referenced to the scene epoch)."""
    nav = read_rinex_v3(NAV_FILE)
    for sv_s, fields in fix["eph"].items():
        sv = int(sv_s)
        # the fixture keeps seconds of week; its records span Saturday
        # evening (week 2197) to Sunday afternoon (week 2198)
        week = 2197 if fields["toe_sec"] > SECONDS_IN_HALF_WEEK else 2198
        raw = {k: v for k, v in fields.items() if k not in ("toe_sec", "toc_sec")}
        rec = dataclasses.replace(
            nav.eph[sv][0], **raw,
            toe=GalTime(week, fields["toe_sec"]),
            toc=GalTime(week, fields["toc_sec"]),
        )
        # derived terms as rinex.read_rinex_v3 (rinex.cpp:225-229)
        rec.A = rec.sqrta * rec.sqrta
        rec.n = WGS_SQRT_GM / (rec.sqrta * rec.A) + rec.deltan
        rec.sq1e2 = float(np.sqrt(1.0 - rec.ecc * rec.ecc))
        rec.omgkdot = rec.omgdot - OMEGA_EARTH
        nav.eph[sv] = [rec]
    return nav


@pytest.fixture(scope="module")
def sites(fix):
    return [
        geodesy.llh2xyz(np.array([la * D2R, lo * D2R, h]))
        for la, lo, h in fix["sites_llh_deg"]
    ]


def _iono_for(fix, nav, kind):
    """IonoUtc configured the way the fixture generator configured the
    reference binary for this case kind."""
    from galileo_sdr_sim_tpu.rinex import IonoUtc

    if kind == "range_obliq":
        return IonoUtc(enable=True, vflg=False)
    return nav.iono


def test_eph_fields_bit_identical(fix):
    """The repo parser reads back, from every record of the in-repo file,
    each raw field the reference binary was driven with that the
    re-reference keeps (before the shared rinex.cpp:225-229 derivation)."""
    file_nav = read_rinex_v3(NAV_FILE)
    for sv_s, fields in fix["eph"].items():
        recs = file_nav.eph[int(sv_s)]
        assert recs, sv_s
        for rec in recs:
            for key, val in fields.items():
                if key not in REREFERENCED:
                    assert float(getattr(rec, key)) == val, (sv_s, key)


def test_satpos_ab(fix, nav):
    n = 0
    for c in fix["cases"]:
        if c["kind"] != "satpos":
            continue
        rec = nav.eph[c["sv"]][0]
        pos, vel, clk = geodesy.satpos(rec, c["sec"])
        ref = c["ref"]
        assert np.abs(pos - ref[:3]).max() <= POS_TOL, c
        assert np.abs(vel - ref[3:6]).max() <= VEL_TOL, c
        assert np.abs(clk - ref[6:8]).max() <= CLK_TOL, c
        n += 1
    assert n >= 150


def test_range_ab(fix, nav, sites):
    n = 0
    for c in fix["cases"]:
        if c["kind"] not in ("range", "range_obliq"):
            continue
        rec = nav.eph[c["sv"]][0]
        iono = _iono_for(fix, nav, c["kind"])
        rs = observables.compute_range(
            rec, iono, c["week"], np.float64(c["sec"]), sites[c["site"]]
        )
        ref = c["ref"]
        assert abs(float(rs.range) - ref[0]) <= RANGE_TOL, c
        assert abs(float(rs.d) - ref[1]) <= RANGE_TOL, c
        assert abs(float(rs.azel[..., 0]) - ref[2]) <= AZEL_TOL, c
        assert abs(float(rs.azel[..., 1]) - ref[3]) <= AZEL_TOL, c
        if c["kind"] == "range_obliq":
            # meter-sized obliquity delay really lands in the pseudorange
            assert abs(ref[4]) > 1.0
            assert abs(float(rs.iono_delay) - ref[4]) <= IONO_REL_TOL * abs(ref[4]), c
        else:
            # NeQuick quirk path: the reference's delay is ~1e-24 m, a
            # float64 no-op on a 2e7 m pseudorange; the repo's shortcut
            # returns exactly 0 (iono.py:538-546).  The pseudorange
            # equality above is the bit-level production contract; the
            # model itself is pinned by tests/test_iono_ref_ab.py.
            assert abs(ref[4]) < 1e-12
        n += 1
    assert n >= 500


def test_visibility_ab(fix, nav, sites):
    n = 0
    for c in fix["cases"]:
        if c["kind"] != "vis":
            continue
        rec = nav.eph[c["sv"]][0]
        vis, azel = check_visibility(
            rec, GalTime(c["week"], c["sec"]), sites[c["site"]], 10.0
        )
        ref = c["ref"]
        assert (1 if vis else 0) == int(ref[0]), c
        assert abs(azel[0] - ref[1]) <= AZEL_TOL, c
        assert abs(azel[1] - ref[2]) <= AZEL_TOL, c
        n += 1
    assert n >= 150


def test_code_phase_ab(fix, nav, sites):
    """f_carr / f_code / code_phase / ibit / ipage parity incl. the moving-
    receiver pair (gal-sig.cpp:308-347)."""
    n = 0
    for c in fix["cases"]:
        if c["kind"] != "codephase":
            continue
        rec = nav.eph[c["sv"]][0]
        xyz0 = sites[c["site"]]
        xyz1 = np.array(c["xyz1"])
        r0 = observables.compute_range(
            rec, nav.iono, c["week"], np.float64(c["sec0"]), xyz0
        )
        r1 = observables.compute_range(
            rec, nav.iono, c["week"], np.float64(c["sec1"]), xyz1
        )
        st = observables.code_phase_state(
            r0.range, r1.range, c["sec1"] - c["sec0"], np.float64(c["sec1"])
        )
        ref = c["ref"]
        assert abs(float(st.f_carr) - ref[0]) <= FCARR_TOL, c
        assert abs(float(st.f_code) - ref[1]) <= FCODE_TOL, c
        assert abs(float(st.code_phase) - ref[2]) <= CODEPHASE_TOL, c
        assert int(st.ibit) == int(ref[3]), c
        assert int(st.ipage) == int(ref[4]), c
        n += 1
    assert n >= 40
