"""Write the in-repo RINEX v3 Galileo navigation file.

The simulator needs a broadcast-ephemeris file for every run.  The
repository carries 25 real broadcast Galileo ephemerides (E1-B source)
from the 20 Feb 2022 navigation file, together with that file's
ionospheric header, in tests/data/obs_ref_fixture.json (`eph`,
`iono_header`).  This tool writes them out as a RINEX v3 navigation file
that `rinex.read_rinex_v3` parses unchanged:

    python tools/gen_nav_rinex.py            # rewrites rinex.NAV_FILE
    python tools/gen_nav_rinex.py --out F    # writes F instead

Each original record is re-referenced to the scene epochs
toe = toc = 2022-02-20 08:00, 10:00 and 12:00 GST (GALILEO week 2198).
Re-referencing by dt = toe' - toe keeps the orbit and clock that the
original record describes, exactly in the ephemeris model of
geodesy.satpos:

    M0'  = M0 + (n0 + dn) * dt                  (mean anomaly)
    OMG0' = OMG0 + OMGdot * dt - wE * 604800 * dweek
                                                (node; OMG0 is referred
                                                 to the start of toe's week)
    i0'  = i0 + IDOT * dt
    af0' = af0 + af1 * dt + af2 * dt^2,  af1' = af1 + 2 * af2 * dt

Every other element is kept.  The scenes that the tests, the docs and
the CLI examples use start at 08:00:01 and 08:00:18, so every satellite
has a record within the parser's +-1 h match window.  Three issues per
satellite are written because the scenario's time window ends at the
second-to-last record time (rinex.NavData.time_window, the reference's
rule): with 08:00, 10:00 and 12:00, scenes may start between 08:00 and
10:00 GST.  Since the broadcast ephemeris is both what the simulator
propagates and what the receiver decodes, the scene stays
self-consistent; tests/test_nav_file.py checks the file against the
fixture satellite by satellite.

Fields the fixture does not hold take fixed values: IODnav counts the
10-minute slots of the day, SISA is 3.12 m, health 0, data source 517
(I/NAV E1-B), and the GAUT header line carries the original file's
A0/A1 (tests/test_rinex.py).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "obs_ref_fixture.json"
sys.path.insert(0, str(REPO))

from galileo_sdr_sim_tpu.constants import (  # noqa: E402
    OMEGA_EARTH,
    SECONDS_IN_HALF_WEEK,
    SECONDS_IN_WEEK,
    WGS_SQRT_GM,
)
from galileo_sdr_sim_tpu.rinex import NAV_FILE  # noqa: E402

SCENE_WEEK = 2198  # GALILEO/GPS week of 2022-02-20 (a Sunday, week start)
SCENE_HOURS = (8, 10, 12)  # toe = toc of the written issues, GST
GAUT_A0 = -9.3132257462e-10
GAUT_A1 = 8.881784197e-16
SISA_M = 3.12
DATA_SOURCE = 517


def original_week(toe_sec: float) -> int:
    """The fixture keeps seconds of week only; its records span Saturday
    evening (week 2197) to Sunday afternoon (week 2198)."""
    return SCENE_WEEK - 1 if toe_sec > SECONDS_IN_HALF_WEEK else SCENE_WEEK


def wrap_pi(x: float) -> float:
    return float((x + np.pi) % (2.0 * np.pi) - np.pi)


def rereference(rec: dict, week: int, toe_sec: float) -> dict:
    """The fixture record `rec` re-expressed at toe = toc = (week, toe_sec)."""
    dweek = week - original_week(rec["toe_sec"])
    dt = dweek * SECONDS_IN_WEEK + toe_sec - rec["toe_sec"]
    n = WGS_SQRT_GM / rec["sqrta"] ** 3 + rec["deltan"]
    out = dict(rec)
    out["m0"] = wrap_pi(rec["m0"] + n * dt)
    out["omg0"] = wrap_pi(
        rec["omg0"] + rec["omgdot"] * dt - OMEGA_EARTH * SECONDS_IN_WEEK * dweek
    )
    out["inc0"] = rec["inc0"] + rec["idot"] * dt
    out["af0"] = rec["af0"] + dt * (rec["af1"] + dt * rec["af2"])
    out["af1"] = rec["af1"] + 2.0 * dt * rec["af2"]
    out["toe_sec"] = out["toc_sec"] = toe_sec
    return out


def _d(v: float) -> str:
    """RINEX D19.12 field (written with an E exponent)."""
    return f"{float(v):19.12E}"


def _orbit_line(*vals: float) -> str:
    return "    " + "".join(_d(v) for v in vals)


def _header(iono: dict) -> list[str]:
    def label(body: str, name: str) -> str:
        return f"{body:<60}{name}"

    ai = "".join(f"{iono[k]:12.4E}" for k in ("ai0", "ai1", "ai2"))
    return [
        label("     3.04           N: GNSS NAV DATA    E: GALILEO",
              "RINEX VERSION / TYPE"),
        label("gen_nav_rinex.py", "PGM / RUN BY / DATE"),
        label("GAL " + ai + f"{0.0:12.4E}", "IONOSPHERIC CORR"),
        label(f"GAUT{GAUT_A0:18.10E}{GAUT_A1:16.9E}{0:7d}{SCENE_WEEK:5d}",
              "TIME SYSTEM CORR"),
        label("    18", "LEAP SECONDS"),
        label("", "END OF HEADER"),
    ]


def _record(r: dict, svid: int, hour: int) -> list[str]:
    iod = hour * 6  # 10-minute slots since 00:00
    return [
        f"E{svid:02d} 2022 02 20 {hour:02d} 00 00"
        + _d(r["af0"]) + _d(r["af1"]) + _d(r["af2"]),
        _orbit_line(iod, r["crs"], r["deltan"], r["m0"]),
        _orbit_line(r["cuc"], r["ecc"], r["cus"], r["sqrta"]),
        _orbit_line(r["toe_sec"], r["cic"], r["omg0"], r["cis"]),
        _orbit_line(r["inc0"], r["crc"], r["aop"], r["omgdot"]),
        _orbit_line(r["idot"], DATA_SOURCE, SCENE_WEEK, 0.0),
        _orbit_line(SISA_M, 0.0, r["bgde5a"], r["bgde5b"]),
        _orbit_line(r["toe_sec"] - 600.0, 0.0, 0.0, 0.0),
    ]


def render(fixture: dict) -> str:
    eph = sorted(fixture["eph"].values(), key=lambda r: r["svid"])
    lines = _header(fixture["iono_header"])
    for rec in eph:
        for hour in SCENE_HOURS:
            r = rereference(rec, SCENE_WEEK, hour * 3600.0)
            lines += _record(r, rec["svid"], hour)
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=NAV_FILE)
    args = ap.parse_args(argv)
    fixture = json.loads(FIXTURE.read_text())
    args.out.write_text(render(fixture))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
