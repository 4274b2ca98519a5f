"""Generate the observables/orbit + iono A/B golden fixtures from the
*reference binary*.

Compiles the reference simulator's own geodesy/observables/iono layer
(unmodified $GALILEO_UPSTREAM_DIR/src/geodesy.cpp, gal-sig.cpp, gnss-time.cpp,
iono.cpp) with tests/ref_harness/harness_obs.cpp and drives
satpos / computeRange / computeCodePhase / checkSatVisibility /
ionosphericDelay over a grid of (satellite x epoch x receiver position)
cases built from real ephemerides in 20feb2022.rnx, plus a dense
(month x hour x position x geometry x solar-activity) grid for NeQuick-G.

Outputs:
  tests/data/obs_ref_fixture.json   satpos/range/codephase/vis golden values
  tests/data/iono_ref_fixture.json  NeQuick-G + obliquity slant delays

tests/test_obs_ref_ab.py and tests/test_iono_ref_ab.py then assert this
repo's geodesy.py / observables.py / iono.py reproduce every value to
float64 precision.  Run from the repo root:

    python tools/gen_obs_fixture.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
# the upstream galileo-sdr-sim checkout this tool reads
REF = Path(os.environ.get("GALILEO_UPSTREAM_DIR") or sys.exit(
    "set GALILEO_UPSTREAM_DIR to the upstream galileo-sdr-sim checkout"))
OBS_OUT = REPO / "tests" / "data" / "obs_ref_fixture.json"
IONO_OUT = REPO / "tests" / "data" / "iono_ref_fixture.json"

sys.path.insert(0, str(REPO))

from galileo_sdr_sim_tpu import geodesy  # noqa: E402
from galileo_sdr_sim_tpu.rinex import read_rinex_v3  # noqa: E402

D2R = np.pi / 180.0


def F(v) -> str:
    """repr of a plain float (numpy 2 repr wraps np.float64, unparseable)."""
    return repr(float(v))

# Raw (pre-derivation) ephemeris fields fed to the harness; `derive` then
# runs the reference's own rinex.cpp:225-229 derivation inside the binary.
EPH_KEYS = (
    "toe_sec toc_sec svid m0 ecc sqrta omg0 inc0 aop "
    "omgdot idot deltan cuc cus crc crs cic cis af0 af1 af2 "
    "bgde5a bgde5b"
).split()

# Receiver positions (lat deg, lon deg, hgt m): the BASELINE config-1 site,
# a high-latitude site, and a southern-hemisphere site.
SITES = [
    (42.3601, -71.0589, 2.0),
    (68.0, 18.0, 450.0),
    (-33.9, 151.2, 40.0),
]


def build_harness() -> Path:
    exe = Path("/tmp/obs_ab_harness")
    cmd = [
        "g++", "-O1",
        "-I", str(REPO / "tests" / "ref_harness" / "shim"),
        "-I", str(REF / "include"),
        "-o", str(exe),
        str(REPO / "tests" / "ref_harness" / "harness_obs.cpp"),
        str(REF / "src" / "geodesy.cpp"),
        str(REF / "src" / "gal-sig.cpp"),
        str(REF / "src" / "gnss-time.cpp"),
        str(REF / "src" / "iono.cpp"),
    ]
    subprocess.run(cmd, check=True)
    return exe


class Harness:
    """Batch driver: accumulate command lines, run once, parse in order."""

    def __init__(self, exe: Path):
        self.exe = exe
        self.lines: list[str] = []

    def put(self, line: str) -> None:
        self.lines.append(line)

    def set_eph(self, fields: dict) -> None:
        for k in EPH_KEYS:
            self.put(f"{k} {F(fields[k])}")
        self.put("derive")

    def set_iono(self, enable: int, vflg: int, ai: tuple) -> None:
        self.put(f"enable {enable}")
        self.put(f"vflg_ion {vflg}")
        self.put(f"ai0 {F(ai[0])}")
        self.put(f"ai1 {F(ai[1])}")
        self.put(f"ai2 {F(ai[2])}")

    def run(self) -> list[list[str]]:
        proc = subprocess.run(
            [str(self.exe)],
            input="\n".join(self.lines) + "\n",
            capture_output=True,
            text=True,
            check=True,
        )
        if proc.stderr:
            sys.stderr.write(proc.stderr)
        return [ln.split() for ln in proc.stdout.splitlines() if ln]


def eph_fields(rec) -> dict:
    f = {k: getattr(rec, k) for k in EPH_KEYS if k not in ("toe_sec", "toc_sec")}
    f["toe_sec"] = rec.toe.sec
    f["toc_sec"] = rec.toc.sec
    return f


def gen_obs(exe: Path) -> dict:
    nav = read_rinex_v3(REF / "rinex_files" / "20feb2022.rnx")
    h = Harness(exe)
    cases = []  # parallel to harness output order

    sites_xyz = [geodesy.llh2xyz(np.array([la * D2R, lo * D2R, hg]))
                 for la, lo, hg in SITES]

    svs = [sv for sv in range(36) if nav.eph[sv]]
    for sv in svs:
        rec = nav.eph[sv][0]
        f = eph_fields(rec)
        h.set_eph(f)
        h.set_iono(1, int(nav.iono.vflg), (nav.iono.ai0, nav.iono.ai1, nav.iono.ai2))
        week = rec.toe.week
        # epochs around TOE: inside the +-1 h match window and out to 2 h
        for off in (-3600.0, -1200.0, 0.0, 137.7, 600.0, 1801.3, 7200.0):
            sec = rec.toe.sec + off
            h.put(f"satpos {week} {F(sec)}")
            cases.append({"kind": "satpos", "sv": sv, "week": week, "sec": sec})
            for s_i, xyz in enumerate(sites_xyz):
                h.put(f"range {week} {F(sec)} {F(xyz[0])} {F(xyz[1])} {F(xyz[2])}")
                cases.append({"kind": "range", "sv": sv, "week": week,
                              "sec": sec, "site": s_i})
            xyz = sites_xyz[0]
            h.put(f"vis {week} {F(sec)} {F(xyz[0])} {F(xyz[1])} {F(xyz[2])} 10.0")
            cases.append({"kind": "vis", "sv": sv, "week": week, "sec": sec,
                          "site": 0})
        # obliquity-model ranges (vflg=0): meter-sized iono delay actually
        # lands in the pseudorange (iono.cpp:9-19 via gal-sig.cpp:295-297)
        h.set_iono(1, 0, (0.0, 0.0, 0.0))
        for off in (0.0, 600.0):
            sec = rec.toe.sec + off
            for s_i, xyz in enumerate(sites_xyz):
                h.put(f"range {week} {F(sec)} {F(xyz[0])} {F(xyz[1])} {F(xyz[2])}")
                cases.append({"kind": "range_obliq", "sv": sv, "week": week,
                              "sec": sec, "site": s_i})
        h.set_iono(1, int(nav.iono.vflg),
                   (nav.iono.ai0, nav.iono.ai1, nav.iono.ai2))
        # codephase: static pair and a 20 m/s moving pair, dt = the
        # reference's odd epoch step 0.10000002314 (galileo-sdr.cpp:347)
        dt = 0.10000002314
        for s_i, xyz in enumerate(sites_xyz[:2]):
            sec0 = rec.toe.sec + 137.7
            sec1 = sec0 + dt
            xyz1 = xyz + (np.array([20.0, -7.0, 3.0]) * dt if s_i else 0.0)
            h.put(
                f"codephase {week} {F(sec0)} {F(xyz[0])} {F(xyz[1])} {F(xyz[2])} "
                f"{F(sec1)} {F(xyz1[0])} {F(xyz1[1])} {F(xyz1[2])}"
            )
            cases.append({"kind": "codephase", "sv": sv, "week": week,
                          "sec0": sec0, "sec1": sec1, "site": s_i,
                          "xyz1": list(xyz1)})

    out = h.run()
    assert len(out) == len(cases), (len(out), len(cases))
    for case, row in zip(cases, out):
        assert case["kind"].startswith(row[0]), (row[0], case["kind"])
        case["ref"] = [float(v) for v in row[1:]]

    return {
        "rinex": "20feb2022.rnx",
        "sites_llh_deg": SITES,
        "iono_header": {"vflg": int(nav.iono.vflg), "ai0": nav.iono.ai0,
                        "ai1": nav.iono.ai1, "ai2": nav.iono.ai2},
        "eph": {str(sv): eph_fields(nav.eph[sv][0]) for sv in svs},
        "cases": cases,
    }


def gen_iono(exe: Path) -> dict:
    nav = read_rinex_v3(REF / "rinex_files" / "20feb2022.rnx")
    h = Harness(exe)
    cases = []

    # Weeks whose day-4 lands in each month of 2022-23 (GST weeks).  The
    # harness derives month/UT from gal2date, so sec selects the hour.
    # week 1191 starts 2022-11-06; step 4/5 weeks to walk the months.
    month_weeks = [1205, 1209, 1213, 1218, 1222, 1226, 1231, 1235, 1239,
                   1244, 1248, 1252]

    ai_sets = [
        ("rinex", (nav.iono.ai0, nav.iono.ai1, nav.iono.ai2)),
        ("flat_low", (63.7, 0.0, 0.0)),
        ("high", (236.83, -0.3937, 0.00403)),
    ]

    sat_h = 22000e3
    for name, ai in ai_sets:
        h.set_iono(1, 1, ai)
        for wk in month_weeks:
            for hour in (2.0, 14.0):
                sec = 3 * 86400.0 + hour * 3600.0 + 123.0
                for ulat in (-55.0, -10.0, 40.0):
                    for el in (10.0, 45.0, 80.0):
                        ulon, az = 30.0, 140.0
                        # satellite LLH along the azimuth at elevation el:
                        # ground offset ~ slant geometry (coarse, any
                        # consistent geometry works for A/B purposes)
                        gc = (90.0 - el) * 0.6
                        slat = ulat + gc * np.cos(az * D2R)
                        slon = ulon + gc * np.sin(az * D2R)
                        u = [ulat * D2R, ulon * D2R, 120.0]
                        s = [slat * D2R, slon * D2R, sat_h]
                        h.put(
                            f"iono {wk} {F(sec)} {F(u[0])} {F(u[1])} {F(u[2])} "
                            f"{F(s[0])} {F(s[1])} {F(s[2])} "
                            f"{F(az * D2R)} {F(el * D2R)}"
                        )
                        cases.append({"kind": "nequick", "ai": name,
                                      "week": wk, "sec": sec, "user": u,
                                      "sat": s, "azel": [az * D2R, el * D2R]})

    # Obliquity path (vflg = 0), elevation sweep
    h.set_iono(1, 0, (0.0, 0.0, 0.0))
    for el in (2.0, 10.0, 30.0, 60.0, 88.0):
        u = [0.3, -1.2, 50.0]
        s = [0.4, -1.1, 23000e3]
        h.put(f"iono 1200 302400.0 {F(u[0])} {F(u[1])} {F(u[2])} "
              f"{F(s[0])} {F(s[1])} {F(s[2])} 1.0 {F(el * D2R)}")
        cases.append({"kind": "obliquity", "week": 1200, "sec": 302400.0,
                      "user": u, "sat": s, "azel": [1.0, el * D2R]})

    # Disabled and invalid-geometry (low satellite -> badPos fallback)
    h.set_iono(0, 1, (80.0, 0.0, 0.0))
    u = [0.3, 0.5, 10.0]
    s = [0.35, 0.55, 22000e3]
    h.put(f"iono 1200 302400.0 {F(u[0])} {F(u[1])} {F(u[2])} "
          f"{F(s[0])} {F(s[1])} {F(s[2])} 0.5 0.7")
    cases.append({"kind": "disabled", "week": 1200, "sec": 302400.0,
                  "user": u, "sat": s, "azel": [0.5, 0.7]})
    h.set_iono(1, 1, (80.0, 0.0, 0.0))
    s_low = [0.35, 0.55, 1500e3]
    h.put(f"iono 1200 302400.0 {F(u[0])} {F(u[1])} {F(u[2])} "
          f"{F(s_low[0])} {F(s_low[1])} {F(s_low[2])} 0.5 0.7")
    cases.append({"kind": "lowsat_fallback", "week": 1200, "sec": 302400.0,
                  "user": u, "sat": s_low, "azel": [0.5, 0.7],
                  "ai": (80.0, 0.0, 0.0)})

    out = h.run()
    assert len(out) == len(cases), (len(out), len(cases))
    for case, row in zip(cases, out):
        assert row[0] == "iono"
        case["ref_delay"] = float(row[1])

    return {"ai_sets": {k: list(v) for k, v in ai_sets}, "cases": cases}


def main() -> None:
    exe = build_harness()
    obs = gen_obs(exe)
    OBS_OUT.write_text(json.dumps(obs))
    print(f"wrote {OBS_OUT}: {len(obs['cases'])} cases")
    ion = gen_iono(exe)
    IONO_OUT.write_text(json.dumps(ion))
    print(f"wrote {IONO_OUT}: {len(ion['cases'])} cases")


if __name__ == "__main__":
    main()
