"""Generate the I/NAV A/B golden fixture from the *reference binary*.

Compiles the reference simulator's own encoder (unmodified
$GALILEO_UPSTREAM_DIR/src/inav-msg.cpp + datatypes.cpp) with the harness in
tests/ref_harness/, drives it over real ephemerides from 20feb2022.rnx
across every word-type slot of the 60 s schedule (plus odd-TOW stamps,
which the epoch loop can produce), and stores inputs + 500-symbol output
pages in tests/data/inav_ref_pages.json.

tests/test_inav_ref_ab.py then asserts this repo's inav.py reproduces
every page bit-for-bit.  Run from the repo root:

    python tools/gen_inav_fixture.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# the upstream galileo-sdr-sim checkout this tool reads
REF = Path(os.environ.get("GALILEO_UPSTREAM_DIR") or sys.exit(
    "set GALILEO_UPSTREAM_DIR to the upstream galileo-sdr-sim checkout"))
OUT = REPO / "tests" / "data" / "inav_ref_pages.json"

sys.path.insert(0, str(REPO))

from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal  # noqa: E402
from galileo_sdr_sim_tpu.rinex import read_rinex_v3  # noqa: E402

EPH_KEYS = (
    "toe_sec toc_sec iode svid svhlth m0 ecc sqrta omg0 inc0 aop "
    "omgdot idot deltan cuc cus crc crs cic cis af0 af1 af2 "
    "bgde5a bgde5b"
).split()
ION_KEYS = "ai0 ai1 ai2 A0 A1 dtls tot wnt wnlsf dn dtlsf".split()


def build_harness() -> Path:
    exe = Path("/tmp/inav_ab_harness")
    cmd = [
        "g++", "-O1",
        "-I", str(REPO / "tests" / "ref_harness" / "shim"),
        "-I", str(REF / "include"),
        "-o", str(exe),
        str(REPO / "tests" / "ref_harness" / "harness.cpp"),
        str(REF / "src" / "inav-msg.cpp"),
        str(REF / "src" / "datatypes.cpp"),
    ]
    subprocess.run(cmd, check=True)
    return exe


def eph_fields(rec) -> dict:
    out = {}
    for k in EPH_KEYS:
        if k == "toe_sec":
            out[k] = rec.toe.sec
        elif k == "toc_sec":
            out[k] = rec.toc.sec
        else:
            out[k] = getattr(rec, k)
    return out


def ion_fields(iono) -> dict:
    return {k: getattr(iono, k) for k in ION_KEYS}


def main() -> None:
    nav = read_rinex_v3(REF / "rinex_files" / "20feb2022.rnx")
    g0 = date2gal(DateTime(2022, 2, 20, 8, 0, 1))
    exe = build_harness()

    cases = []
    # three PRNs with diverse parameter signs, matched at the scenario epoch
    for prn in (3, 15, 36):
        idx = nav.epoch_match(prn - 1, g0)
        rec = nav.eph[prn - 1][idx]
        ef, inf = eph_fields(rec), ion_fields(nav.iono)
        lines = [f"week {g0.week}"]
        for k, v in {**ef, **inf}.items():
            lines.append(f"{k} {v!r}")
        # every slot of the 60 s schedule (both halves), plus odd TOW
        # stamps (the epoch loop's int(grx.sec) can land on odd seconds)
        tows = [28800 + s for s in range(0, 60, 2)]
        tows += [28821, 28855, 604798]  # odd stamps + week-end edge
        for tow in tows:
            lines.append(f"tow {tow}")
        proc = subprocess.run(
            [str(exe)], input="\n".join(lines) + "\n",
            capture_output=True, text=True, check=True,
        )
        for out_line in proc.stdout.splitlines():
            _, week, tow, page = out_line.split()
            assert len(page) == 500, out_line
            cases.append(
                dict(
                    prn=prn, week=int(week), tow=float(tow),
                    eph=ef, iono=inf, page=page,
                )
            )

    OUT.parent.mkdir(parents=True, exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(
            dict(
                source="reference binary (inav-msg.cpp + datatypes.cpp), "
                "see tests/ref_harness/harness.cpp",
                rinex="20feb2022.rnx",
                cases=cases,
            ),
            f,
        )
    print(f"wrote {len(cases)} pages to {OUT}")


if __name__ == "__main__":
    main()
