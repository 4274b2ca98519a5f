"""A/B test: this repo's I/NAV encoder vs the compiled *reference binary*.

tests/data/inav_ref_pages.json holds 500-symbol pages emitted by the
reference simulator's own encoder (src/inav-msg.cpp + datatypes.cpp,
compiled unmodified by tools/gen_inav_fixture.py) for real ephemerides
from 20feb2022.rnx across every word-type slot of the 60 s schedule,
odd TOW stamps, and the week-end edge.  Every page must match
inav.generate_inav_page bit-for-bit — this is the direct proof of the
"bit-exact I/NAV" claim (stronger than the tv/ live-sky structural
checks, which contain almanac words the simulator never emits).
"""

import json
from pathlib import Path

import numpy as np

from galileo_sdr_sim_tpu.gnss_time import GalTime
from galileo_sdr_sim_tpu.inav import generate_inav_page, word_type_for
from galileo_sdr_sim_tpu.rinex import Ephemeris, IonoUtc

from conftest import needs_upstream_src

FIXTURE = Path(__file__).parent / "data" / "inav_ref_pages.json"


def _load_cases():
    with open(FIXTURE) as f:
        data = json.load(f)
    return data["cases"]


def _make_eph(prn: int, week: int, f: dict) -> Ephemeris:
    return Ephemeris(
        svid=int(f["svid"]),
        toc=GalTime(week, f["toc_sec"]),
        toe=GalTime(week, f["toe_sec"]),
        af0=f["af0"], af1=f["af1"], af2=f["af2"],
        iode=int(f["iode"]),
        crs=f["crs"], deltan=f["deltan"], m0=f["m0"],
        cuc=f["cuc"], ecc=f["ecc"], cus=f["cus"], sqrta=f["sqrta"],
        cic=f["cic"], omg0=f["omg0"], cis=f["cis"], inc0=f["inc0"],
        crc=f["crc"], aop=f["aop"], omgdot=f["omgdot"], idot=f["idot"],
        flag=517, week=week, sisa=0.0,
        svhlth=int(f["svhlth"]),
        bgde5a=f["bgde5a"], bgde5b=f["bgde5b"], ura=0,
    )


def _make_iono(f: dict) -> IonoUtc:
    return IonoUtc(
        ai0=f["ai0"], ai1=f["ai1"], ai2=f["ai2"],
        A0=f["A0"], A1=f["A1"],
        dtls=int(f["dtls"]), tot=int(f["tot"]), wnt=int(f["wnt"]),
        dtlsf=int(f["dtlsf"]), dn=int(f["dn"]), wnlsf=int(f["wnlsf"]),
    )


def test_fixture_present_and_covers_all_word_types():
    cases = _load_cases()
    assert len(cases) >= 90
    wts = {word_type_for(c["tow"]) for c in cases}
    assert {0, 1, 2, 3, 4, 5, 6} <= wts
    # plus scheduled-but-unimplemented slots (encoded as dummy word 63)
    assert wts - {0, 1, 2, 3, 4, 5, 6}


def test_pages_bit_exact_vs_reference_binary():
    cases = _load_cases()
    mismatches = []
    for c in cases:
        g = GalTime(c["week"], c["tow"])
        page = generate_inav_page(g, _make_eph(c["prn"], c["week"], c["eph"]),
                                  _make_iono(c["iono"]))
        ref = np.frombuffer(c["page"].encode(), dtype=np.uint8) - ord("0")
        if not np.array_equal(page, ref):
            mismatches.append(
                (c["prn"], c["tow"], int(np.sum(page != ref)))
            )
    assert not mismatches, f"pages differ from reference binary: {mismatches}"


@needs_upstream_src
def test_fixture_is_reproducible_from_reference():
    """The checked-in fixture regenerates identically from the reference
    sources (guards against a stale or hand-edited fixture)."""
    import subprocess
    import sys

    before = FIXTURE.read_bytes()
    subprocess.run(
        [sys.executable, str(Path(__file__).parent.parent / "tools" / "gen_inav_fixture.py")],
        check=True, capture_output=True,
    )
    assert FIXTURE.read_bytes() == before
