"""RINEX parser tests against the in-repo navigation file
(rinex.NAV_FILE, written by tools/gen_nav_rinex.py; reference parser:
src/rinex.cpp)."""

import numpy as np

from galileo_sdr_sim_tpu.gnss_time import DateTime, GalTime, date2gal
from galileo_sdr_sim_tpu.rinex import getGalileoUra, read_rinex_v3


def test_header_iono(nav):
    assert nav.iono.vflg
    assert nav.iono.ai0 == 81.25
    assert nav.iono.ai1 == -0.24609
    assert nav.iono.ai2 == 0.0037537
    assert nav.iono.A0 == -9.3132257462e-10
    assert nav.iono.A1 == 8.881784197e-16
    # reference GAUT quirk parse: wnt = (short)2198 >> 4
    assert nav.iono.wnt == 137
    assert nav.iono.wnlsf == 2198
    assert nav.iono.dtls == 18


def test_first_record_fields(nav):
    # First E01 record in the file (E1-B source, flag 517): the
    # 20feb2022.rnx record re-referenced to 08:00 GST.
    rec = nav.eph[0][0]
    assert rec.svid == 1
    assert rec.af0 == -5.825908951920e-04
    assert rec.af1 == -7.318590178329e-12
    assert rec.iode == 48
    assert rec.crs == 3.634375e01
    assert rec.sqrta == 5.440600259781e03
    assert rec.toe.sec == 28800.0
    assert rec.week == 2198
    assert rec.flag == 517
    assert rec.toc == date2gal(DateTime(2022, 2, 20, 8, 0, 0.0))
    # derived terms
    assert np.isclose(rec.A, rec.sqrta**2)
    assert np.isclose(rec.sq1e2, np.sqrt(1 - rec.ecc**2))


def test_flag_filter(nav):
    for recs in nav.eph:
        for rec in recs:
            assert rec.flag == 517


def test_epoch_match_window(nav, g0):
    idx = nav.epoch_match(0, g0)
    assert idx >= 0
    rec = nav.eph[0][idx]
    dt = g0 - rec.toc
    assert -3600 <= dt < 3600
    # no record -> -1
    assert nav.epoch_match(5, g0) == -1 or len(nav.eph[5]) > 0


def test_time_window(nav):
    gmin, gmax = nav.time_window()
    assert gmax - gmin > 3600
    assert gmin.week == 2197 or gmin.week == 2198


def test_galileo_ura():
    assert getGalileoUra(0.49) == 49
    assert getGalileoUra(0.99) == (99 - 50) // 2 + 50
    assert getGalileoUra(1.99) == (199 - 100) // 4 + 75
    assert getGalileoUra(3.12) == (312 - 200) // 16 + 100
    assert getGalileoUra(-1.0) == 255
    assert getGalileoUra(61.0) == 255
