"""End-to-end PVT on the full CBOC(6,1,1/11) modulation.

The reference transmits sine-BOC only and its evaluation acquires with
`cboc=false` (reference gnss-sdr_Galileo_E1_ishort.conf:48) — i.e. real
receivers process the true OS modulation with a sine-BOC replica.  This
test closes that loop for the CBOC model: the (K,p) engine's CBOC
stream, processed by the in-repo sine-BOC receiver, must still carry
decodable I/NAV through to a position fix.  The sc6 component costs the
receiver ~0.4 dB of correlation power and slightly reshapes the code
discriminator; neither may break acquisition, tracking, decode, or the
fix.

The receiver is given the candidate PRN list (only which satellites to
search — pseudoranges, ephemeris, and time are still recovered solely
from the samples); the no-metadata claim is already pinned by
tests/test_e2e_pvt.py on the sine-BOC scene, and skipping the blind
36-PRN sweep keeps the suite's runtime in check.
"""

import numpy as np
import pytest

from galileo_sdr_sim_tpu import geodesy
from galileo_sdr_sim_tpu.constants import NUM_IQ_SAMPLES, R2D
from galileo_sdr_sim_tpu.rx_pvt import receiver_fix
from galileo_sdr_sim_tpu.rx_track import iq_to_complex

from conftest import PVT_STATIC as STATIC


@pytest.fixture(scope="module")
def cboc_pvt_scene(nav):
    """Same 18.4+ s tow-28818 scene as conftest.pvt_scene (every
    ephemeris word type on air), synthesized with the CBOC model through
    the factorized engine."""
    from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
    from galileo_sdr_sim_tpu.models.cboc import E1_CBOC
    from galileo_sdr_sim_tpu.ops.synth_kp import synth_batch_kp_host
    from galileo_sdr_sim_tpu.scenario import (
        PositionProvider,
        ScenarioEngine,
        scenario_start_time,
    )

    g0 = scenario_start_time(nav, date2gal(DateTime(2022, 2, 20, 8, 0, 18)))
    eng = ScenarioEngine(
        nav, PositionProvider(llh_deg=STATIC), g0, duration_s=19.0,
        model=E1_CBOC,
    )
    iq = []
    for batch in eng.batches(8):
        if batch.f_code.shape[0] != 8:
            break  # keep one compile (see conftest.pvt_scene)
        iq.append(synth_batch_kp_host(batch, NUM_IQ_SAMPLES))
    assert len(iq) * 8 * 0.1 >= 18.0, f"scene too short: {len(iq) * 0.8:.1f} s"
    prns = sorted(c.prn for c in eng.bank.channels if c.prn > 0)
    x16 = np.concatenate(iq).reshape(-1).astype(np.int16)
    return prns, x16


def test_cboc_stream_produces_pvt_fix(cboc_pvt_scene):
    prns, x16 = cboc_pvt_scene
    fix = receiver_fix(iq_to_complex(x16), prn_candidates=prns)
    assert fix is not None, "no fix from the CBOC stream"
    sol = fix.solution
    assert sol.n_sats >= 5, sol.prns
    truth = geodesy.llh2xyz(
        np.array([STATIC[0] / R2D, STATIC[1] / R2D, STATIC[2]])
    )
    err = np.linalg.norm(sol.xyz - truth)
    assert err < 20.0, f"CBOC fix error {err:.2f} m (prns {sol.prns})"


def test_cboc_matched_receiver_produces_pvt_fix(cboc_pvt_scene):
    """Same CBOC stream through the CBOC-MATCHED receiver (acquire/track
    with model=E1_CBOC, +0.4 dB over the sine replica): full chain to a
    PVT fix at the simulated location — the matched waveform works
    end-to-end, not just at the correlator level."""
    from galileo_sdr_sim_tpu.models.cboc import E1_CBOC

    prns, x16 = cboc_pvt_scene
    fix = receiver_fix(iq_to_complex(x16), prn_candidates=prns, model=E1_CBOC)
    assert fix is not None, "no fix from the CBOC-matched receiver"
    sol = fix.solution
    assert sol.n_sats >= 5, sol.prns
    truth = geodesy.llh2xyz(
        np.array([STATIC[0] / R2D, STATIC[1] / R2D, STATIC[2]])
    )
    err = np.linalg.norm(sol.xyz - truth)
    assert err < 20.0, f"matched CBOC fix error {err:.2f} m ({sol.prns})"
