"""Receiver-style tracking/demodulation gate: open-loop carrier wipe +
per-symbol code correlation over the emitted stream must recover the
exact transmitted I/NAV symbol sequence, detect the 10-symbol page sync
pattern at the 250-symbol frame spacing, and see the E1C pilot's
secondary code.

This extends the acquisition gate (test_e2e_acquisition.py) to the next
receiver stages the reference validates with GNSS-SDR (SURVEY §4:
acquire -> track -> decode): symbol transport is checked bit-exactly and
frame alignment is recovered from the waveform alone.
"""

import numpy as np
import pytest

from galileo_sdr_sim_tpu.codes import boc_chips, sync_pattern
from galileo_sdr_sim_tpu.constants import (
    CA_SEQ_LEN_E1,
    NUM_IQ_SAMPLES,
    SAMP_RATE,
)
from galileo_sdr_sim_tpu.ops.synth_kp import synth_batch_kp_host
from galileo_sdr_sim_tpu.scenario import PositionProvider, ScenarioEngine

STATIC = np.array([42.3601, -71.0589, 100.0])
N_EPOCHS = 20  # 2.0 s: guarantees two sync patterns 250 symbols apart
DELT = 1.0 / SAMP_RATE
SYM_SAMPLES = 10404  # ~4 ms symbol at 2.6 Msps


@pytest.fixture(scope="module")
def scene(nav, g0):
    eng = ScenarioEngine(
        nav, PositionProvider(llh_deg=STATIC), g0,
        duration_s=0.1 * N_EPOCHS + 0.3,
    )
    tabs, iq, total = [], [], 0
    for batch in eng.batches(4):
        iq.append(synth_batch_kp_host(batch, NUM_IQ_SAMPLES))
        tabs.append(batch)
        total += batch.f_code.shape[0]
        if total >= N_EPOCHS:
            break
    x16 = np.concatenate(iq)[:N_EPOCHS].reshape(-1)
    x = x16[0::2].astype(np.float64) + 1j * x16[1::2].astype(np.float64)
    return tabs, x


def _epoch_map(tabs):
    off, m = 0, {}
    for batch in tabs:
        for e in range(batch.f_code.shape[0]):
            m[off + e] = (batch, e)
        off += batch.f_code.shape[0]
    return m


def _demod_channel(tabs, x, slot):
    """Open-loop wipe of channel `slot`: per epoch, per symbol window,
    correlate against the E1B and E1C replicas at the engine's exact
    phase seeds.  Returns rows (abs_start_sample, epoch, window_k,
    data_corr, pilot_corr); windows shorter than half a symbol are
    skipped (epoch-edge partials)."""
    by_epoch = _epoch_map(tabs)
    bocB = boc_chips("E1B")
    bocC = boc_chips("E1C")
    rows = []
    n = np.arange(NUM_IQ_SAMPLES)
    for eg in range(N_EPOCHS):
        batch, e = by_epoch[eg]
        prn = int(batch.prn[slot])
        assert prn > 0
        cB = bocB[prn - 1].astype(np.float64)
        cC = bocC[prn - 1].astype(np.float64)
        seg = x[eg * NUM_IQ_SAMPLES:(eg + 1) * NUM_IQ_SAMPLES]
        cp = batch.code_phase0[e, slot] + batch.f_code[e, slot] * DELT * n
        k_win = np.floor(cp / CA_SEQ_LEN_E1).astype(int)
        chip = np.floor(2.0 * np.mod(cp, CA_SEQ_LEN_E1)).astype(int)
        ph = batch.carr_phase0[e, slot] + batch.f_carr[e, slot] * DELT * n
        base = seg * np.exp(-2j * np.pi * ph)
        for k in range(k_win.max() + 1):
            m = k_win == k
            if m.sum() < SYM_SAMPLES // 2:
                continue
            d = np.sum(base[m] * cB[chip[m]]).real
            p = np.sum(base[m] * cC[chip[m]]).real
            rows.append((eg * NUM_IQ_SAMPLES + np.argmax(m), eg, k, d, p))
    return rows


def test_symbol_transport_exact(scene):
    """Demodulated data-symbol signs == transmitted sym_win symbols, and
    pilot correlation signs == secondary-code chips, for every channel."""
    tabs, x = scene
    by_epoch = _epoch_map(tabs)
    n_checked = 0
    for slot in range(len(tabs[0].prn)):
        if tabs[0].prn[slot] <= 0:
            continue
        rows = _demod_channel(tabs, x, slot)
        assert len(rows) >= 250
        for (n0, eg, k, d, p) in rows:
            batch, e = by_epoch[eg]
            want_d = batch.sym_win[e, slot, k]
            want_p = batch.pilot_win[e, slot, k]
            # mix is  chip_b * d  -  chip_c * s  (galileo-sdr.cpp:520)
            assert np.sign(d) == want_d, (slot, eg, k, d, want_d)
            assert np.sign(p) == -want_p, (slot, eg, k, p, want_p)
            n_checked += 1
    assert n_checked > 1000


def test_frame_sync_recovered_from_waveform(scene):
    """The 10-symbol sync pattern must appear in the demodulated stream
    at 250-symbol frame spacing — receiver-style frame alignment with no
    use of the transmitter's page metadata."""
    tabs, x = scene
    slot = next(i for i, p in enumerate(tabs[0].prn) if p > 0)
    rows = sorted(_demod_channel(tabs, x, slot))
    # dedupe epoch-boundary splits of the same symbol by start sample
    syms, last_n0 = [], -10 ** 9
    for (n0, eg, k, d, p) in rows:
        if n0 - last_n0 < SYM_SAMPLES // 2:
            continue
        last_n0 = n0
        syms.append(1 if d > 0 else 0)
    syms = np.asarray(syms, dtype=np.uint8)
    assert len(syms) >= 480
    # transmitted convention: page bit 1 -> symbol -1 (i.e. demod sign<0)
    sync = np.where(sync_pattern() > 0, 0, 1).astype(np.uint8)
    hits = [
        i for i in range(len(syms) - 10)
        if np.array_equal(syms[i:i + 10], sync)
    ]
    assert hits, "sync pattern not found in demodulated stream"
    # a 10-bit pattern also occurs by chance in data (~0.5 expected per
    # 500 symbols); like a real receiver, confirm frame alignment by
    # periodicity: some pair of hits exactly one 250-symbol frame apart
    assert any(
        b - a == 250 for a in hits for b in hits if b > a
    ), f"no 250-symbol-periodic sync pair in {hits}"
