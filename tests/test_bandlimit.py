"""Band-limited CBOC output mode (ops/bandlimit.py, --bandlimit).

Correctness is pinned against the DIRECT construction the
band-limited-equivalence fixture uses (tests/test_cboc.py:255-266):
interleave the engine's twelve phase streams into the true 31.2 Msps
waveform, convolve with the same 385-tap low-pass, decimate by 12 —
the production polyphase path must reproduce that to int16 truncation,
including across streaming block boundaries."""

import numpy as np
import pytest

from galileo_sdr_sim_tpu.models.cboc import E1_CBOC
from galileo_sdr_sim_tpu.ops.bandlimit import (
    OS,
    V0,
    initial_state,
    lowpass_taps,
    phase_shift_batch,
    synth_block_cboc_bandlimited,
)
from galileo_sdr_sim_tpu.ops.synth_kp import P_GRID, ROWS, synth_batch_kp_host
from galileo_sdr_sim_tpu.scenario import PositionProvider, ScenarioEngine

NS = ROWS * P_GRID  # 10400-sample test epochs
STATIC = np.array([42.3601, -71.0589, 100.0])


@pytest.fixture(scope="module")
def cboc_engine(nav, g0):
    return ScenarioEngine(
        nav, PositionProvider(llh_deg=STATIC), g0, duration_s=2.0,
        model=E1_CBOC,
    )


@pytest.fixture(scope="module")
def blocks(cboc_engine):
    return list(cboc_engine.batches(4))[:4]


def _direct_reference(batches):
    """Ground truth: interleave the 12 pointwise phase streams into the
    31.2 Msps waveform, filter with the same taps, decimate by 12."""
    his = []
    for batch in batches:
        phases = [
            synth_batch_kp_host(phase_shift_batch(batch, j), NS)
            for j in range(OS)
        ]
        B = batch.f_code.shape[0]
        for b in range(B):
            cx = [p[b, 0::2] + 1j * p[b, 1::2] for p in phases]
            hi = np.empty(OS * NS, np.complex128)
            for j in range(OS):
                hi[j::OS] = cx[j]
            his.append(hi)
    hi = np.concatenate(his)
    h = lowpass_taps()
    lo = np.convolve(hi, h, mode="same")[::OS]
    return lo


def test_polyphase_equals_direct_highrate_filter(blocks):
    """The production polyphase path == direct high-rate conv+decimate,
    to int16 truncation (+-1 on exact-boundary trunc), over multiple
    streamed blocks with the overlap state carried across boundaries."""
    direct = _direct_reference(blocks)

    outs = []
    state = initial_state()
    cache: dict = {}
    for batch in blocks:
        out, state = synth_block_cboc_bandlimited(
            batch, NS, pad_epochs=4, code_cache=cache,
            state=state,
        )
        out = np.asarray(out)[: batch.f_code.shape[0]]
        outs.append(out.reshape(-1))
    got = np.concatenate(outs)
    got_cx = got[0::2].astype(np.float64) + 1j * got[1::2].astype(np.float64)

    # the emitted stream is delayed by V0 samples (module docstring):
    # got[i] corresponds to direct[i - V0]
    n = got_cx.size
    a = got_cx[V0:n]
    b = direct[: n - V0]
    err_i = np.abs(a.real - np.trunc(b.real))
    err_q = np.abs(a.imag - np.trunc(b.imag))
    # trunc of values straddling an integer can differ by 1 between the
    # f32 device filter and the f64 direct conv
    assert np.percentile(err_i, 99.9) <= 1.0, np.percentile(err_i, 99.9)
    assert err_i.max() <= 2 and err_q.max() <= 2, (err_i.max(), err_q.max())
    # and the block boundaries are seamless: check the samples around
    # each 4-epoch boundary explicitly
    for edge in (4 * NS, 8 * NS, 12 * NS):
        seg = slice(edge - 20, edge + 20)
        assert np.abs(
            a[seg].real - np.trunc(b[seg].real)
        ).max() <= 2


def test_bandlimit_suppresses_folded_sc6(blocks):
    """The physically meaningful claim: the pointwise stream's ALIASED
    sc6 content — which correlates against the sc6-residual replica at
    ~0.42 relative to the sine correlator (measured; beta = 0.30 is the
    unaliased value) — is suppressed ~4.6x by the band-limit path
    (measured 0.091).  Band-edge spectral power (|f| > 1.27 MHz, the
    start of the filter transition inside Nyquist) drops accordingly
    (measured 0.60% vs 2.1% of total)."""
    from galileo_sdr_sim_tpu import codes
    from galileo_sdr_sim_tpu.constants import SAMP_RATE
    from galileo_sdr_sim_tpu.constants import CA_SEQ_LEN_E1 as L
    from galileo_sdr_sim_tpu.models.cboc import ALPHA

    batch = blocks[0]
    state = initial_state()
    out, _ = synth_block_cboc_bandlimited(
        batch, NS, pad_epochs=4, state=state
    )
    bl = np.asarray(out)[0]
    pw = synth_batch_kp_host(batch, NS)[0]

    def edge_ratio(x):
        cx = x[0::2].astype(np.float64) + 1j * x[1::2]
        spec = np.abs(np.fft.fft(cx * np.hanning(cx.size))) ** 2
        f = np.fft.fftfreq(cx.size, 1.0 / 2.6e6)
        return spec[np.abs(f) > 1.27e6].sum() / spec.sum()

    assert edge_ratio(bl) < edge_ratio(pw) / 2.0, (
        edge_ratio(bl), edge_ratio(pw)
    )

    act = np.flatnonzero(batch.prn > 0)
    prn = int(batch.prn[act[0]])
    fd = float(batch.f_carr[0, act[0]])
    cp0 = float(batch.code_phase0[0, act[0]])
    f_code = float(batch.f_code[0, act[0]])
    t = np.arange(NS) / SAMP_RATE
    cp = (cp0 + f_code * t) % L
    tab = E1_CBOC.data_codes[prn - 1].astype(np.float64)
    sine = codes.boc_chips("E1B")[prn - 1].astype(np.float64)
    rep_m = tab[np.floor(12 * cp).astype(np.int64)]
    rep_s = sine[np.floor(2 * cp).astype(np.int64)]
    resid = rep_m - ALPHA * rep_s  # the sc6 component alone

    def sc6_ratio(x, delay=0):
        cx = x[0::2].astype(np.float64) + 1j * x[1::2]
        if delay:
            cx = np.roll(cx, -delay)
        xw = cx * np.exp(-2j * np.pi * fd * t)
        g_r = abs(np.vdot(resid, xw)) / np.linalg.norm(resid)
        g_s = abs(np.vdot(rep_s, xw)) / np.linalg.norm(rep_s)
        return g_r / g_s

    r_pw = sc6_ratio(pw)
    r_bl = sc6_ratio(bl, delay=V0)
    assert r_pw > 0.3, r_pw  # aliased sc6 is strong in the pointwise stream
    assert r_bl < 0.15, r_bl  # and filtered out of the band-limited one
    assert r_bl < r_pw / 3.0, (r_bl, r_pw)


def test_streaming_synthesizer_bandlimit_path(nav, g0):
    """The --bandlimit executor path: same bytes as calling the block
    function directly, and the model/engine guards fire."""
    from galileo_sdr_sim_tpu.io.stream import StreamingSynthesizer

    from conftest import CollectSink as Collect

    eng = ScenarioEngine(
        nav, PositionProvider(llh_deg=STATIC), g0, duration_s=1.0,
        model=E1_CBOC,
    )
    sink = Collect()
    StreamingSynthesizer(
        eng, sink, synth_engine="kp", nsamples=NS, block_epochs=4,
        bandlimit=True,
    ).run()
    got = np.concatenate(sink.blocks).reshape(-1)

    eng2 = ScenarioEngine(
        nav, PositionProvider(llh_deg=STATIC), g0, duration_s=1.0,
        model=E1_CBOC,
    )
    state = initial_state()
    cache: dict = {}
    ref = []
    for batch in eng2.batches(4):
        out, state = synth_block_cboc_bandlimited(
            batch, NS, pad_epochs=4, code_cache=cache,
            state=state,
        )
        ref.append(np.asarray(out)[: batch.f_code.shape[0]].reshape(-1))
    np.testing.assert_array_equal(got, np.concatenate(ref))

    with pytest.raises(ValueError, match="cboc"):
        StreamingSynthesizer(
            ScenarioEngine(nav, PositionProvider(llh_deg=STATIC), g0,
                           duration_s=1.0),
            Collect(), synth_engine="kp", nsamples=NS, bandlimit=True,
        )


def test_bandlimited_stream_acquires(blocks):
    """Receiver-level smoke: a sine-BOC PCPS acquisition on the
    band-limited stream still peaks for a present PRN at its Doppler
    (the in-band alpha*sc1 component dominates; full PVT is the gated
    test_e2e_bandlimit_pvt)."""
    from galileo_sdr_sim_tpu import codes
    from galileo_sdr_sim_tpu.constants import CODE_FREQ_E1, SAMP_RATE
    from galileo_sdr_sim_tpu.constants import CA_SEQ_LEN_E1 as L

    batch = blocks[0]
    state = initial_state()
    out, _ = synth_block_cboc_bandlimited(
        batch, NS, pad_epochs=4, state=state
    )
    bl = np.asarray(out)[:2].reshape(-1)  # 2 epochs: 8 ms coherent
    pw = synth_batch_kp_host(batch, NS)[:2].reshape(-1)
    act = np.flatnonzero(batch.prn > 0)
    prn = int(batch.prn[act[0]])
    fd = float(batch.f_carr[0, act[0]])
    n = np.arange(2 * NS)
    t = n / SAMP_RATE
    idx2 = np.floor(t * 2 * CODE_FREQ_E1).astype(np.int64) % (2 * L)
    rep = codes.boc_chips("E1B")[prn - 1][idx2].astype(np.float64)
    Rf = np.conj(np.fft.fft(rep))

    def peak(x):
        cx = x[0::2].astype(np.float64) + 1j * x[1::2]
        xc = cx * np.exp(-2j * np.pi * fd * t)
        c = np.abs(np.fft.ifft(np.fft.fft(xc) * Rf))
        return c.max() / np.median(c), c.max()

    pm_bl, pk_bl = peak(bl)
    pm_pw, pk_pw = peak(pw)
    assert pm_bl > 6.0, pm_bl
    # the in-band alpha*sc1 term carries the correlation: the filtered
    # stream's absolute peak stays within ~15% of the pointwise one
    assert pk_bl > 0.8 * pk_pw, (pk_bl, pk_pw)


@pytest.mark.skipif(
    "RUN_BANDLIMIT_PVT" not in __import__("os").environ,
    reason="12x synthesis of a 19 s scene is minutes on the CPU backend; "
    "run with RUN_BANDLIMIT_PVT=1 (last run recorded in docs/bandlimit.md)",
)
def test_e2e_bandlimit_pvt(nav):
    """Full acceptance on the band-limited stream: the in-repo receiver
    (sine-BOC replicas, as the reference's GNSS-SDR eval config uses,
    cboc=false) acquires, tracks, decodes I/NAV, and produces a PVT fix
    from a 19 s --bandlimit scene — the constant V0-sample stream delay
    lands in the receiver clock bias, not the position."""
    from galileo_sdr_sim_tpu import geodesy
    from galileo_sdr_sim_tpu.constants import NUM_IQ_SAMPLES, R2D
    from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
    from galileo_sdr_sim_tpu.io.stream import StreamingSynthesizer
    from galileo_sdr_sim_tpu.rx_pvt import receiver_fix
    from galileo_sdr_sim_tpu.rx_track import iq_to_complex
    from galileo_sdr_sim_tpu.scenario import scenario_start_time

    g0 = scenario_start_time(nav, date2gal(DateTime(2022, 2, 20, 8, 0, 18)))
    eng = ScenarioEngine(
        nav, PositionProvider(llh_deg=STATIC), g0, duration_s=19.0,
        model=E1_CBOC,
    )

    from conftest import CollectSink as Collect

    sink = Collect()
    StreamingSynthesizer(
        eng, sink, synth_engine="kp", block_epochs=8, bandlimit=True,
        nsamples=NUM_IQ_SAMPLES,
    ).run()
    x16 = np.concatenate(
        [b for b in sink.blocks if b.shape[0] == 8]
    ).reshape(-1).astype(np.int16)
    assert x16.size >= 18.0 * 2 * 2.6e6
    prns = sorted(c.prn for c in eng.bank.channels if c.prn > 0)
    fix = receiver_fix(iq_to_complex(x16), prn_candidates=prns)
    assert fix is not None, "no fix from the band-limited stream"
    sol = fix.solution
    assert sol.n_sats >= 5, sol.prns
    truth = geodesy.llh2xyz(
        np.array([STATIC[0] / R2D, STATIC[1] / R2D, STATIC[2]])
    )
    err = float(np.linalg.norm(sol.xyz - truth))
    assert err < 20.0, f"band-limited fix error {err:.2f} m ({sol.prns})"


def test_bandlimit_checkpoint_resume_seam(nav, g0, tmp_path):
    """Resume of a --bandlimit run restarts the filter overlap state at
    zeros (docs/bandlimit.md known seam): the resumed stream must equal
    the uninterrupted run everywhere EXCEPT a bounded transient in the
    first filter-length of samples after the resume point."""
    from galileo_sdr_sim_tpu.io.stream import StreamingSynthesizer

    from conftest import CollectSink as Collect

    def mk():
        return ScenarioEngine(
            nav, PositionProvider(llh_deg=STATIC), g0, duration_s=2.0,
            model=E1_CBOC,
        )

    ref_sink = Collect()
    StreamingSynthesizer(
        mk(), ref_sink, synth_engine="kp", nsamples=NS, block_epochs=2,
        bandlimit=True,
    ).run()
    ref = np.concatenate(ref_sink.blocks).reshape(-1)

    ck = str(tmp_path / "bl_ckpt")
    s1_sink = Collect(stop_after=3)
    s1 = StreamingSynthesizer(
        mk(), s1_sink, synth_engine="kp", nsamples=NS, block_epochs=2,
        bandlimit=True, checkpoint_path=ck, checkpoint_every=2,
    )
    s1_sink.synth = s1
    s1.run()
    drained = sum(b.shape[0] for b in s1_sink.blocks)

    s2_sink = Collect()
    StreamingSynthesizer(
        mk(), s2_sink, synth_engine="kp", nsamples=NS, block_epochs=2,
        bandlimit=True, checkpoint_path=ck, checkpoint_every=10_000,
    ).run()
    combined = np.concatenate(s1_sink.blocks + s2_sink.blocks).reshape(-1)
    assert combined.shape == ref.shape
    # pre-resume: identical; post-resume: identical after the transient
    pre = slice(0, drained * 2 * NS)
    np.testing.assert_array_equal(combined[pre], ref[pre])
    seam = 2 * 64  # 2*V0 low-rate samples x I/Q, with margin
    post = slice(drained * 2 * NS + seam, None)
    np.testing.assert_array_equal(combined[post], ref[post])


def test_bandlimit_applies_gain(blocks):
    """--bandlimit must honor --apply-gain (advisor r5 review finding:
    the gain was silently dropped in this mode): with per-channel
    path-loss gain (normalized <= 1) the filtered stream's mean
    amplitude drops relative to the ungained stream."""
    batch = blocks[0]
    out_ng, _ = synth_block_cboc_bandlimited(
        batch, NS, pad_epochs=4, state=initial_state()
    )
    out_g, _ = synth_block_cboc_bandlimited(
        batch, NS, pad_epochs=4, state=initial_state(),
        apply_gain=True,
    )
    a = np.abs(np.asarray(out_ng)[0].astype(np.int32)).mean()
    b = np.abs(np.asarray(out_g)[0].astype(np.int32)).mean()
    assert b < 0.98 * a, (a, b)



def test_streaming_bandlimit_forwards_apply_gain(nav, g0):
    """The executor's bandlimit branch forwards apply_gain (it was
    silently dropped before the r5 review fix)."""
    from galileo_sdr_sim_tpu.io.stream import StreamingSynthesizer

    from conftest import CollectSink as Collect

    def run(apply_gain):
        eng = ScenarioEngine(
            nav, PositionProvider(llh_deg=STATIC), g0,
            duration_s=0.5, model=E1_CBOC,
        )
        sink = Collect()
        StreamingSynthesizer(
            eng, sink, synth_engine="kp", nsamples=NS, block_epochs=4,
            bandlimit=True, apply_gain=apply_gain,
        ).run()
        return np.concatenate(sink.blocks)

    a = np.abs(run(False).astype(np.int32)).mean()
    b = np.abs(run(True).astype(np.int32)).mean()
    assert b < 0.98 * a, (a, b)


def test_filter_highest_precision_matches_float64_reference():
    """The f32 polyphase conv (Precision.HIGHEST) against a float64
    NumPy convolution truncated to int16: at most 1 LSB, almost always
    identical (f32 sums of 12 x 33 taps against the exact float64 sum)."""
    import jax.numpy as jnp

    from galileo_sdr_sim_tpu.ops.bandlimit import OS, V0, _filter_block
    from galileo_sdr_sim_tpu.ops.oracle import bandlimit_filter_oracle

    rng = np.random.default_rng(3)
    stacked = rng.normal(0, 900, (OS, 3, 2 * 2600)).astype(np.int16)
    hist = rng.normal(0, 600, (2, OS, 2 * V0)).astype(np.float32)
    out, new_hist = _filter_block(
        jnp.asarray(stacked), jnp.asarray(hist), jnp.int32(2)
    )
    ref, ref_hist = bandlimit_filter_oracle(stacked, hist, 2)
    d = np.abs(np.asarray(out).astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.999, (d == 0).mean()
    np.testing.assert_allclose(np.asarray(new_hist), ref_hist, atol=1e-3)
