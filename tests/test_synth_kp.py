"""Factorized (K,p) production engine tests (ops/synth_kp.py).

Validates the gather-free reformulation against the direct XLA path and
the float64 oracle.  Small sample counts keep CPU compiles tolerable.
"""

import numpy as np
import pytest

from galileo_sdr_sim_tpu.constants import LUT_AMPLITUDE
from galileo_sdr_sim_tpu.ops.oracle import synth_epoch_oracle
from galileo_sdr_sim_tpu.ops.synth import prepare_device_inputs, synth_block
from galileo_sdr_sim_tpu.ops.synth_kp import (
    P_GRID,
    compact_channels,
    prepare_kp_inputs,
    synth_batch_kp_host,
    synth_block_kp,
)

NS = 10400  # one (8 x 1300) row cycle


@pytest.fixture(scope="module")
def kp_out(batch_1s):
    return synth_batch_kp_host(batch_1s, NS)


@pytest.fixture(scope="module")
def direct_out(batch_1s):
    inp = prepare_device_inputs(batch_1s, tile=512, nsamples=NS)
    return np.asarray(synth_block(inp, tile=512, mode="float"))[:, : 2 * NS]


def test_matches_direct_path(batch_1s, kp_out, direct_out):
    """Sample-exact up to chip-transition timing ULPs.

    On the 08:00:01 scene (CPU): identity 0.99851-0.99918 and corr
    0.99943-0.99981 per epoch; the few differing samples are single
    chip-transition flips, at most 4*LUT_AMPLITUDE (measured max 1000).
    The correlation bound is the one of tests/test_hotloop_ref_ab.py."""
    for e in range(kp_out.shape[0]):
        exact = (kp_out[e] == direct_out[e]).mean()
        corr = np.corrcoef(
            kp_out[e].astype(float), direct_out[e].astype(float)
        )[0, 1]
        diff = np.abs(kp_out[e].astype(np.int32) - direct_out[e])
        assert exact > 0.995, f"epoch {e}: exact {exact}"
        assert corr > 0.999, f"epoch {e}: corr {corr}"
        assert diff.max() <= 4 * LUT_AMPLITUDE, f"epoch {e}: {diff.max()}"


def test_tracks_oracle(batch_1s, kp_out):
    oracle = synth_epoch_oracle(batch_1s, 0, nsamples=NS)
    corr = np.corrcoef(kp_out[0].astype(float), oracle.astype(float))[0, 1]
    assert corr > 0.995  # float carrier vs LUT carrier


def test_compact_channels(batch_1s):
    c = compact_channels(batch_1s)
    n_active = int((batch_1s.prn > 0).sum())
    expect = max(8, -(-n_active // 8) * 8)
    assert c.f_code.shape[1] == min(expect, batch_1s.f_code.shape[1])
    assert set(c.prn[c.prn > 0]) == set(batch_1s.prn[batch_1s.prn > 0])
    # compaction must not change the signal AT ALL: with the explicit
    # left-to-right channel add chain (synth_accum_kp), dropping idle
    # zero rows removes exact +0.0 terms from the sum, which is an f32
    # identity — so compacted and uncompacted int16 streams are equal
    # bit for bit (this was only ~4-nines true when jnp.sum's shape-
    # dependent reduction order could reassociate the sum)
    full = synth_batch_kp_host(batch_1s, NS)
    inp = prepare_kp_inputs(batch_1s, NS, compact=False)
    uncompacted = np.asarray(synth_block_kp(inp, n_k=NS // P_GRID))[:, : 2 * NS]
    assert np.array_equal(full, uncompacted)


def test_pad_epochs(batch_1s):
    inp = prepare_kp_inputs(batch_1s, NS, pad_epochs=8)
    out = np.asarray(synth_block_kp(inp, n_k=NS // P_GRID))
    n_real = batch_1s.f_code.shape[0]
    direct = synth_batch_kp_host(batch_1s, NS)
    assert np.array_equal(out[:n_real, : 2 * NS], direct)


def test_kp_sharded_matches(batch_1s, kp_out):
    from galileo_sdr_sim_tpu.parallel.mesh import make_mesh, synth_batch_kp_sharded

    mesh = make_mesh(2, 2)
    out = synth_batch_kp_sharded(batch_1s, mesh, nsamples=NS, pad_epochs=8)
    n_real = batch_1s.f_code.shape[0]
    # psum partial-sum association differs from a single-device reduction
    assert (out[:n_real] == kp_out).mean() > 0.999


def test_apply_gain(batch_1s):
    """Gain weighting scales per-channel amplitudes without clipping."""
    base = synth_batch_kp_host(batch_1s, NS)
    inp = prepare_kp_inputs(batch_1s, NS, apply_gain=True)
    weighted = np.asarray(synth_block_kp(inp, n_k=NS // P_GRID))[:, : 2 * NS]
    # weighted signal has strictly less power (gains <= 1) but same format
    assert np.abs(weighted).max() <= np.abs(base).max()
    p_base = np.mean(base[0].astype(float) ** 2)
    p_w = np.mean(weighted[0].astype(float) ** 2)
    assert 0.05 * p_base < p_w < p_base


def test_gain_is_separate_operand_not_window_amplitude(batch_1s):
    """apply_gain never scales the symbol windows; it rides as a (B, C)
    chan_gain operand applied to the per-channel mix."""
    inputs = prepare_kp_inputs(batch_1s, NS, apply_gain=True)
    assert "chan_gain" in inputs
    g = np.asarray(inputs["chan_gain"])
    assert g.max() <= 1.0 + 1e-6 and (g > 0).any()
    # windows stayed pure signs
    for k in ("sym_win", "pilot_win"):
        w = np.asarray(inputs[k])
        assert set(np.unique(np.abs(w))) <= {0.0, 1.0}, k


def test_xla_gain_scales_each_channel(batch_1s):
    """f32 accumulator with chan_gain == sum_c g_c * (per-channel
    accumulator without gain), to f32 tolerance."""
    import jax.numpy as jnp

    from galileo_sdr_sim_tpu.ops.synth_kp import ROWS, synth_accum_kp

    n_k = ROWS
    base = prepare_kp_inputs(batch_1s, ROWS * P_GRID)
    gained = prepare_kp_inputs(batch_1s, ROWS * P_GRID, apply_gain=True)
    acc_g = np.asarray(synth_accum_kp(gained, n_k=n_k))
    g = np.asarray(gained["chan_gain"])  # (B, C)
    B, C = g.shape
    # per-channel accumulators: zero out all other channels via a
    # one-channel gain mask (exactly 0/1 -> exact channel isolation)
    expect = np.zeros_like(acc_g)
    for c in range(C):
        one = dict(base)
        mask = np.zeros_like(g)
        mask[:, c] = 1.0
        one["chan_gain"] = jnp.asarray(mask)
        expect = expect + g[:, c, None, None] * np.asarray(
            synth_accum_kp(one, n_k=n_k)
        )
    np.testing.assert_allclose(acc_g, expect, rtol=2e-5, atol=2e-3)


def test_packed_stream_equals_flat_stream(batch_1s):
    """The packed int32 production format (synth_block_kp_packed) views
    to EXACTLY the flat interleaved int16 stream."""
    from galileo_sdr_sim_tpu.ops.synth_kp import (
        ROWS,
        packed_to_iq16,
        synth_block_kp_packed,
    )

    n_k = ROWS
    inputs = prepare_kp_inputs(batch_1s, ROWS * P_GRID)
    flat = np.asarray(synth_block_kp(inputs, n_k=n_k))
    packed = np.asarray(synth_block_kp_packed(inputs, n_k=n_k))
    assert packed.dtype == np.int32 and packed.shape == (
        flat.shape[0], n_k, P_GRID
    )
    np.testing.assert_array_equal(packed_to_iq16(packed), flat)
