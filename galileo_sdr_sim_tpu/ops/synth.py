"""Device-side baseband synthesis (XLA path).

Data-parallel reformulation of the reference's sequential NCO loop
(reference: src/galileo-sdr.cpp:481-539).  Within one 0.1 s epoch the
carrier/code frequencies are constant, so both NCO phases are affine in
the sample index; the whole epoch is computed data-parallel:

* The host seeds each tile of `TILE` samples with float64-exact
  (code_phase, wrap_count, carrier_phase) bases (`prepare_device_inputs`),
  so on-device math is pure float32 with bounded error (< 1e-3 chip,
  < 1e-4 cycle per tile) and *no* cross-tile or cross-epoch accumulation.
* Chips come from (MAX_CHAN, subdiv*4092) code-value slabs supplied by
  the signal model (int8 sine-BOC half-chips for E1 OS; float32 CBOC
  value tables for models/cboc.py); idle channel rows are zero, so
  inactive slots contribute nothing without masking.
* Data/pilot symbols come from per-epoch 32-symbol windows indexed by the
  code-period wrap count.
* Carrier: either float32 sin/cos at amplitude 250 (default — better SNR)
  or the reference's 512-entry integer LUT with C truncation semantics
  (`mode='lut512'`, used for oracle parity tests).

`synth_accum` returns the float32 channel-summed accumulator so that a
satellite-sharded mesh can `psum` partial sums before quantization
(parallel/mesh.py); `quantize_iq` applies the reference's int16 truncation.
The output is interleaved int16 I/Q identical in format to the reference's
file sink.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..codes import carrier_lut
from ..constants import CA_SEQ_LEN_E1, LUT_AMPLITUDE, NUM_IQ_SAMPLES, SAMP_RATE
from ..scenario import EpochBatch

DELT = 1.0 / SAMP_RATE
# samples per seeded tile.  The f32 phase error grows with the tile
# (a*j reaches ~0.4*TILE chips): at 32768 the GPU's lut512 stream fell
# below the reference-loop bound of tests/test_hotloop_ref_ab.py (corr
# 0.99884 < 0.999 on an H100), at 4096 it holds (corr >= 0.99952).  The
# smaller tile costs device time at B=1 on an H100 (lut512 62 vs 47 us
# per 0.1 s epoch) and none at B=8 (PERF.md)
TILE = 4096


def padded_samples(nsamples: int, tile: int = TILE) -> int:
    return -(-nsamples // tile) * tile


def prepare_device_inputs(
    batch: EpochBatch,
    tile: int = TILE,
    nsamples: int = NUM_IQ_SAMPLES,
    pad_epochs: int | None = None,
    code_cache: dict | None = None,
) -> dict:
    """Host-side float64 tile seeding -> float32/int32 device arrays.

    `pad_epochs` pads the epoch axis (repeating the last epoch) so every
    call hits one compiled shape; the caller truncates the output.
    `code_cache` (a plain dict the caller owns) reuses the on-device code
    slabs while the channel->PRN map is unchanged — the slabs are the
    largest upload and only change at 30 s reallocation boundaries.
    """
    if pad_epochs is not None and batch.f_code.shape[0] != pad_epochs:
        batch = _pad_batch(batch, pad_epochs)
    B, C = batch.f_code.shape
    npad = padded_samples(nsamples, tile)
    nt = npad // tile

    t0 = (np.arange(nt) * tile).astype(np.float64)  # (nt,)
    a = batch.f_code * DELT  # chips/sample (B, C)
    total0 = batch.code_phase0[:, :, None] + a[:, :, None] * t0  # (B, C, nt)
    w_base = np.floor(total0 / CA_SEQ_LEN_E1)
    cp_base = total0 - w_base * CA_SEQ_LEN_E1

    fc = batch.f_carr * DELT  # cycles/sample (B, C)
    carr0 = batch.carr_phase0[:, :, None] + fc[:, :, None] * t0
    carr_base = carr0 - np.trunc(carr0)

    key = batch.prn.tobytes()
    if code_cache is not None and code_cache.get("key") == key:
        codes_b, codes_c = code_cache["b"], code_cache["c"]
    else:
        codes_b = jnp.asarray(batch.codes_b)
        codes_c = jnp.asarray(batch.codes_c)
        if code_cache is not None:
            code_cache.update(key=key, b=codes_b, c=codes_c)

    return dict(
        codes_b=codes_b,
        codes_c=codes_c,
        a=jnp.asarray(a, jnp.float32),
        fc=jnp.asarray(fc, jnp.float32),
        cp_base=jnp.asarray(cp_base, jnp.float32),
        w_base=jnp.asarray(w_base, jnp.int32),
        carr_base=jnp.asarray(carr_base, jnp.float32),
        sym_win=jnp.asarray(batch.sym_win),
        pilot_win=jnp.asarray(batch.pilot_win),
    )


def _pad_batch(batch: EpochBatch, B: int) -> EpochBatch:
    """Repeat the last epoch up to B rows (device output is truncated)."""
    import dataclasses

    n = batch.f_code.shape[0]
    assert n <= B

    def pad(x):
        reps = np.concatenate([x, np.repeat(x[-1:], B - n, axis=0)])
        return reps

    return dataclasses.replace(
        batch,
        grx_sec=pad(batch.grx_sec),
        f_carr=pad(batch.f_carr),
        f_code=pad(batch.f_code),
        code_phase0=pad(batch.code_phase0),
        carr_phase0=pad(batch.carr_phase0),
        sym_win=pad(batch.sym_win),
        pilot_win=pad(batch.pilot_win),
        gain=pad(batch.gain),
    )


def _gather_codes(codes: jax.Array, icode: jax.Array) -> jax.Array:
    """codes (C, H) int8, icode (B, C, nt, T) -> chips (B, C, nt, T)."""
    return jax.vmap(lambda tab, idx: tab[idx], in_axes=(0, 1), out_axes=1)(
        codes, icode
    )


def synth_accum(
    codes_b: jax.Array,  # (C, subdiv*4092) int8 or f32
    codes_c: jax.Array,
    a: jax.Array,  # (B, C) f32 chips/sample
    fc: jax.Array,  # (B, C) f32 cycles/sample
    cp_base: jax.Array,  # (B, C, nt) f32
    w_base: jax.Array,  # (B, C, nt) i32
    carr_base: jax.Array,  # (B, C, nt) f32
    sym_win: jax.Array,  # (B, C, W) i8
    pilot_win: jax.Array,  # (B, C, W) i8
    *,
    tile: int = TILE,
    mode: str = "float",
) -> jax.Array:
    """Channel-summed float32 I/Q accumulator, shape (B, nt, T, 2)."""
    B, C, nt = cp_base.shape

    j = jnp.arange(tile, dtype=jnp.float32)  # (T,)
    total = cp_base[..., None] + a[:, :, None, None] * j  # (B,C,nt,T)
    # wrap count within the tile: tiles can span several code periods.
    # f32 rounding at period boundaries can land rem a hair outside
    # [0, 4092); the clip bounds the half-chip index, costing at most a
    # one-ULP-late chip transition.
    wrap = jnp.floor(total * jnp.float32(1.0 / CA_SEQ_LEN_E1)).astype(jnp.int32)
    rem = total - jnp.float32(CA_SEQ_LEN_E1) * wrap
    # subcarrier subdivisions per chip, inferred from the code-table
    # width: 2 for the sine-BOC(1,1) half-chip banks, 12 for the CBOC
    # (6,1,1/11) value tables (models/cboc.py) — the signal model picks
    # the waveform purely through the tables it supplies
    subdiv = codes_b.shape[1] // CA_SEQ_LEN_E1
    icode = jnp.clip(
        (float(subdiv) * rem).astype(jnp.int32), 0, codes_b.shape[1] - 1
    )

    chip_b = _gather_codes(codes_b, icode)
    chip_c = _gather_codes(codes_c, icode)

    k = w_base[..., None] + wrap  # (B, C, nt, T) in [0, SYM_WIN)
    k_flat = k.reshape(B, C, nt * tile)
    d = jnp.take_along_axis(sym_win, k_flat, axis=2).reshape(k.shape)
    s = jnp.take_along_axis(pilot_win, k_flat, axis=2).reshape(k.shape)

    m = (chip_b * d - chip_c * s).astype(jnp.float32)  # in {-2, 0, 2}

    phase = carr_base[..., None] + fc[:, :, None, None] * j
    phase = phase - jnp.trunc(phase)

    if mode == "lut512":
        cos512, sin512 = carrier_lut()
        itab = (511.0 * phase).astype(jnp.int32) & 511
        cosph = jnp.asarray(cos512, jnp.float32)[itab]
        sinph = jnp.asarray(sin512, jnp.float32)[itab]
    else:
        ang = (2.0 * jnp.float32(np.pi)) * phase
        cosph = jnp.cos(ang) * LUT_AMPLITUDE
        sinph = jnp.sin(ang) * LUT_AMPLITUDE

    i_acc = jnp.sum(m * cosph, axis=1)  # (B, nt, T)
    q_acc = jnp.sum(m * sinph, axis=1)
    return jnp.stack([i_acc, q_acc], axis=-1)  # (B, nt, T, 2)


def quantize_iq(acc: jax.Array) -> jax.Array:
    """float32 accumulator -> interleaved int16 (B, 2*npad), matching the
    reference's C truncation `(short)i_acc` (galileo-sdr.cpp:536-537)."""
    B = acc.shape[0]
    return jnp.trunc(acc).astype(jnp.int16).reshape(B, -1)


@functools.partial(jax.jit, static_argnames=("tile", "mode"))
def synth_block(inputs: dict, tile: int = TILE, mode: str = "float") -> jax.Array:
    """Synthesize a block of epochs -> interleaved int16 (B, 2*npad)."""
    acc = synth_accum(
        inputs["codes_b"],
        inputs["codes_c"],
        inputs["a"],
        inputs["fc"],
        inputs["cp_base"],
        inputs["w_base"],
        inputs["carr_base"],
        inputs["sym_win"],
        inputs["pilot_win"],
        tile=tile,
        mode=mode,
    )
    return quantize_iq(acc)


def synth_batch_host(
    batch: EpochBatch,
    tile: int = TILE,
    mode: str = "float",
    nsamples: int = NUM_IQ_SAMPLES,
) -> np.ndarray:
    """Convenience wrapper: batch -> (B, 2*nsamples) int16 on host."""
    inputs = prepare_device_inputs(batch, tile, nsamples)
    out = synth_block(inputs, tile=tile, mode=mode)
    return np.asarray(out)[:, : 2 * nsamples]
