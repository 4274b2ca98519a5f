"""Factorized (K, p) synthesis engine — the production path.

The direct formulation in ops/synth.py does two table gathers and a
sin/cos per channel-sample.  This engine removes *all* sample-rate
gathers and transcendentals by exploiting an exact rational relation of
the E1 signal plan:

    fs / chip_rate = 2.6e6 / 1.023e6 = 1300/1023  (exactly)

Reshape each 0.1 s epoch (260000 = 200*1300 samples) onto a grid
n = 1300*K + p.  The BOC half-chip index at (K, p) is

    H(K, p) = floor(2*cp0 + 2a*p + (1023 + mu)*K)        (mod 8184)
            = 1023*K + g(p) + delta(K, p)

with g(p) = floor(phi_p) an integer *independent of K*, and
delta(K, p) = floor(psi_p + mu*K) in {0, 1}, where mu = f_code/1000 - 1023
(|mu| <= 3e-3) is the code-Doppler drift.  Consequences:

* Only 1300 distinct flat positions g(p) (plus a +1 shift for delta=1)
  are ever read per (epoch, channel).  Both codes, both shifts, and all
  8 row offsets (1023*r) are packed side-by-side into a 32-wide row of a
  (1023, 32) table, so the whole chip fetch is ONE 32-wide row-slice
  gather per (epoch, channel, p), shared by all 200 K rows.
* Row alignment (K + q) mod 8 depends only on K mod 8, so K splits as
  (kappa, rho) = (K//8, K%8); row-aligned chip planes broadcast over
  kappa for free, built with an 8x8 masked sum on (C, p)-sized slices.
* The code-period index is exactly (K + q)//8 = kappa + ((rho + q) >= 8),
  so data/pilot symbols are two shifted slices of the per-epoch symbol
  window selected by a mask — no gather.
* The carrier phase is affine in n, hence rank-1 separable on the grid:
  cis(carr0 + fc*(1300K + p)) = cisK(K)*cisP(p); only C*(200+1300)
  sin/cos evaluations per epoch instead of C*260000.

Everything at sample rate is a short float32 elementwise chain (~20 ops
per channel-sample).  Host float64 seeds (per epoch-channel scalars only)
bound the on-device f32 phase error below ~1e-3 chip / 1e-5 cycle.

Parity: same tolerance class as the direct XLA path against the float64
oracle (chip-transition samples may differ by one timing ULP); validated
in tests/test_synth_kp.py.  ops/synth.py remains as the
arbitrary-sample-count reference implementation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import LUT_AMPLITUDE, NUM_IQ_SAMPLES, SAMP_RATE
from ..scenario import EpochBatch
from .synth import _pad_batch

DELT = 1.0 / SAMP_RATE
P_GRID = 1300  # samples per grid row: fs/chip_rate = 1300/1023 exactly
ROWS = 8  # BOC sequence rows: 8184 = 8*1023
COLS = 1023
K_EPOCH = NUM_IQ_SAMPLES // P_GRID  # 200
W_PACK = 32  # 2 codes x 2 shifts x 8 rows
# code-Doppler envelope: the delta/tap machinery assumes
# |mu| = |f_code/1000 - 1023| <= ~3e-3 half-chips per K row (true for
# any real carrier Doppler, |fd| <= ~4.6 kHz <-> ~Mach-4 receiver
# dynamics).  A live-position TELEPORT makes the pseudorange-rate-
# derived Doppler of one transition epoch exceed this (the reference
# derives rate the same way, gal-sig.cpp:311-318, and would emit one
# mega-Doppler epoch too); the streaming executor routes such epochs
# to the direct engine, which is exact for any rate.
MU_MAX = 3e-3


def mu_in_envelope(f_code: np.ndarray) -> bool:
    """True when every epoch-channel's code-Doppler drift fits the
    factorized engines' delta/tap design envelope."""
    return bool(np.abs(f_code / 1000.0 - COLS).max() <= MU_MAX)


def _pack_codes(codes_b: np.ndarray, codes_c: np.ndarray) -> np.ndarray:
    """(C, 8184) x2 int8 -> (C, 1023, 32) float32 packed row table.

    vpack[c, h, code*16 + shift*8 + r] = code_flat[c, (1023*r + h + shift) % 8184]
    """
    C = codes_b.shape[0]
    out = np.zeros((C, COLS, W_PACK), np.float32)
    for ci, flat in enumerate((codes_b, codes_c)):
        for shift in range(2):
            rolled = np.roll(flat, -shift, axis=1)  # flat[(x+shift) % 8184]
            rows = rolled.reshape(C, ROWS, COLS)  # [r, h] = flat[1023r+h+shift]
            out[:, :, ci * 16 + shift * 8 : ci * 16 + shift * 8 + ROWS] = (
                rows.transpose(0, 2, 1)
            )
    return out


def compact_channels(batch: EpochBatch, multiple: int = 8) -> EpochBatch:
    """Drop idle channel slots, keeping a channel count that is a multiple
    of `multiple`.  The channel sum is unchanged — idle rows contribute
    nothing — but the per-channel cost scales directly with the channel
    axis (on one H100 a B=64 call takes 1.70 ms of device time at 8
    channels and 3.31 ms at 16; PERF.md)."""
    import dataclasses

    active = np.flatnonzero(batch.prn > 0)
    n = max(multiple, -(-len(active) // multiple) * multiple)
    if n >= len(batch.prn):
        return batch
    keep = np.concatenate(
        [active, np.flatnonzero(batch.prn <= 0)[: n - len(active)]]
    )
    return dataclasses.replace(
        batch,
        prn=batch.prn[keep],
        f_carr=batch.f_carr[:, keep],
        f_code=batch.f_code[:, keep],
        code_phase0=batch.code_phase0[:, keep],
        carr_phase0=batch.carr_phase0[:, keep],
        sym_win=batch.sym_win[:, keep],
        pilot_win=batch.pilot_win[:, keep],
        gain=batch.gain[:, keep],
        codes_b=batch.codes_b[keep],
        codes_c=batch.codes_c[keep],
    )


def prepare_kp_inputs(
    batch: EpochBatch,
    nsamples: int = NUM_IQ_SAMPLES,
    pad_epochs: int | None = None,
    code_cache: dict | None = None,
    compact: bool = True,
    apply_gain: bool = False,
) -> dict:
    """Host float64 seeding -> per-(epoch, channel) scalars + packed codes.

    nsamples must be a multiple of 8*1300 = 10400 (one full row cycle).
    `apply_gain` weights each channel by its path-loss/antenna gain
    normalized to <= 1 (the reference computes but never applies this,
    galileo-sdr.cpp:520-521; extension, off by default).
    """
    if compact:
        batch = compact_channels(batch)
    if pad_epochs is not None and batch.f_code.shape[0] != pad_epochs:
        batch = _pad_batch(batch, pad_epochs)
    assert nsamples % (ROWS * P_GRID) == 0, nsamples
    codes_b, codes_c = batch.codes_b, batch.codes_c
    cboc_ab = None
    if codes_b.shape[1] == 6 * ROWS * COLS:
        # CBOC(6,1) 12-grid value tables (models/cboc.py) factor exactly
        # over the sine-BOC half-chip banks:
        #   V(n) = halfchip(n) * (alpha +- beta * tau(n)),
        #   tau(n) = (-1)^(H2(n) + floor(6 * frac(2 c(n))))
        # (sc6 flips sign every 1/12 chip; within a half-chip its sign
        # relative to sc1 alternates from a parity fixed by the global
        # half-chip index).  So the (K,p) engine runs CBOC by deriving
        # the +-1 banks and the (alpha, beta) weights from the model's
        # own tables and applying tau as ~10 extra elementwise ops per
        # channel-sample — no 12-grid table, no sample-rate gathers.
        # |table[12h]| = alpha + beta and |table[12h+1]| = alpha - beta
        # recover the weights; signs at sub-position 0 recover the banks.
        act = np.nonzero(np.any(codes_b, axis=1))[0]
        r0 = int(act[0]) if act.size else 0
        v0 = abs(float(codes_b[r0, 0]))
        v1 = abs(float(codes_b[r0, 1]))
        cboc_ab = np.array([(v0 + v1) / 2.0, (v0 - v1) / 2.0], np.float32)
        cboc_orig = (codes_b, codes_c)
        codes_b = np.sign(codes_b[:, ::6]).astype(np.int8)
        codes_c = np.sign(codes_c[:, ::6]).astype(np.int8)
    else:
        assert codes_b.shape[1] == ROWS * COLS, (
            "the (K,p) engines support sine-BOC(1,1) half-chip tables "
            "and 12-grid CBOC value tables; other geometries use the "
            f"direct engine (got table width {codes_b.shape[1]})"
        )

    a = batch.f_code * DELT  # chips/sample, float64
    mu = 2.0 * a * P_GRID - COLS  # half-chips of drift per K step
    fc = batch.f_carr * DELT  # cycles/sample
    fc_k = fc * P_GRID
    fc_k = fc_k - np.floor(fc_k)

    key = (batch.prn.tobytes(), batch.codes_b.shape[1])
    if code_cache is not None and code_cache.get("key") == key:
        vpack = code_cache["vpack"]
    else:
        if cboc_ab is not None:
            # Guard the factorization: any 12-subdiv table the model
            # supplies must actually decompose as
            #   data  = bank * (alpha + beta * tau),
            #   pilot = bank * (alpha - beta * tau),  tau = (-1)^(h+s)
            # (h = half-chip index, s = sub-position).  A future
            # 12-subdiv model that violates this (e.g. TMBOC-style
            # time-multiplexed weights) must not be synthesized silently
            # wrong — fail loudly and point at the direct engine.
            # Checked only when the code slabs are (re)built.
            ob, oc = cboc_orig
            n_g = np.arange(ob.shape[1])
            tau = (1 - 2 * ((n_g // 6 + n_g % 6) & 1)).astype(np.float32)
            a_w, b_w = float(cboc_ab[0]), float(cboc_ab[1])
            pred_b = codes_b[act].astype(np.float32).repeat(6, axis=1) * (
                a_w + b_w * tau
            )
            pred_c = codes_c[act].astype(np.float32).repeat(6, axis=1) * (
                a_w - b_w * tau
            )
            if not (
                np.allclose(pred_b, ob[act], atol=1e-5)
                and np.allclose(pred_c, oc[act], atol=1e-5)
            ):
                raise ValueError(
                    "12-subdiv code table does not factor as "
                    "halfchip*(alpha +/- beta*tau); the (K,p) engines "
                    "cannot synthesize it — use the direct engine "
                    "(synth_engine='direct')"
                )
        vpack = jnp.asarray(_pack_codes(codes_b, codes_c))
        if code_cache is not None:
            code_cache.update(key=key, vpack=vpack)

    # gain is a separate (B, C) operand applied to the per-channel mix;
    # the symbol windows stay +-1
    sym_f = batch.sym_win.astype(np.float32)
    pil_f = batch.pilot_win.astype(np.float32)
    chan_gain = None
    if apply_gain:
        g = batch.gain.astype(np.float64) / 128.0  # path_loss*ant (unit-ish)
        peak = max(g.max(), 1e-9)
        chan_gain = (g / peak).astype(np.float32)  # (B, C) <= 1

    # ONE device_put for all per-epoch operands instead of one transfer
    # per array (the code slabs are cached on device separately)
    host = dict(
        cp0=np.asarray(batch.code_phase0, np.float32),  # (B, C) [chips]
        two_a=np.asarray(2.0 * a, np.float32),  # half-chips/sample
        mu=np.asarray(mu, np.float32),
        carr0=np.asarray(batch.carr_phase0, np.float32),
        fc=np.asarray(fc, np.float32),
        fc_k=np.asarray(fc_k, np.float32),
        sym_win=sym_f,  # (B, C, 32) ±1
        pilot_win=pil_f,
    )
    if cboc_ab is not None:
        host["cboc_ab"] = cboc_ab  # (2,) f32 (alpha, beta)
    if chan_gain is not None:
        host["chan_gain"] = chan_gain  # (B, C) f32 <= 1
    out = jax.device_put(host)
    out["vpack"] = vpack  # (C, 1023, 32) f32 (device-cached)
    return out


def synth_accum_kp(inputs: dict, n_k: int) -> jax.Array:
    """float32 channel-summed accumulator (B, n_k*1300, 2) — separate from
    quantization so a satellite-sharded mesh can psum partials."""
    cp0 = inputs["cp0"]
    B, C = cp0.shape
    n_kap = n_k // ROWS

    p = jnp.arange(P_GRID, dtype=jnp.float32)
    kap = jnp.arange(n_kap, dtype=jnp.float32)
    rho = jnp.arange(ROWS, dtype=jnp.float32)

    # --- per-p integer geometry (B, C, p) -----------------------------
    phi = 2.0 * cp0[..., None] + inputs["two_a"][..., None] * p  # [0, 9207)
    mu = inputs["mu"][..., None]  # (B, C, 1)
    gb = jnp.floor(phi) + jnp.where(mu < 0, -1.0, 0.0)
    psi = phi - gb  # [0,1) for mu>=0, [1,2) for mu<0
    gbm = jnp.mod(gb, float(ROWS * COLS))  # [0, 8184)
    q0 = jnp.floor(gbm * (1.0 / COLS))  # [0, 8)
    rp0 = gbm - q0 * COLS  # [0, 1023)
    q1r = jnp.floor((gbm + 1.0) * (1.0 / COLS))  # [0, 8] un-wrapped row

    # --- chip planes: one 32-wide row-pull per (b, c, p) ---------------
    idx = rp0.astype(jnp.int32)  # (B, C, p)
    pulled = jax.vmap(  # over B
        lambda ib: jax.vmap(lambda tab, ic: tab[ic])(inputs["vpack"], ib)
    )(idx)  # (B, C, p, 32)
    # -> planes (B, C, code, shift, row, p)
    planes = pulled.reshape(B, C, P_GRID, 2, 2, ROWS).transpose(0, 1, 3, 4, 5, 2)

    # --- row alignment: A[., rho, p] = plane[., (rho + q0) mod 8, p] ---
    src_row = jnp.mod(
        q0[:, :, None, :] + rho[None, None, :, None], float(ROWS)
    )  # (B, C, rho, p)
    oh_row = jax.nn.one_hot(src_row.astype(jnp.int32), ROWS, dtype=jnp.float32)
    # (B, C, rho, p, src) x (B, C, code, shift, src, p) -> (B, C, code, shift, rho, p)
    # exact at any precision (0/1 times +-1, one nonzero term per sum);
    # HIGHEST keeps it off TF32 rounding by construction
    A = jnp.einsum("bcwps,bcdesp->bcdewp", oh_row, planes,
                   precision=jax.lax.Precision.HIGHEST)

    a0b, a1b = A[:, :, 0, 0], A[:, :, 0, 1]  # (B, C, rho, p)
    a0c, a1c = A[:, :, 1, 0], A[:, :, 1, 1]

    # --- symbol-period masks ------------------------------------------
    # period(K, p) = kappa + ((rho + q) >= 8) + (gb >= 8184): the flat
    # base gb can exceed one full code period (cp0 near 4092), which the
    # modded row index hides — w8 restores it.
    b0 = (rho[None, None, :, None] + q0[:, :, None, :] >= ROWS).astype(jnp.float32)
    b1 = (rho[None, None, :, None] + q1r[:, :, None, :] >= ROWS).astype(jnp.float32)
    w8 = (gb >= float(ROWS * COLS)).astype(jnp.float32)  # (B, C, p)

    sym = inputs["sym_win"]
    pil = inputs["pilot_win"]

    # --- rank-1 carrier factors (cheap, full (B, C, ...) rank) ---------
    k_full = ROWS * kap[None, None, :, None] + rho[None, None, None, :]  # (1,1,kap,rho)
    ph_k = inputs["fc_k"][..., None, None] * k_full  # (B, C, kappa, rho)
    ph_k = ph_k - jnp.floor(ph_k)
    ang_k = (2.0 * jnp.float32(np.pi)) * ph_k
    ckr, cki = jnp.cos(ang_k), jnp.sin(ang_k)

    ph_p = inputs["carr0"][..., None] + inputs["fc"][..., None] * p  # (B, C, p)
    ph_p = ph_p - jnp.floor(ph_p)
    ang_p = (2.0 * jnp.float32(np.pi)) * ph_p
    cpr, cpi = jnp.cos(ang_p), jnp.sin(ang_p)

    # --- channel accumulation as a lax.scan over the channel axis ------
    #
    # Two constraints meet here:
    # 1. ORDER: the accumulation must be strictly-ascending left-to-right
    #    channel adds (NOT jnp.sum — a Reduce op's order is an XLA
    #    scheduling choice that varies with shape, and a differently-
    #    associated f32 sum lands 1 ulp off, enough to flip trunc() at
    #    integer-tie accumulator values; compacted and padded channel
    #    maps must give the same stream, tests/test_synth_kp.py).
    # 2. MEMORY: the full-rank (B, C, kap, rho, p) sample chain must
    #    never materialize per channel simultaneously — an unrolled add
    #    chain over slices of a full-rank product defeated XLA's
    #    elementwise-into-reduce fusion and blew the 600 s soak's peak
    #    RSS from 0.7 to 5.7 GB.
    # A scan with the whole per-channel chain in its body satisfies
    # both: one channel's temporaries + two accumulators live at a time,
    # and the carry add order is fixed.  All ops are elementwise/
    # broadcast, so slicing the channel before computing is
    # bit-identical per element to full-rank broadcasts.
    amp = jnp.float32(LUT_AMPLITUDE)
    k2 = k_full[0, 0]  # (kap, rho)
    kpar = rho - 2.0 * jnp.floor(rho * 0.5)  # (rho,)
    cboc = "cboc_ab" in inputs
    cm = lambda x: jnp.moveaxis(x, 1, 0)  # noqa: E731 — channel-leading

    xs = {
        "a0b": cm(a0b), "a1b": cm(a1b), "a0c": cm(a0c), "a1c": cm(a1c),
        "b0": cm(b0), "b1": cm(b1),
        "psi": cm(psi), "w8": cm(w8), "mu": cm(inputs["mu"]),
        "d0": cm(sym[:, :, :n_kap]), "d1": cm(sym[:, :, 1 : n_kap + 1]),
        "d2": cm(sym[:, :, 2 : n_kap + 2]),
        "s0": cm(pil[:, :, :n_kap]), "s1": cm(pil[:, :, 1 : n_kap + 1]),
        "s2": cm(pil[:, :, 2 : n_kap + 2]),
        "ckr": cm(ckr), "cki": cm(cki), "cpr": cm(cpr), "cpi": cm(cpi),
    }
    if cboc:
        xs["pgb"] = cm(gb - 2.0 * jnp.floor(gb * 0.5))  # parity(gb), (C,B,p)
    use_gain = "chan_gain" in inputs
    if use_gain:
        xs["gain"] = cm(inputs["chan_gain"])  # (C, B)

    def body(carry, ch):
        acc_i, acc_q = carry
        w8b = ch["w8"][:, None, None, :]  # (B, 1, 1, p)
        d_lo = ch["d0"][:, :, None, None] + w8b * (ch["d1"] - ch["d0"])[:, :, None, None]
        d_hi = ch["d1"][:, :, None, None] + w8b * (ch["d2"] - ch["d1"])[:, :, None, None]
        s_lo = ch["s0"][:, :, None, None] + w8b * (ch["s1"] - ch["s0"])[:, :, None, None]
        s_hi = ch["s1"][:, :, None, None] + w8b * (ch["s2"] - ch["s1"])[:, :, None, None]

        muk = ch["mu"][:, None, None] * k2[None]  # (B, kap, rho)
        t_kp = ch["psi"][:, None, None, :] + muk[..., None]  # (B,kap,rho,p)
        delta = jnp.floor(t_kp)

        chip_b = ch["a0b"][:, None] + delta * (ch["a1b"] - ch["a0b"])[:, None]
        chip_c = ch["a0c"][:, None] + delta * (ch["a1c"] - ch["a0c"])[:, None]
        bsel = ch["b0"][:, None] + delta * (ch["b1"] - ch["b0"])[:, None]
        d_val = d_lo + bsel * (d_hi - d_lo)
        s_val = s_lo + bsel * (s_hi - s_lo)

        if cboc:
            # CBOC(6,1,1/11): weight each component by (alpha+-beta*tau),
            # tau = (-1)^(H + j6), H = 1023*K + gb + delta the actual
            # half-chip flat index (1023 odd and 8184 even, so
            # parity(H) = parity(K) ^ parity(gb) ^ delta, and
            # parity(K) = parity(rho) since K = 8*kappa + rho), and
            # j6 = floor(6*frac) the sc6 sub-position in the half-chip.
            # All terms are exact small integers in f32.
            ab = inputs["cboc_ab"]
            frac = t_kp - delta
            j6 = jnp.floor(jnp.float32(6.0) * frac)
            par = (
                ch["pgb"][:, None, None, :]
                + kpar[None, None, :, None]
                + delta
                + j6
            )
            tau = 1.0 - 2.0 * (par - 2.0 * jnp.floor(par * 0.5))
            wb = ab[0] + ab[1] * tau
            wc = ab[0] - ab[1] * tau
            m = (chip_b * wb) * d_val - (chip_c * wc) * s_val
        else:
            m = chip_b * d_val - chip_c * s_val  # (B, kap, rho, p)
        if use_gain:
            m = m * ch["gain"][:, None, None, None]  # after the mix

        cis_r = (
            ch["ckr"][..., None] * ch["cpr"][:, None, None, :]
            - ch["cki"][..., None] * ch["cpi"][:, None, None, :]
        )
        cis_i = (
            ch["ckr"][..., None] * ch["cpi"][:, None, None, :]
            + ch["cki"][..., None] * ch["cpr"][:, None, None, :]
        )
        # ascending-channel accumulation; the initial 0.0 + v is an
        # exact f32 identity (only a -0.0 sign can differ, which
        # trunc-to-int16 cannot see)
        return (acc_i + m * cis_r, acc_q + m * cis_i), None

    zero = jnp.zeros((B, n_kap, ROWS, P_GRID), jnp.float32)
    (i_acc, q_acc), _ = jax.lax.scan(body, (zero, zero), xs)
    i_acc = i_acc * amp  # (B, kappa, rho, p)
    q_acc = q_acc * amp

    iq = jnp.stack([i_acc, q_acc], axis=-1)
    return iq.reshape(B, n_k * P_GRID, 2)


@functools.partial(jax.jit, static_argnames=("n_k",))
def synth_block_kp_packed(inputs: dict, n_k: int = K_EPOCH) -> jax.Array:
    """(B, n_k, 1300) int32 packed I/Q — the PRODUCTION stream format.

    Each word is the little-endian pack of one sample's int16 pair
    (I in the low 16 bits, Q in the high), so the array's byte stream
    equals the reference's interleaved int16 format and the host-side
    flatten is a free view (packed_to_iq16); one int32 output buffer
    instead of two int16 ones.  Reference format:
    src/galileo-sdr.cpp:536-542 (interleaved (short) I/Q)."""
    acc = synth_accum_kp(inputs, n_k=n_k)  # (B, n_k*1300, 2)
    B = acc.shape[0]
    i16 = jnp.trunc(acc).astype(jnp.int32)
    w = (i16[..., 0] & 0xFFFF) | (i16[..., 1] << 16)
    return w.reshape(B, n_k, P_GRID)


def packed_to_iq16(packed: np.ndarray) -> np.ndarray:
    """Host-side free flatten: (B, n_k, 1300) int32 packed I/Q ->
    (B, 2*n_k*1300) interleaved int16 (a view when contiguous)."""
    import sys

    assert sys.byteorder == "little", "packed I/Q view needs little-endian"
    arr = np.ascontiguousarray(packed)
    return arr.view(np.int16).reshape(arr.shape[0], -1)


@functools.partial(jax.jit, static_argnames=("n_k",))
def synth_block_kp(inputs: dict, n_k: int = K_EPOCH) -> jax.Array:
    """(B, 2 * n_k * 1300) interleaved int16 I/Q."""
    acc = synth_accum_kp(inputs, n_k=n_k)
    B = acc.shape[0]
    return jnp.trunc(acc).astype(jnp.int16).reshape(B, -1)


def synth_batch_kp_host(
    batch: EpochBatch, nsamples: int = NUM_IQ_SAMPLES
) -> np.ndarray:
    """Convenience wrapper -> (B, 2*nsamples) int16 on host (via the
    packed device format; bytes identical to synth_block_kp)."""
    inputs = prepare_kp_inputs(batch, nsamples)
    out = synth_block_kp_packed(inputs, n_k=nsamples // P_GRID)
    return packed_to_iq16(np.asarray(out))[:, : 2 * nsamples]
