"""Multi-device sharding of the synthesis pipeline.

The reference is a 3-thread single-process program; its two implicit
parallel axes (summation over satellites, sequential time) map onto a
device mesh as (reference: src/galileo-sdr.cpp:481-539; SURVEY §2
parallelism table):

* axis ``'sat'``   — channels are sharded; each device synthesizes the
  partial I/Q of its channel subset and the full signal is an
  ``lax.psum`` over the devices.  This is the reference's per-sample
  ``i_acc += ip`` accumulation re-expressed as a collective.
* axis ``'time'``  — sample tiles within an epoch block are sharded;
  because the host seeds every tile with an exact float64 phase base
  (ops/synth.py), time shards are embarrassingly parallel and boundary
  samples are continuous to < 1e-3 chip without any communication.  (The
  reference carries NCO state sequentially across samples; the analytic
  seeding removes that dependency.)

Works on any `jax.sharding.Mesh` — GPUs joined all to all, where the
mesh shape follows the algorithm alone, or the CPU
`--xla_force_host_platform_device_count` mesh the tests use.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import NUM_IQ_SAMPLES
from ..ops.synth import synth_accum
from ..scenario import EpochBatch


def make_mesh(n_sat: int, n_time: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_sat * n_time, (devices.size, n_sat, n_time)
    grid = devices[: n_sat * n_time].reshape(n_sat, n_time)
    return Mesh(grid, axis_names=("sat", "time"))


def sharded_synth_fn(mesh: Mesh, tile: int, mode: str = "float"):
    """Build a jitted, mesh-sharded synthesis step.

    Channel axis is split over 'sat', the tile axis over 'time'; partial
    channel sums are combined with a psum over 'sat' and the output stays
    sharded over 'time' (each time shard holds its contiguous sample
    range).
    """

    def local_step(codes_b, codes_c, a, fc, cp_base, w_base, carr_base,
                   sym_win, pilot_win):
        acc = synth_accum(
            codes_b, codes_c, a, fc, cp_base, w_base, carr_base,
            sym_win, pilot_win, tile=tile, mode=mode,
        )
        acc = jax.lax.psum(acc, axis_name="sat")
        return jnp.trunc(acc).astype(jnp.int16)

    in_specs = (
        P("sat", None),        # codes_b (C, H)
        P("sat", None),        # codes_c
        P(None, "sat"),        # a (B, C)
        P(None, "sat"),        # fc
        P(None, "sat", "time"),  # cp_base (B, C, nt)
        P(None, "sat", "time"),  # w_base
        P(None, "sat", "time"),  # carr_base
        P(None, "sat", None),  # sym_win (B, C, W)
        P(None, "sat", None),  # pilot_win
    )
    out_spec = P(None, "time", None, None)  # (B, nt, T, 2)

    fn = shard_map(local_step, mesh=mesh, in_specs=in_specs, out_specs=out_spec)
    return jax.jit(fn)


def shard_inputs(inputs: dict, mesh: Mesh) -> tuple:
    """Device-put the prepared inputs with the matching shardings."""
    specs = dict(
        codes_b=P("sat", None),
        codes_c=P("sat", None),
        a=P(None, "sat"),
        fc=P(None, "sat"),
        cp_base=P(None, "sat", "time"),
        w_base=P(None, "sat", "time"),
        carr_base=P(None, "sat", "time"),
        sym_win=P(None, "sat", None),
        pilot_win=P(None, "sat", None),
    )
    order = ("codes_b", "codes_c", "a", "fc", "cp_base", "w_base",
             "carr_base", "sym_win", "pilot_win")
    return tuple(
        jax.device_put(inputs[k], NamedSharding(mesh, specs[k])) for k in order
    )


def synth_batch_sharded(
    batch: EpochBatch,
    mesh: Mesh,
    tile: int,
    mode: str = "float",
    nsamples: int = NUM_IQ_SAMPLES,
) -> np.ndarray:
    """Full sharded path: batch -> (B, 2*nsamples) int16 on host."""
    from ..ops.synth import prepare_device_inputs

    inputs = prepare_device_inputs(batch, tile, nsamples)
    nt = inputs["cp_base"].shape[2]
    n_sat = mesh.shape["sat"]
    n_time = mesh.shape["time"]
    C = inputs["cp_base"].shape[1]
    assert C % n_sat == 0, f"channels {C} not divisible by sat axis {n_sat}"
    assert nt % n_time == 0, f"tiles {nt} not divisible by time axis {n_time}"

    fn = sharded_synth_fn(mesh, tile, mode)
    out = fn(*shard_inputs(inputs, mesh))  # (B, nt, T, 2)
    B = out.shape[0]
    return np.asarray(out).reshape(B, -1)[:, : 2 * nsamples]


# --- factorized (K,p) engine sharding (production path) ---------------


def sharded_kp_fn(mesh: Mesh, n_k: int, cboc: bool = False):
    """Mesh-sharded factorized synthesis: epochs over 'time', channels
    over 'sat'; per-device partial channel sums combined with a psum,
    exactly the reference's i_acc accumulation as a collective.
    cboc=True threads the replicated (alpha, beta) CBOC weights through
    to the engine (ops/synth_kp.py cboc branch)."""
    from ..ops.synth_kp import synth_accum_kp

    def local_step(cp0, two_a, mu, carr0, fc, fc_k, sym_win, pilot_win,
                   vpack, *ab):
        inputs = {
            "cp0": cp0, "two_a": two_a, "mu": mu, "carr0": carr0,
            "fc": fc, "fc_k": fc_k, "sym_win": sym_win,
            "pilot_win": pilot_win, "vpack": vpack,
        }
        if ab:
            inputs["cboc_ab"] = ab[0]
        acc = synth_accum_kp(inputs, n_k=n_k)
        acc = jax.lax.psum(acc, axis_name="sat")
        return jnp.trunc(acc).astype(jnp.int16)

    in_specs = tuple(KP_SPECS[k] for k in KP_ORDER)
    if cboc:
        in_specs = in_specs + (KP_SPECS["cboc_ab"],)
    # check_vma=False: the engine's channel scan starts from a constant
    # zero carry, which the varying-mesh-axes checker rejects against
    # the per-shard body output
    fn = shard_map(local_step, mesh=mesh, in_specs=in_specs,
                   out_specs=P("time", None, None), check_vma=False)
    return jax.jit(fn)


KP_ORDER = ("cp0", "two_a", "mu", "carr0", "fc", "fc_k",
            "sym_win", "pilot_win", "vpack")
_BC = P("time", "sat")  # per-(epoch, channel) scalars
KP_SPECS = dict(
    cp0=_BC, two_a=_BC, mu=_BC, carr0=_BC, fc=_BC, fc_k=_BC,
    sym_win=P("time", "sat", None),
    pilot_win=P("time", "sat", None),
    vpack=P("sat", None, None),
    cboc_ab=P(None),  # replicated (alpha, beta)
)


def shard_kp_inputs(inputs: dict, mesh: Mesh) -> tuple:
    order = KP_ORDER
    if "cboc_ab" in inputs:
        order = order + ("cboc_ab",)
    return tuple(
        jax.device_put(inputs[k], NamedSharding(mesh, KP_SPECS[k]))
        for k in order
    )


def synth_batch_kp_sharded(
    batch: EpochBatch,
    mesh: Mesh,
    nsamples: int = NUM_IQ_SAMPLES,
    pad_epochs: int | None = None,
) -> np.ndarray:
    """Sharded production path: batch -> (B, 2*nsamples) int16 on host."""
    from ..ops.synth_kp import P_GRID, prepare_kp_inputs

    n_sat = mesh.shape["sat"]
    n_time = mesh.shape["time"]
    inputs = prepare_kp_inputs(
        batch, nsamples, pad_epochs=pad_epochs,
        compact=False if n_sat > 1 else True,
    )
    B, C = inputs["cp0"].shape
    assert C % n_sat == 0, f"channels {C} not divisible by sat axis {n_sat}"
    assert B % n_time == 0, f"epochs {B} not divisible by time axis {n_time}"

    fn = sharded_kp_fn(mesh, n_k=nsamples // P_GRID, cboc="cboc_ab" in inputs)
    out = fn(*shard_kp_inputs(inputs, mesh))  # (B, n, 2)
    return np.asarray(out).reshape(out.shape[0], -1)[:, : 2 * nsamples]
