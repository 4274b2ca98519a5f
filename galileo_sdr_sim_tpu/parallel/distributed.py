"""Multi-process synthesis via jax.distributed.

The reference is strictly single-process (SURVEY §2 parallelism table);
this scale-out re-expresses the workload's two parallel axes over a
*global* device mesh spanning processes:

* ``'time'`` — consecutive epoch blocks are sharded across processes.
  Because every epoch's phases are affine in the sample index with exact
  float64 seeds from the host scenario engine, time shards need **no**
  cross-process communication at all: the network carries only the
  coordination handshake, never samples.
* ``'sat'``  — channels are sharded across each process's local devices
  and partial I/Q is combined with an ``lax.psum`` that stays inside the
  process (the mesh is laid out so 'sat' never crosses a process
  boundary).  A GPU process holds one card, so there 'sat' has size 1;
  the CPU tests give each process several virtual devices.

Host-side scenario state (orbits, I/NAV, observables) is deterministic
from (RINEX, g0, position), so every process runs the same cheap engine
and materializes only its addressable input shards
(`jax.make_array_from_callback`). Output: each process writes its own
contiguous time segment of the int16 stream into the shared sink file at
the exact byte offset — the multi-host equivalent of the reference's
single-writer FIFO (src/fifo.cpp), with the file system as the rendezvous.

Process groups are bootstrapped with `jax.distributed.initialize`
(coordinator + N processes), one process per card: each process keeps
the card its local rank names (`local_card_ids`), so no process reserves
memory on another's card.  Tests fake a 2-host pod with two CPU
processes of 4 virtual devices each (SURVEY §4e).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

ENV_COORD = "GALILEO_COORDINATOR"
ENV_NPROC = "GALILEO_NUM_PROCESSES"
ENV_PID = "GALILEO_PROCESS_ID"

# The accumulation-order bound for psum'd synthesis, stated once.
#
# A psum over the 'sat' axis associates the float32 channel additions
# differently from the single-device sequential/tree reduction, so the
# int16 truncation `(short)i_acc` (galileo-sdr.cpp:536) can flip a
# sample by exactly 1 LSB where the accumulator lands on an integer
# boundary.  Empirically < 0.1% of samples across the test scenarios,
# never more than 1 LSB — hence: at least this fraction of samples must
# be bit-identical, and no sample may differ by more than PSUM_MAX_LSB.
# This is a float-association property, not nondeterminism: the lut512
# direct engine under the same mesh is asserted exactly equal
# (tests/test_sharding.py), and any single layout is reproducible.
PSUM_SAMPLE_IDENTITY_BOUND = 0.999
PSUM_MAX_LSB = 1


def maybe_initialize_from_env() -> bool:
    """Join a process group if GALILEO_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID
    are set (returns True), else stay single-process (False)."""
    coord = os.environ.get(ENV_COORD)
    if not coord:
        return False
    initialize(
        coord,
        int(os.environ[ENV_NPROC]),
        int(os.environ[ENV_PID]),
    )
    return True


def _host_card_count() -> int:
    """NVIDIA cards on this host, from their device nodes (0 if none)."""
    return sum(1 for d in Path("/dev").glob("nvidia*") if d.name[6:].isdigit())


def local_card_ids(process_id: int, env=os.environ) -> list[int] | None:
    """The one card (index among the host's visible cards) this process
    keeps, or None where the launcher already chose: `JAX_LOCAL_DEVICE_IDS`
    set, or `CUDA_VISIBLE_DEVICES` naming at most one card.

    The local rank is the launcher's `LOCAL_RANK` when set (several
    hosts), else the process id modulo the host's visible cards (one
    host)."""
    if env.get("JAX_LOCAL_DEVICE_IDS"):
        return None
    visible = [v for v in env.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    if "CUDA_VISIBLE_DEVICES" in env and len(visible) <= 1:
        return None
    if env.get("LOCAL_RANK"):
        return [int(env["LOCAL_RANK"])]
    n = len(visible) or _host_card_count()
    return [process_id % n if n else process_id]


def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        # ignored by the CPU backend
        local_device_ids=local_card_ids(process_id),
    )


def global_mesh():
    """('time', 'sat') mesh over all global devices: one 'time' row per
    process (its local devices form the 'sat' axis), so the channel psum
    stays inside a process and time shards are process-local."""
    import jax
    from jax.sharding import Mesh

    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    nproc = jax.process_count()
    local = len(devs) // nproc
    grid = np.array(devs).reshape(nproc, local)
    return Mesh(grid, axis_names=("time", "sat"))


def _global_shard(inputs: dict, mesh):
    """Build global jax.Arrays for the (K,p) inputs from identical
    host-side numpy on every process (only addressable shards are
    materialized)."""
    import jax
    from jax.sharding import NamedSharding

    from .mesh import KP_ORDER, KP_SPECS

    out = []
    for k in KP_ORDER:
        arr = np.asarray(inputs[k])
        sh = NamedSharding(mesh, KP_SPECS[k])
        out.append(
            jax.make_array_from_callback(arr.shape, sh, lambda idx, a=arr: a[idx])
        )
    return tuple(out)


def synth_batch_kp_distributed(batch, nsamples, mesh=None):
    """Multi-process production path.  Every process passes the SAME
    EpochBatch (deterministic host engine); returns this process's
    addressable (epoch_index, iq_rows) segments, epoch-major int16
    (n, 2*nsamples) pieces ready for offset writes."""
    import jax

    from ..ops.synth_kp import P_GRID, prepare_kp_inputs
    from .mesh import sharded_kp_fn

    mesh = mesh if mesh is not None else global_mesh()
    n_sat = mesh.shape["sat"]
    n_time = mesh.shape["time"]
    B_real = batch.f_code.shape[0]
    # pad partial batches (cut early at channel-map changes) up to a
    # multiple of the time axis; padded epochs are trimmed from segments
    pad = -(-B_real // n_time) * n_time
    inputs = prepare_kp_inputs(
        batch, nsamples, pad_epochs=pad if pad != B_real else None,
        compact=False if n_sat > 1 else True,
    )
    B, C = inputs["cp0"].shape
    assert C % n_sat == 0, f"channels {C} not divisible by sat axis {n_sat}"

    fn = sharded_kp_fn(mesh, n_k=nsamples // P_GRID)
    out = fn(*_global_shard(inputs, mesh))  # global (B, n, 2)

    segments = []
    seen = set()
    for s in out.addressable_shards:
        e0 = s.index[0].start or 0
        if e0 in seen or e0 >= B_real:  # 'sat'-replicated / padding shards
            continue
        seen.add(e0)
        rows = np.asarray(s.data).reshape(s.data.shape[0], -1)[:, : 2 * nsamples]
        segments.append((e0, rows[: B_real - e0]))
    return segments


def write_segments(path: str | Path, segments, nsamples: int,
                   base_epoch: int = 0) -> None:
    """Offset-write this process's epoch segments into the shared file.

    Process 0 must have pre-sized the file (see `presize`); every process
    then pwrites its own contiguous byte ranges — no locks needed since
    ranges are disjoint."""
    bytes_per_epoch = 2 * nsamples * 2  # int16 I/Q
    with open(path, "r+b") as fh:
        for e0, rows in segments:
            fh.seek((base_epoch + e0) * bytes_per_epoch)
            fh.write(np.ascontiguousarray(rows, dtype=np.int16).tobytes())


def presize(path: str | Path, nsamples: int, total_epochs: int) -> None:
    with open(path, "wb") as fh:
        fh.truncate(total_epochs * 2 * nsamples * 2)


def barrier(name: str = "galileo") -> None:
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def generate_file_distributed(
    engine, outfile: str | Path, block_epochs: int = 8,
    nsamples: int | None = None,
) -> int:
    """Offline multi-host file generation: every process runs the same
    deterministic ScenarioEngine, each synthesizes its time shard of every
    batch on its local devices and offset-writes the shared file.

    Returns the number of epochs written.  The multi-host analogue of the
    reference's single-writer file sink (galileo-sdr.cpp:542)."""
    import jax

    from ..constants import NUM_IQ_SAMPLES

    nsamples = nsamples or NUM_IQ_SAMPLES
    mesh = global_mesh()
    total = len(engine)
    if jax.process_index() == 0:
        presize(outfile, nsamples, total_epochs=total)
    barrier("presize")
    base = 0
    for batch in engine.batches(block_epochs):
        segs = synth_batch_kp_distributed(batch, nsamples, mesh=mesh)
        write_segments(outfile, segs, nsamples, base_epoch=base)
        base += batch.f_code.shape[0]
    barrier("written")
    return base
