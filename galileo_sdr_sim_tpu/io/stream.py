"""Streaming executor: double-buffered device->host synthesis pipeline.

Replacement for the reference's producer/consumer FIFO threads
(reference: src/fifo.cpp + src/galileo-sdr.cpp:570-595 + src/main.cpp:55-127):
while the host drains epoch k to the sink, the device already computes
epoch k+1 (JAX dispatch is asynchronous; `np.asarray` on the previous
result is the synchronization point).  All device calls use a fixed
(B=1, MAX_CHAN) shape so XLA compiles exactly once.

For real-time SDR output the sink side can additionally be backed by the
native ring buffer (io/native_fifo.py) to decouple bursty host scheduling
from the DAC clock, mirroring the reference's 0.2 s FIFO.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from ..constants import NUM_IQ_SAMPLES
from ..profiling import Timer
from ..ops.synth import TILE, prepare_device_inputs, synth_block
from ..ops.synth_kp import (
    P_GRID,
    ROWS,
    mu_in_envelope,
    packed_to_iq16,
    prepare_kp_inputs,
    synth_block_kp_packed,
)
from ..scenario import EpochStateTable, ScenarioEngine
from .sinks import Sink


def _slice_epoch(batch, e: int):
    """One-epoch view of an EpochBatch (leading epoch axis sliced to
    [e:e+1]; channel-map fields pass through)."""
    from dataclasses import replace

    return replace(
        batch,
        grx_sec=batch.grx_sec[e : e + 1],
        f_carr=batch.f_carr[e : e + 1],
        f_code=batch.f_code[e : e + 1],
        code_phase0=batch.code_phase0[e : e + 1],
        carr_phase0=batch.carr_phase0[e : e + 1],
        sym_win=batch.sym_win[e : e + 1],
        pilot_win=batch.pilot_win[e : e + 1],
        gain=batch.gain[e : e + 1],
    )


@dataclass
class StreamStats:
    epochs: int = 0
    samples: int = 0
    wall_s: float = 0.0
    # per-stage wall-clock split (host prep/dispatch, device wait, sink)
    timer: Timer = None  # type: ignore[assignment]

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.wall_s if self.wall_s else 0.0

    @property
    def realtime_factor(self) -> float:
        return self.samples_per_sec / 2.6e6

    def stage_report(self) -> str:
        return self.timer.report() if self.timer else ""


class StreamingSynthesizer:
    """Drives a ScenarioEngine epoch-by-epoch into a Sink."""

    def __init__(
        self,
        engine: ScenarioEngine,
        sink: Sink,
        mode: str = "float",
        synth_engine: str = "kp",
        tile: int = TILE,
        block_epochs: int = 8,
        nsamples: int = NUM_IQ_SAMPLES,
        status_cb: Callable[[EpochStateTable, StreamStats], None] | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 300,
        apply_gain: bool = False,
        pipeline_depth: int | None = None,
        drain_host: bool = True,
        bandlimit: bool = False,
    ):
        self.engine = engine
        self.sink = sink
        self.mode = mode
        if synth_engine not in ("kp", "direct"):
            raise ValueError(f"unknown synthesis engine {synth_engine!r}")
        # the factorized engine needs whole (8 x 1300)-sample row cycles
        # and implements the float carrier only.  It handles the
        # sine-BOC(1,1) half-chip geometry (code_subdiv == 2) AND the
        # 12-grid CBOC(6,1,1/11) tables (models/cboc.py) — CBOC factors
        # into the sine-BOC chip planes times a pointwise (alpha, beta,
        # tau) weight computed in-engine (ops/synth_kp.py cboc branch),
        # so it runs at the (K,p) rate instead of the direct engine's
        # gather rate.  Other geometries route direct.
        if (
            nsamples % (ROWS * P_GRID) != 0
            or mode == "lut512"
            or getattr(engine.model, "code_subdiv", 2) not in (2, 12)
        ):
            synth_engine = "direct"
        self.synth_engine = synth_engine
        # band-limited CBOC mode (ops/bandlimit.py): 12 phase-shifted
        # (K,p) calls per block + polyphase decimation emit the stream a
        # band-limited front end would digitize
        self.bandlimit = bandlimit
        if bandlimit:
            if getattr(engine.model, "code_subdiv", 2) != 12:
                raise ValueError(
                    "--bandlimit needs the CBOC signal model "
                    "(models/cboc.py); run with --model cboc"
                )
            if self.synth_engine != "kp":
                raise ValueError(
                    "--bandlimit requires the factorized (K,p) engine "
                    f"(got {self.synth_engine})"
                )
            from ..ops.bandlimit import initial_state

            self._bl_state = initial_state()
        self.tile = tile
        self.block_epochs = block_epochs
        self.nsamples = nsamples  # != NUM_IQ_SAMPLES only in tests
        self.status_cb = status_cb
        self.stats = StreamStats(timer=Timer())
        # in-flight device blocks allowed ahead of the sink.
        # Depth 1 (DEFAULT): the single-thread prep(k+1)-then-drain(k)
        # pipeline.  JAX dispatch is asynchronous, so the device computes
        # block k+1 while np.asarray streams block k back — one thread,
        # no GIL contention, and a live position update lands in the very
        # next prepared epoch (the latency contract of
        # galileo-sdr.cpp:443, pinned by
        # test_baseline_configs.test_live_position_reaches_samples_b1).
        # Depth >= 2 (opt-in, --pipeline-depth): a producer thread
        # additionally preps/uploads/dispatches ahead with bounded-queue
        # backpressure (reference analogue: src/fifo.cpp), for sinks that
        # block the calling thread far longer than a block's compute
        # (e.g. a paced DAC consumer drained elsewhere).  Its producer's
        # numpy-heavy prep shares the GIL with the drain thread; on the
        # H100 it has not been measured ("not measured", PERF.md).
        if pipeline_depth is None:
            pipeline_depth = 1
        self.pipeline_depth = max(1, pipeline_depth)
        # drain_host=False: blocks are handed to the sink as device
        # arrays (no D2H fetch) — for device-resident consumers; the
        # fallback path still yields numpy blocks, which such sinks
        # must accept (rare transition blocks)
        self.drain_host = drain_host
        # serializes scenario stepping (producer thread) against
        # checkpoint snapshots taken on the drain side
        self._engine_lock = threading.Lock()
        self._stop = False
        self._code_cache: dict = {}
        self._direct_cache: dict = {}  # separate: the fallback path's slabs
        self.apply_gain = apply_gain
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every  # epochs between snapshots
        self._start_epoch = 1
        if checkpoint_path is not None:
            # snapshots rewind to the last DRAINED epoch (the producer
            # runs up to pipeline_depth+1 blocks ahead of the sink); the
            # engine's replay ring must cover those in-flight epochs
            engine._replay_keep = (self.pipeline_depth + 2) * block_epochs
        if checkpoint_path is not None:
            from pathlib import Path

            if Path(checkpoint_path).with_suffix(".json").exists():
                from ..checkpoint import load_state

                done = load_state(engine, checkpoint_path)
                self._start_epoch = done + 1

    def stop(self) -> None:
        self._stop = True

    def _device_blocks(self) -> Iterator[tuple[object, object, int]]:
        gen = self.engine.batches(self.block_epochs, start=self._start_epoch)
        while True:
            # scenario stepping under the engine lock: checkpoint
            # snapshots (taken on the drain side) see committed state
            with self._engine_lock, self.stats.timer.section("scenario"):
                batch = next(gen, None)
            if batch is None:
                return
            n_real = batch.f_code.shape[0]
            # pad to a fixed epoch count -> exactly one XLA compile; cache
            # the code slabs on device across blocks
            use_kp = self.synth_engine == "kp"
            fallback = use_kp and not mu_in_envelope(batch.f_code)
            # the fallback synthesizes AND synchronizes host-side, so it
            # gets its own stage (device overlap with the sink is lost for
            # those rare transition blocks; lumping it into
            # host_prep+dispatch would misattribute device wait time)
            section = "fallback_direct" if fallback else "host_prep+dispatch"
            with self.stats.timer.section(section):
                if use_kp and not fallback and self.bandlimit:
                    from ..ops.bandlimit import synth_block_cboc_bandlimited

                    fut, self._bl_state = synth_block_cboc_bandlimited(
                        batch,
                        self.nsamples,
                        pad_epochs=self.block_epochs,
                        code_cache=self._code_cache,
                        state=self._bl_state,
                        apply_gain=self.apply_gain,
                    )
                elif use_kp and not fallback:
                    inputs = prepare_kp_inputs(
                        batch,
                        self.nsamples,
                        pad_epochs=self.block_epochs,
                        code_cache=self._code_cache,
                        apply_gain=self.apply_gain,
                    )
                    # packed int32 I/Q; the drain views the packed bytes
                    # as int16 for free (synth_kp.packed_to_iq16)
                    fut = synth_block_kp_packed(
                        inputs, n_k=self.nsamples // P_GRID
                    )
                elif fallback:
                    # (In --bandlimit mode a fallback block bypasses the
                    # polyphase filter and leaves the overlap state
                    # untouched: a teleport-transition block is emitted
                    # pointwise with a filter seam at its edges — the
                    # receiver re-acquires through a teleport anyway.)
                    # An epoch's pseudorange-rate-derived code Doppler
                    # fell outside the factorized engines' envelope
                    # (ops/synth_kp.MU_MAX) — a live-position teleport,
                    # or a channel-reallocation transition epoch (the
                    # reference derives rate by the same differencing,
                    # gal-sig.cpp:311-318).  Synthesize this block with
                    # the direct engine, which is exact for any rate —
                    # but ONE EPOCH AT A TIME: a full-B direct graph on
                    # a CPU host allocates ~5 GB of gather/one-hot
                    # buffers (it blew the 600 s soak's peak RSS from
                    # 0.7 to 5.7 GB), while the B=1 slices stay ~0.1 GB
                    # and the fallback only fires on transition blocks.
                    outs = []
                    for e in range(n_real):
                        dinp = prepare_device_inputs(
                            _slice_epoch(batch, e),
                            self.tile,
                            self.nsamples,
                            pad_epochs=1,
                            code_cache=self._direct_cache,
                        )
                        outs.append(
                            np.asarray(
                                synth_block(dinp, tile=self.tile, mode=self.mode)
                            )[:, : 2 * self.nsamples]
                        )
                    fut = np.concatenate(outs, axis=0)
                else:
                    inputs = prepare_device_inputs(
                        batch,
                        self.tile,
                        self.nsamples,
                        pad_epochs=self.block_epochs,
                        code_cache=self._direct_cache,
                    )
                    fut = synth_block(inputs, tile=self.tile, mode=self.mode)
                if self.drain_host and hasattr(fut, "copy_to_host_async"):
                    # start the D2H transfer the moment compute finishes
                    # instead of when the drain reaches this block, so it
                    # overlaps the sink write and host prep of
                    # neighboring blocks
                    fut.copy_to_host_async()
            yield batch, fut, n_real

    def run(self) -> StreamStats:
        """Producer thread prepares/uploads/dispatches up to
        `pipeline_depth` blocks ahead; this thread drains results in
        order.  H2D latency of block k+1..k+depth overlaps both the
        device compute and the sink writes of block k.  Stage timers run
        on both threads (disjoint section names), so section sums can
        exceed wall time — that overlap is the point.

        Depth 1 runs single-threaded: dispatch block k+1, then drain
        block k — one block of device lead, and live position updates
        land in the next prepared epoch."""
        t0 = time.perf_counter()
        if self.pipeline_depth == 1:
            pending = None
            for item in self._device_blocks():
                if pending is not None:
                    self._drain(*pending)
                pending = item
                if self._stop:
                    break
            if pending is not None:
                self._drain(*pending)
            self.stats.wall_s = time.perf_counter() - t0
            return self.stats
        q: queue.Queue = queue.Queue(maxsize=self.pipeline_depth)
        err: list[BaseException] = []
        done_ev = threading.Event()

        def produce() -> None:
            # put() polls with a SHORT timeout: it only exists so stop()
            # can interrupt a full-queue wait; a long poll would add up
            # to its whole length of dead time per block handoff when
            # the queue is full.
            try:
                for item in self._device_blocks():
                    while not self._stop:
                        try:
                            q.put(item, timeout=0.002)
                            break
                        except queue.Full:
                            continue
                    if self._stop:
                        return
            except BaseException as e:  # propagate to the drain thread
                err.append(e)
            finally:
                # completion travels out-of-band (an Event can never
                # block or spin, unlike an in-queue sentinel that needs
                # a free slot — the drain side may already be gone)
                done_ev.set()

        th = threading.Thread(target=produce, name="stream-producer")
        th.start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.01)
                except queue.Empty:
                    if err or (done_ev.is_set() and q.empty()):
                        break
                    continue
                self._drain(*item)
                if self._stop:
                    break
        finally:
            self._stop = True
            th.join()
        if err:
            raise err[0]
        self.stats.wall_s = time.perf_counter() - t0
        return self.stats

    def _drain(self, batch, fut, n_real: int) -> None:
        if self.drain_host:
            with self.stats.timer.section("device_wait+fetch"):
                host = np.asarray(fut)
                if host.ndim == 3:  # packed int32 I/Q -> free int16 view
                    host = packed_to_iq16(host)
                host = host[:n_real, : 2 * self.nsamples]
            with self.stats.timer.section("sink_write"):
                self.sink.write(host)
        else:
            # device-resident sink: hand over the (possibly still
            # computing) device block — the sink consumes it on-device
            # (e.g. a checksum reducer, or a downstream device DSP
            # stage) and decides its own synchronization point; the
            # samples never cross to the host.  kp blocks arrive in
            # the packed int32 layout (B, n_k, 1300); fallback blocks
            # as flat int16.  Skip the (eager, dispatch-costing) slice
            # when the block is already exact — the common full-block
            # case.
            with self.stats.timer.section("sink_write"):
                shape = getattr(fut, "shape", None)
                if shape is not None and len(shape) == 3:  # packed kp
                    self.sink.write(
                        fut if shape[0] == n_real else fut[:n_real]
                    )
                elif shape == (n_real, 2 * self.nsamples):
                    self.sink.write(fut)
                else:
                    self.sink.write(fut[:n_real, : 2 * self.nsamples])
        self.stats.epochs += n_real
        self.stats.samples += n_real * self.nsamples
        if self.status_cb is not None:
            self.status_cb(batch, self.stats)
        if (
            self.checkpoint_path is not None
            and self.stats.epochs % self.checkpoint_every < n_real
        ):
            from ..checkpoint import save_state

            # engine lock: the producer thread must not step the scenario
            # mid-snapshot (resume is exact because the engine's pending
            # buffer is serialized with it, checkpoint.py).  drained_iumd
            # rewinds the snapshot to what the SINK has received — the
            # producer may be pipeline_depth+1 blocks ahead, and resume
            # must replay those in-flight epochs, not skip them.
            with self._engine_lock:
                save_state(
                    self.engine,
                    self.checkpoint_path,
                    drained_iumd=self._start_epoch - 1 + self.stats.epochs,
                )
