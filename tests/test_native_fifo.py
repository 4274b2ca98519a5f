"""Native C++ ring-buffer transport: integrity, backpressure, EOF.

Pins the behavior of native/iqring.cpp + io/native_fifo.py, the
replacement for the reference's pthread FIFO + tx_task pair
(reference src/fifo.cpp:14-62, src/main.cpp:55-127): a bounded ring that
blocks the producer when the consumer falls behind (no sample loss, no
overwrite), and drains fully at EOF.
"""

import threading
import time

import numpy as np
import pytest

from galileo_sdr_sim_tpu.io.native_fifo import (
    IqRing,
    NativeFifoSink,
    ThreadedRingSink,
)
from galileo_sdr_sim_tpu.io.sinks import Sink


def _iq(n_samples: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-500, 500, size=2 * n_samples, dtype=np.int16)


def test_file_consumer_integrity(tmp_path):
    """Everything written through the ring lands in the file, in order."""
    out = tmp_path / "ring.ishort"
    data = _iq(100_000)
    sink = NativeFifoSink(str(out), capacity_samples=8192)
    for off in range(0, data.size, 2 * 7000):  # uneven producer bursts
        sink.write(data[off : off + 2 * 7000])
    sink.close()
    got = np.fromfile(out, dtype=np.int16)
    assert np.array_equal(got, data)


def test_backpressure_blocks_producer_without_loss():
    """With no consumer, a write larger than the ring must block until a
    reader frees space; nothing is dropped or overwritten."""
    ring = IqRing(capacity_samples=1024)
    data = _iq(4096, seed=1)
    wrote = []

    def producer():
        wrote.append(ring.write(data))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.2)
    assert t.is_alive(), "producer should be blocked on the full ring"
    assert ring.available == 1024  # exactly the capacity buffered

    out = []
    while sum(len(c) for c in out) < data.size:
        out.append(ring.read(512))
    t.join(timeout=5)
    assert not t.is_alive()
    assert wrote == [4096]
    assert np.array_equal(np.concatenate(out), data)
    ring.close()


def test_eof_semantics():
    """close_write unblocks a pending producer (short write) and makes
    reads drain the remainder then return empty."""
    ring = IqRing(capacity_samples=256)
    data = _iq(1024, seed=2)
    result = []
    t = threading.Thread(target=lambda: result.append(ring.write(data)))
    t.start()
    time.sleep(0.1)
    ring.close_write()
    t.join(timeout=5)
    assert result and result[0] == 256  # only the buffered part
    drained = ring.read(1024)
    assert len(drained) == 2 * 256
    assert len(ring.read(16)) == 0  # EOF
    ring.close()


class _SlowSink(Sink):
    def __init__(self, delay: float):
        self.delay = delay
        self.chunks: list[np.ndarray] = []

    def write(self, iq: np.ndarray) -> None:
        time.sleep(self.delay)
        self.chunks.append(np.array(iq, dtype=np.int16))


def test_threaded_ring_sink_backpressure_and_order():
    """The USRP-path transport: a slow inner sink throttles the producer
    through the ring; every sample arrives exactly once, in order."""
    inner = _SlowSink(delay=0.01)
    sink = ThreadedRingSink(inner, capacity_samples=4096, chunk_samples=1024)
    data = _iq(64_000, seed=3)
    t0 = time.perf_counter()
    for off in range(0, data.size, 2 * 8000):
        sink.write(data[off : off + 2 * 8000])
    sink.close()
    wall = time.perf_counter() - t0
    got = np.concatenate(inner.chunks)
    assert np.array_equal(got, data)
    # 64k samples / 1024-chunk = 63 consumer writes x 10 ms; the bounded
    # ring (4096 deep) must have made the producer wait for most of it
    assert wall > 0.4, f"producer was not backpressured (wall={wall:.3f}s)"


def test_streaming_synthesizer_through_native_ring(nav, g0, tmp_path):
    """End-to-end: the stream executor writing through the native ring
    produces a byte-identical file to the plain FileSink."""
    from galileo_sdr_sim_tpu.io.sinks import FileSink
    from galileo_sdr_sim_tpu.io.stream import StreamingSynthesizer
    from galileo_sdr_sim_tpu.scenario import PositionProvider, ScenarioEngine

    def gen(sink_cls, path):
        eng = ScenarioEngine(
            nav,
            PositionProvider(llh_deg=np.array([42.3601, -71.0589, 100.0])),
            g0, duration_s=0.5,
        )
        sink = sink_cls(str(path))
        StreamingSynthesizer(
            eng, sink, synth_engine="kp", block_epochs=2, nsamples=10400
        ).run()
        sink.close()
        return np.fromfile(path, dtype=np.int16)

    plain = gen(FileSink, tmp_path / "plain.ishort")
    ringed = gen(NativeFifoSink, tmp_path / "ring.ishort")
    assert np.array_equal(plain, ringed)
