#!/usr/bin/env python3
"""Benchmark: steady-state baseband synthesis throughput on one device.

Prints one JSON line with the primary metric plus auxiliary fields:
  {"metric": "samples_per_sec", "value": N, "unit": "samples/s",
   "vs_baseline": N / 2.6e6,
   "device": {"platform", "kind", "count"},
   "e2e_samples_per_sec": N,       # ScenarioEngine -> device -> NullSink
   "fix_error_m": N,               # receiver PVT fix from the stream
   "stats": {name: {median, min, max, n}},   # per-metric repetitions
   ...}

Baseline: the reference C++ simulator's hot loop sustains the real-time
rate of 2.6 Msps on one CPU core (BASELINE.md; src/galileo-sdr.cpp:481-539).
vs_baseline is therefore the real-time factor.

Methodology per metric (each the median of REPS repetitions):
- samples_per_sec / cboc / b1: the (K,p) engine's jitted step at the
  production shape, timed over CALLS calls that each end in
  block_until_ready, after a warm-up call that compiles.
- devsink_samples_per_sec: serial host loop (prepare -> dispatch ->
  per-block jitted checksum), no D2H sample traffic — the producer-loop
  rate with the consumer detached (src/galileo-sdr.cpp:570-595).
- devsink_pipelined_samples_per_sec: the same workload through the
  production executor (io/stream.py) with a device-resident sink.
- cboc_bandlimited_samples_per_sec: --bandlimit blocks, serial loop.
- e2e_samples_per_sec: host scenario engine -> device synthesis ->
  drained int16 on host, through the production executor.
- host_engine_samples_per_sec: scenario engine + input prep alone.
- fix_error_m: full receiver PVT fix from production-path samples.
"""

import json
import sys
import time

REPS = 3
CALLS = 20


def _stats(vals):
    import numpy as np

    return {
        "median": float(np.median(vals)),
        "min": float(min(vals)),
        "max": float(max(vals)),
        "n": len(vals),
    }


def main() -> int:
    import numpy as np
    import jax
    import jax.numpy as jnp

    from galileo_sdr_sim_tpu import jax_cache

    jax_cache.enable()

    from galileo_sdr_sim_tpu import scenes
    from galileo_sdr_sim_tpu.constants import NUM_IQ_SAMPLES
    from galileo_sdr_sim_tpu.ops.synth_kp import (
        K_EPOCH,
        prepare_kp_inputs,
        synth_block_kp_packed,
    )

    nav = scenes.load_nav()
    B = 64  # epochs per device call (6.4 s of signal)

    def mk_eng(dur, **kw):
        return scenes.engine(nav, duration_s=dur, **kw)

    batch = next(mk_eng(0.1 * B + 0.5).batches(B))
    inputs = prepare_kp_inputs(batch, NUM_IQ_SAMPLES, pad_epochs=B)

    def device_rate(inp, nsamp):
        synth_block_kp_packed(inp, n_k=K_EPOCH).block_until_ready()
        vals = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                synth_block_kp_packed(inp, n_k=K_EPOCH).block_until_ready()
            vals.append(nsamp * CALLS / (time.perf_counter() - t0))
        return vals

    stats = {}
    stats["samples_per_sec"] = _stats(device_rate(inputs, B * NUM_IQ_SAMPLES))
    sps = stats["samples_per_sec"]["median"]

    # CBOC(6,1,1/11) (models/cboc.py) through the (K,p) weight branch
    from galileo_sdr_sim_tpu.models.cboc import ALPHA, BETA

    cboc_inputs = dict(inputs)
    cboc_inputs["cboc_ab"] = jnp.asarray([ALPHA, BETA], jnp.float32)
    stats["cboc_samples_per_sec"] = _stats(
        device_rate(cboc_inputs, B * NUM_IQ_SAMPLES)
    )

    # B=1: the CLI's interactive (-i) block shape
    b1_inputs = {k: (v if k == "vpack" else v[:1]) for k, v in inputs.items()}
    stats["b1_samples_per_sec"] = _stats(device_rate(b1_inputs, NUM_IQ_SAMPLES))

    # receiver PVT fix from samples the production pipeline emitted
    from galileo_sdr_sim_tpu.io.sinks import NullSink
    from galileo_sdr_sim_tpu.io.stream import StreamingSynthesizer

    fix = scenes.fix_error(scenes.stream(nav))
    fix_error_m, n_sats_decoded = fix if fix is not None else (None, None)

    # device-resident sink: a per-block jitted checksum is the only
    # readback, so executor overhead shows without the D2H copy
    csum = jax.jit(lambda o: jnp.sum(o[:, :, :128].astype(jnp.float32)))
    DEV_DUR = 20.0
    float(csum(synth_block_kp_packed(inputs, n_k=K_EPOCH)))  # warm

    def devsink_serial():
        cache_d: dict = {}
        t0 = time.perf_counter()
        n = 0
        sums = []
        for b in mk_eng(DEV_DUR).batches(B):
            inp = prepare_kp_inputs(
                b, NUM_IQ_SAMPLES, pad_epochs=B, code_cache=cache_d
            )
            sums.append(csum(synth_block_kp_packed(inp, n_k=K_EPOCH)))
            n += b.f_code.shape[0]
        float(sum(float(s) for s in sums))
        return n * NUM_IQ_SAMPLES / (time.perf_counter() - t0)

    class _DevSink:
        def __init__(self):
            self.sums = []

        def write(self, blk):
            self.sums.append(
                csum(blk) if not isinstance(blk, np.ndarray)
                else float(blk.reshape(blk.shape[0], -1)[:, :128]
                           .astype(np.float32).sum())
            )

        def close(self):
            pass

    def devsink_exec():
        dsink = _DevSink()
        t0 = time.perf_counter()
        st = StreamingSynthesizer(
            mk_eng(DEV_DUR), dsink, block_epochs=B, drain_host=False,
        ).run()
        float(sum(float(s) for s in dsink.sums))
        return st.samples / (time.perf_counter() - t0)

    ser_vals, exe_vals = [], []
    for _ in range(REPS):
        ser_vals.append(devsink_serial())
        exe_vals.append(devsink_exec())
    stats["devsink_samples_per_sec"] = _stats(ser_vals)
    stats["devsink_pipelined_samples_per_sec"] = _stats(exe_vals)

    # --bandlimit: 12 phase-shifted (K,p) calls + one polyphase conv
    from galileo_sdr_sim_tpu.models.cboc import E1_CBOC
    from galileo_sdr_sim_tpu.ops.bandlimit import (
        initial_state,
        synth_block_cboc_bandlimited,
    )

    def bl_run(dur):
        cache: dict = {}
        state = initial_state()
        n = 0
        last = None
        t0 = time.perf_counter()
        for b in mk_eng(dur, model=E1_CBOC).batches(B):
            last, state = synth_block_cboc_bandlimited(
                b, NUM_IQ_SAMPLES, pad_epochs=B, code_cache=cache, state=state,
            )
            n += b.f_code.shape[0]
        last.block_until_ready()
        return n * NUM_IQ_SAMPLES / (time.perf_counter() - t0)

    bl_run(0.1 * B + 0.5)  # warm
    stats["cboc_bandlimited_samples_per_sec"] = _stats(
        [bl_run(DEV_DUR) for _ in range(REPS)]
    )

    # end to end: scenario engine -> device -> drained int16 on host
    StreamingSynthesizer(mk_eng(0.1 * B + 0.5), NullSink(), block_epochs=B).run()
    stats["e2e_samples_per_sec"] = _stats([
        StreamingSynthesizer(mk_eng(25.0), NullSink(), block_epochs=B)
        .run().samples_per_sec
        for _ in range(REPS)
    ])

    def host_only():
        cache: dict = {}
        t0 = time.perf_counter()
        n = 0
        for b in mk_eng(30.0).batches(B):
            prepare_kp_inputs(b, NUM_IQ_SAMPLES, pad_epochs=B, code_cache=cache)
            n += b.f_code.shape[0]
        return n * NUM_IQ_SAMPLES / (time.perf_counter() - t0)

    stats["host_engine_samples_per_sec"] = _stats(
        [host_only() for _ in range(REPS)]
    )

    dev = jax.devices()[0]
    med = {k: v["median"] for k, v in stats.items()}
    print(json.dumps({
        "metric": "samples_per_sec",
        "value": sps,
        "unit": "samples/s",
        "vs_baseline": sps / 2.6e6,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **{k: v for k, v in med.items() if k != "samples_per_sec"},
        "e2e_vs_baseline": med["e2e_samples_per_sec"] / 2.6e6,
        "fix_error_m": fix_error_m,
        "n_sats_decoded": n_sats_decoded,
        "stats": stats,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
