#!/usr/bin/env python3
"""Smoke run of the E1 synthesis main path on one GPU, from the repo alone.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-process
                                       # CLI path and its comparison only

Phases (one process, one card; any failure exits non-zero):

1. device  — JAX must report a GPU; there is no CPU fallback.
2. cli     — `cli.main` writes the 08:00:01 scene (5 s sine-BOC, 5 s
             CBOC, 1 s --bandlimit) to int16 files of exactly
             len(ScenarioEngine) * 260000 * 4 bytes.
3. compare — the card's output against the plain references at the
             full 2.6 Msps width: the compiled reference hot-loop
             stream (tests/data/hotloop_ref_iq.npz), the float64 oracle
             (ops/oracle.py) for one full epoch, and the float64 NumPy
             band-limit filter (ops/oracle.bandlimit_filter_oracle).
4. receiver — PCPS acquisition of the GPU-emitted CLI file (present PRNs
             acquire, absent ones do not) and a PVT fix from the 19 s
             08:00:18 scene streamed through StreamingSynthesizer.

The card's name and power limit (nvidia-smi) precede the last line,
which is exactly {"ok": true, "device": {...}} on success.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BYTES_PER_EPOCH = 260000 * 4  # int16 I and Q per sample

# Tolerances, each with the test that states its reason.
# lut512 direct engine vs the reference loop / float64 oracle
# (tests/test_hotloop_ref_ab.py::test_lut512_engine_vs_reference_loop)
TOL_LUT512 = {"identity": (">=", 0.995), "corr": (">=", 0.999),
              "max_abs": ("<=", 4 * 250)}
# (K,p) production engine (float32 sin/cos carrier) vs the same
# (tests/test_hotloop_ref_ab.py::test_kp_engine_vs_reference_loop)
TOL_KP = {"identity": (">=", 0.03), "corr": (">=", 0.999),
          "p999": ("<=", 40), "max_abs": ("<=", 4 * 250 + 40)}
# float32 HIGHEST-precision band-limit filter vs float64 NumPy
TOL_BANDLIMIT = {"identity": (">=", 0.999), "max_abs": ("<=", 1)}
# four-process file vs one-process file: the psum association bound
# (parallel/distributed.py PSUM_*)
TOL_FOUR_CARDS = {"identity": (">=", 0.999), "max_abs": ("<=", 1)}


class PhaseFailed(Exception):
    pass


def compare_iq(out, ref) -> dict:
    """Sample statistics of an interleaved int16 I/Q stream against a
    reference of the same shape."""
    a = np.asarray(out).reshape(-1).astype(np.int64)
    b = np.asarray(ref).reshape(-1).astype(np.int64)
    if a.shape != b.shape:
        raise PhaseFailed(f"shape {a.shape} != reference {b.shape}")
    d = np.abs(a - b)
    ca = a[0::2] + 1j * a[1::2]
    cb = b[0::2] + 1j * b[1::2]
    den = np.linalg.norm(ca) * np.linalg.norm(cb)
    return {
        "identity": float(np.mean(d == 0)),
        "corr": float(abs(np.vdot(ca, cb)) / den) if den else 0.0,
        "max_abs": int(d.max()),
        "p999": float(np.percentile(d, 99.9)),
    }


def violations(stats: dict, tol: dict) -> list[str]:
    """The tolerance entries {stat: (">=" or "<=", limit)} that `stats`
    breaks (empty when within all)."""
    bad = []
    for name, (op, lim) in tol.items():
        val = stats[name]
        if not (val >= lim if op == ">=" else val <= lim):
            bad.append(f"{name}={val} not {op} {lim}")
    return bad


def check(label: str, stats: dict, tol: dict) -> None:
    bad = violations(stats, tol)
    print(f"  {label}: {json.dumps(stats)} tolerance {json.dumps(tol)} "
          f"{'ok' if not bad else 'FAILED ' + '; '.join(bad)}")
    if bad:
        raise PhaseFailed(f"{label}: {'; '.join(bad)}")


def card() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def require_gpu(count: int = 1):
    """The accelerator JAX sees; raises PhaseFailed unless it is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise PhaseFailed(
            f"need {count} GPU(s), JAX reports {len(devs)} "
            f"{devs[0].platform} device(s)"
        )
    return devs[0]


def cli_args(out: Path, duration: float, *extra: str):
    from galileo_sdr_sim_tpu import scenes
    from galileo_sdr_sim_tpu.rinex import NAV_FILE

    when = "{}/{:02d}/{:02d},{:02d}:{:02d}:{:02d}".format(*scenes.SCENE_START)
    return ["-e", str(NAV_FILE), "-t", when,
            "-l", ",".join(str(v) for v in scenes.LLH), "-d", str(duration),
            "-U", "1", "-b", "1", "-o", str(out), *extra]


def expected_bytes(duration: float) -> int:
    """Bytes a CLI run of the 08:00:01 scene writes: one int16 I/Q pair
    per sample for each epoch the scenario engine emits."""
    from galileo_sdr_sim_tpu import scenes

    return len(scenes.engine(scenes.load_nav(), duration_s=duration)) * BYTES_PER_EPOCH


def run_cli(out: Path, duration: float, *extra: str) -> float:
    from galileo_sdr_sim_tpu.cli import main

    t0 = time.perf_counter()
    rc = main(cli_args(out, duration, *extra))
    wall = time.perf_counter() - t0
    want = expected_bytes(duration)
    got = out.stat().st_size if out.exists() else -1
    print(f"  cli -d {duration} {' '.join(extra) or '(sine-BOC)'}: rc={rc} "
          f"{got} bytes (expected {want}) in {wall:.3f} s")
    if rc != 0 or got != want:
        raise PhaseFailed(f"cli {extra}: rc={rc}, {got} != {want} bytes")
    if not np.abs(np.fromfile(out, np.int16, count=520000)).max():
        raise PhaseFailed(f"cli {extra}: silent output")
    return wall


def phase_cli(work: Path) -> None:
    sine = work / "sine.ishort"
    cold = run_cli(sine, 5.0)
    warm = run_cli(sine, 5.0)
    n = expected_bytes(5.0) // 4
    print(f"  informative: first run {cold:.3f} s, second {warm:.3f} s "
          f"(compile and cache load ~{cold - warm:.3f} s); steady "
          f"{n / warm:.0f} samples/s including CLI set-up")
    run_cli(work / "cboc.ishort", 5.0, "--model", "cboc")
    run_cli(work / "bandlimit.ishort", 1.0, "--bandlimit")


def phase_compare() -> None:
    import jax.numpy as jnp

    from galileo_sdr_sim_tpu import scenes
    from galileo_sdr_sim_tpu.constants import NUM_IQ_SAMPLES
    from galileo_sdr_sim_tpu.models.cboc import E1_CBOC
    from galileo_sdr_sim_tpu.ops import bandlimit
    from galileo_sdr_sim_tpu.ops.oracle import (
        bandlimit_filter_oracle, synth_epoch_oracle)
    from galileo_sdr_sim_tpu.ops.synth import prepare_device_inputs, synth_block
    from galileo_sdr_sim_tpu.ops.synth_kp import (
        P_GRID, prepare_kp_inputs, synth_batch_kp_host, synth_block_kp)

    print("  precision: float32 device math; the one-hot row einsum and "
          "the band-limit convolution run at lax.Precision.HIGHEST")
    nav = scenes.load_nav()

    def lut512(batch):
        inp = prepare_device_inputs(batch, nsamples=NUM_IQ_SAMPLES)
        return np.asarray(synth_block(inp, mode="lut512"))[0, : 2 * NUM_IQ_SAMPLES]

    fx = np.load(HERE / "tests" / "data" / "hotloop_ref_iq.npz")
    meta = json.loads(str(fx["meta"]))
    eng, tabs = scenes.epochs_at(nav, meta["scene_epochs"])
    for rec in meta["scenes"]:
        iumd = rec["iumd"]
        if scenes.state_digest(tabs[iumd]) != rec["state_digest"]:
            raise PhaseFailed(f"scene state drifted at epoch {iumd}")
        batch, ref = eng._pack([tabs[iumd]]), fx[f"iq_{iumd}"]
        check(f"hotloop epoch {iumd} lut512", compare_iq(lut512(batch), ref),
              TOL_LUT512)
        check(f"hotloop epoch {iumd} (K,p)",
              compare_iq(synth_batch_kp_host(batch)[0], ref), TOL_KP)

    eng, tabs = scenes.epochs_at(nav, [1], scenes.PVT_START)
    batch = eng._pack([tabs[1]])
    oracle = synth_epoch_oracle(batch, 0)
    check("oracle 08:00:18 epoch 1 lut512", compare_iq(lut512(batch), oracle),
          TOL_LUT512)
    check("oracle 08:00:18 epoch 1 (K,p)",
          compare_iq(synth_batch_kp_host(batch)[0], oracle), TOL_KP)

    eng, tabs = scenes.epochs_at(nav, range(1, 9), model=E1_CBOC)
    batch = eng._pack([tabs[i] for i in range(1, 9)])
    phases = np.stack([
        np.asarray(synth_block_kp(
            prepare_kp_inputs(bandlimit.phase_shift_batch(batch, j),
                              NUM_IQ_SAMPLES),
            n_k=NUM_IQ_SAMPLES // P_GRID))
        for j in range(bandlimit.OS)
    ])
    hist = np.random.default_rng(0).normal(0, 300, (2, bandlimit.OS, 2 * bandlimit.V0))
    out, _ = bandlimit._filter_block(jnp.asarray(phases), jnp.asarray(hist, jnp.float32),
                                     jnp.int32(8))
    ref, _ = bandlimit_filter_oracle(phases, hist.astype(np.float32), 8)
    check("band-limit filter B=8", compare_iq(np.asarray(out), ref), TOL_BANDLIMIT)


def phase_receiver(sine_file: Path) -> None:
    from galileo_sdr_sim_tpu import scenes
    from galileo_sdr_sim_tpu.codes import boc_chips
    from galileo_sdr_sim_tpu.constants import SAMP_RATE
    from galileo_sdr_sim_tpu.rx_track import iq_to_complex

    nav = scenes.load_nav()
    tab = scenes.epochs_at(nav, [1])[1][1]
    present = {int(p): float(f) for p, f in zip(tab.prn, tab.f_carr) if p > 0}
    # PCPS over the first 4 ms code period of the GPU-emitted CLI file
    # (tests/test_e2e_acquisition.py)
    n = 10400
    x = iq_to_complex(np.fromfile(sine_file, np.int16, count=2 * n))
    t = np.arange(n) / SAMP_RATE
    idx = np.floor(t * 2 * 1.023e6).astype(int) % 8184

    def acquire(prn, dopplers):
        rf = np.conj(np.fft.fft(boc_chips("E1B")[prn - 1][idx].astype(float)))
        best = (0.0, 0.0)
        for dop in dopplers:
            c = np.abs(np.fft.ifft(np.fft.fft(x * np.exp(-2j * np.pi * dop * t)) * rf))
            best = max(best, (c.max() / np.median(c), dop))
        return best

    for prn, f in present.items():
        metric, dop = acquire(prn, np.arange(f - 600, f + 601, 200))
        print(f"  acquisition PRN {prn}: peak/median {metric:.1f} at {dop:.0f} Hz "
              f"(true {f:.0f} Hz; need >= 8 within 200 Hz)")
        if metric < 8.0 or abs(dop - f) > 200:
            raise PhaseFailed(f"PRN {prn} not acquired")
    for prn in [p for p in (7, 13, 22, 30) if p not in present][:2]:
        metric, _ = acquire(prn, np.arange(-4000, 4001, 500))
        print(f"  acquisition absent PRN {prn}: peak/median {metric:.1f} (need < 8)")
        if metric >= 8.0:
            raise PhaseFailed(f"absent PRN {prn} acquired")

    x16 = scenes.stream(nav)  # 19 s from 08:00:18, B=8 blocks
    fix = scenes.fix_error(x16)
    if fix is None:
        raise PhaseFailed("receiver produced no PVT fix")
    err, n_sats = fix
    print(f"  PVT fix from {x16.size / 2 / SAMP_RATE:.1f} s of stream: "
          f"{err:.3f} m error, {n_sats} satellites (need < 15 m)")
    if err >= 15.0:
        raise PhaseFailed(f"PVT error {err:.3f} m")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_four_cards(work: Path, n: int = 4, timeout: float = 900.0) -> None:
    """The multi-process CLI path: n processes, one per card, against the
    same scene written by one process on one card."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_VISIBLE_DEVICES", "JAX_LOCAL_DEVICE_IDS")}
    cli = [sys.executable, "-m", "galileo_sdr_sim_tpu.cli"]
    one = work / "one_card.ishort"
    t0 = time.perf_counter()
    subprocess.run([*cli, *cli_args(one, 5.0)], cwd=HERE, check=True,
                   timeout=timeout, env={**env, "CUDA_VISIBLE_DEVICES": "0"})
    print(f"  one process, card 0: {time.perf_counter() - t0:.3f} s")
    many = work / "four_cards.ishort"
    coord = f"localhost:{_free_port()}"
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [*cli, *cli_args(many, 5.0)], cwd=HERE,
            env={**env, "GALILEO_COORDINATOR": coord,
                 "GALILEO_NUM_PROCESSES": str(n), "GALILEO_PROCESS_ID": str(i)},
        )
        for i in range(n)
    ]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print(f"  {n} processes, one card each: rc={rcs} "
          f"{time.perf_counter() - t0:.3f} s")
    if any(rcs):
        raise PhaseFailed(f"distributed CLI exit codes {rcs}")
    want = expected_bytes(5.0)
    a = np.fromfile(many, np.int16)
    if a.nbytes != want:
        raise PhaseFailed(f"{a.nbytes} bytes != {want}")
    check(f"{n}-card file vs 1-card file", compare_iq(a, np.fromfile(one, np.int16)),
          TOL_FOUR_CARDS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card multi-process CLI phase")
    args = ap.parse_args(argv)
    if args.four_cards:
        # the check below must not reserve memory on the cards the four
        # worker processes use
        os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    sys.path.insert(0, str(HERE))
    os.chdir(HERE)
    try:
        dev = require_gpu(4 if args.four_cards else 1)
        print(f"device: {dev.platform} {dev.device_kind}; card: {card()}")
        with tempfile.TemporaryDirectory() as tmp:
            work = Path(tmp)
            phases = (
                [("four-cards", lambda: phase_four_cards(work))]
                if args.four_cards else
                [("cli", lambda: phase_cli(work)),
                 ("compare", phase_compare),
                 ("receiver", lambda: phase_receiver(work / "sine.ishort"))]
            )
            for name, fn in phases:
                t0 = time.perf_counter()
                print(f"phase {name}:", flush=True)
                fn()
                print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
                      flush=True)
        import jax

        line = card()
    except (PhaseFailed, subprocess.SubprocessError, OSError) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(f"card: {line}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
