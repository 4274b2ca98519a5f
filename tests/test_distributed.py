"""Multi-host validation: a 2-process CPU 'pod' (4 virtual devices each)
must produce a byte-identical stream to the single-process path.

This is the DCN-side counterpart of tests/test_sharding.py (SURVEY §4e:
N-process CPU collectives faking a pod): jax.distributed bootstraps the
group, time shards are process-local, each process offset-writes its own
epoch segments into the shared sink file.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

WORKER = Path(__file__).parent / "_distributed_worker.py"
NS = 10400


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_pod_matches_single(tmp_path, batch_1s):
    out = tmp_path / "dist.ishort"
    port = _free_port()
    repo = WORKER.parent.parent
    env = {**os.environ, "PYTHONPATH": str(repo)}
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), "2", str(port), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(repo), env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(stdout)
    for pid, (p, stdout) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{stdout[-3000:]}"
        assert f"WORKER{pid} OK" in stdout

    # single-process oracle on the same deterministic scenario
    from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
    from galileo_sdr_sim_tpu.ops.synth_kp import synth_batch_kp_host
    from galileo_sdr_sim_tpu.rinex import NAV_FILE, read_rinex_v3
    from galileo_sdr_sim_tpu.scenario import (
        PositionProvider,
        ScenarioEngine,
        scenario_start_time,
    )

    nav = read_rinex_v3(NAV_FILE)
    g0 = scenario_start_time(nav, date2gal(DateTime(2022, 2, 20, 8, 0, 1)))
    eng = ScenarioEngine(
        nav,
        PositionProvider(llh_deg=np.array([42.3601, -71.0589, 100.0])),
        g0,
        duration_s=0.5,
    )
    batch = next(eng.batches(4))
    expected = synth_batch_kp_host(batch, NS)  # (4, 2*NS)

    got = np.fromfile(out, dtype=np.int16).reshape(4, 2 * NS)
    # psum association bound, stated centrally in parallel/distributed.py
    from galileo_sdr_sim_tpu.parallel.distributed import (
        PSUM_MAX_LSB, PSUM_SAMPLE_IDENTITY_BOUND,
    )

    frac = (got == expected).mean()
    assert frac > PSUM_SAMPLE_IDENTITY_BOUND, f"only {frac:.4%} samples identical"
    assert np.max(np.abs(got.astype(np.int32) - expected.astype(np.int32))) <= PSUM_MAX_LSB

    # phase 2: full generate_file_distributed driver, 6 epochs in batches
    # of 3 (time axis 2 -> padding exercised)
    eng2 = ScenarioEngine(
        nav,
        PositionProvider(llh_deg=np.array([42.3601, -71.0589, 100.0])),
        g0,
        duration_s=0.7,
    )
    expected2 = np.concatenate(
        [synth_batch_kp_host(b, NS) for b in eng2.batches(3)]
    )
    got2 = np.fromfile(str(out) + ".full", dtype=np.int16).reshape(6, 2 * NS)
    frac2 = (got2 == expected2).mean()
    assert frac2 > PSUM_SAMPLE_IDENTITY_BOUND, f"only {frac2:.4%} samples identical"
    assert np.max(np.abs(got2.astype(np.int32) - expected2.astype(np.int32))) <= PSUM_MAX_LSB


@pytest.mark.parametrize(
    "env, pid, want",
    [
        ({}, 2, [2]),  # one host: the process id among the host's cards
        ({"CUDA_VISIBLE_DEVICES": "0,1,2,3"}, 6, [2]),  # modulo the cards
        ({"CUDA_VISIBLE_DEVICES": "4,5"}, 1, [1]),  # index among visible
        ({"CUDA_VISIBLE_DEVICES": "0,1,2,3", "LOCAL_RANK": "3"}, 7, [3]),
        ({"LOCAL_RANK": "1"}, 5, [1]),  # several hosts: launcher's rank
        ({"CUDA_VISIBLE_DEVICES": "2"}, 3, None),  # launcher chose a card
        ({"CUDA_VISIBLE_DEVICES": ""}, 0, None),  # no card visible
        ({"JAX_LOCAL_DEVICE_IDS": "1"}, 0, None),  # JAX reads it itself
    ],
)
def test_local_card_ids(env, pid, want, monkeypatch):
    """Each process keeps one card, named by its local rank, unless the
    launcher already chose its card."""
    from galileo_sdr_sim_tpu.parallel import distributed

    monkeypatch.setattr(distributed, "_host_card_count", lambda: 4)
    assert distributed.local_card_ids(pid, env) == want
