"""Worker process for the multi-host (2-process CPU pod) test.

Usage: python _distributed_worker.py <pid> <nproc> <port> <outfile>
Each process owns 4 virtual CPU devices; together they form a global
('time'=nproc, 'sat'=4) mesh.  Process 0 presizes the shared output file;
every process offset-writes its own epoch segments.
"""

import os
import sys

pid, nproc, port, outfile = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["GALILEO_COORDINATOR"] = f"127.0.0.1:{port}"
os.environ["GALILEO_NUM_PROCESSES"] = str(nproc)
os.environ["GALILEO_PROCESS_ID"] = str(pid)

from galileo_sdr_sim_tpu.parallel import distributed as D

assert D.maybe_initialize_from_env()

import jax
import numpy as np

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, len(jax.devices())

from galileo_sdr_sim_tpu.gnss_time import DateTime, date2gal
from galileo_sdr_sim_tpu.rinex import NAV_FILE, read_rinex_v3
from galileo_sdr_sim_tpu.scenario import (
    PositionProvider,
    ScenarioEngine,
    scenario_start_time,
)

NS = 10400  # one full (8 x 1300) row cycle per epoch

nav = read_rinex_v3(NAV_FILE)
g0 = scenario_start_time(nav, date2gal(DateTime(2022, 2, 20, 8, 0, 1)))
eng = ScenarioEngine(
    nav,
    PositionProvider(llh_deg=np.array([42.3601, -71.0589, 100.0])),
    g0,
    duration_s=0.5,
)
batch = next(eng.batches(4))
assert batch.f_code.shape[0] == 4

mesh = D.global_mesh()
assert mesh.shape == {"time": nproc, "sat": 4}
segments = D.synth_batch_kp_distributed(batch, NS, mesh=mesh)

# each process must hold exactly its 4/nproc epochs, starting at pid*2
assert sum(rows.shape[0] for _, rows in segments) == 4 // nproc, segments
assert segments[0][0] == pid * (4 // nproc), [s[0] for s in segments]

if pid == 0:
    D.presize(outfile, NS, total_epochs=4)
D.barrier("file_ready")
D.write_segments(outfile, segments, NS)
D.barrier("written")

# phase 2: the full driver, with batch sizes that need padding (3 epochs
# per batch over a 2-wide time axis)
eng2 = ScenarioEngine(
    nav,
    PositionProvider(llh_deg=np.array([42.3601, -71.0589, 100.0])),
    g0,
    duration_s=0.7,
)
n = D.generate_file_distributed(
    eng2, outfile + ".full", block_epochs=3, nsamples=NS
)
assert n == 6, n
print(f"WORKER{pid} OK", flush=True)
