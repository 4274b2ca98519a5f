"""Mesh-sharding tests on the 8-device virtual CPU mesh.

Validates that (sat x time)-sharded synthesis is sample-identical to the
single-device path, i.e. the psum over the satellite axis reproduces the
reference's channel accumulation and time shards are boundary-continuous.
"""

import jax
import numpy as np
import pytest

from galileo_sdr_sim_tpu.ops.synth import prepare_device_inputs, synth_block
from galileo_sdr_sim_tpu.parallel.mesh import make_mesh, synth_batch_sharded

TILE = 512
NS = 16384  # 32 tiles: divisible by time-axis sizes 1, 2, 4


@pytest.fixture(scope="module")
def single_out(batch_1s):
    inp = prepare_device_inputs(batch_1s, tile=TILE, nsamples=NS)
    return np.asarray(synth_block(inp, tile=TILE, mode="lut512"))[:, : 2 * NS]


def test_eight_devices_available():
    assert len(jax.devices()) >= 8


@pytest.mark.parametrize("n_sat,n_time", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_sharded_matches_single(batch_1s, single_out, n_sat, n_time):
    mesh = make_mesh(n_sat, n_time)
    out = synth_batch_sharded(batch_1s, mesh, tile=TILE, mode="lut512", nsamples=NS)
    assert out.shape == single_out.shape
    assert np.array_equal(out, single_out), (
        f"mesh ({n_sat},{n_time}): "
        f"{(out != single_out).mean():.2%} samples differ"
    )


def test_time_shard_boundary_continuity(batch_1s, single_out):
    """Samples at every time-shard boundary must be continuous — identical
    to the unsharded stream on both sides of each boundary."""
    mesh = make_mesh(1, 8)
    out = synth_batch_sharded(batch_1s, mesh, tile=TILE, mode="lut512", nsamples=NS)
    shard_samples = NS // 8
    for b in range(out.shape[0]):
        for s in range(1, 8):
            edge = 2 * s * shard_samples
            assert np.array_equal(
                out[b, edge - 8 : edge + 8], single_out[b, edge - 8 : edge + 8]
            )


# --- production (K,p) engine under the mesh ---------------------------

KP_NS = 10400  # one (8 x 1300) row cycle


@pytest.fixture(scope="module")
def kp_single_out(batch_1s):
    from galileo_sdr_sim_tpu.ops.synth_kp import synth_batch_kp_host

    return synth_batch_kp_host(batch_1s, KP_NS)


@pytest.mark.parametrize("n_sat,n_time", [(8, 1), (2, 4)])
def test_kp_sharded_matches_single(batch_1s, kp_single_out, n_sat, n_time):
    from galileo_sdr_sim_tpu.parallel.distributed import (
        PSUM_MAX_LSB,
        PSUM_SAMPLE_IDENTITY_BOUND,
    )
    from galileo_sdr_sim_tpu.parallel.mesh import synth_batch_kp_sharded

    mesh = make_mesh(n_sat, n_time)
    out = synth_batch_kp_sharded(
        batch_1s, mesh, nsamples=KP_NS, pad_epochs=8
    )
    ident = (out == kp_single_out).mean()
    maxlsb = np.abs(
        out.astype(np.int32) - kp_single_out.astype(np.int32)
    ).max()
    assert ident >= PSUM_SAMPLE_IDENTITY_BOUND, ident
    assert maxlsb <= PSUM_MAX_LSB, maxlsb
