"""chip_smoke.py's CPU-side contract: its comparison helpers on small
shapes, and its refusal to report success without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def test_compare_iq_statistics():
    ref = np.array([100, -100, 50, 50, 0, 10, -30, 7], np.int16)
    out = ref.copy()
    out[2] += 3  # one sample off by 3 LSB
    st = cs.compare_iq(out, ref)
    assert st["identity"] == pytest.approx(7 / 8)
    assert st["max_abs"] == 3
    assert 0.99 < st["corr"] < 1.0
    assert cs.compare_iq(ref, ref) == {
        "identity": 1.0, "corr": pytest.approx(1.0), "max_abs": 0, "p999": 0.0
    }
    with pytest.raises(cs.PhaseFailed):
        cs.compare_iq(ref[:4], ref)


def test_violations_and_check():
    st = {"identity": 0.996, "corr": 0.9985, "max_abs": 1000, "p999": 12.0}
    assert cs.violations(st, cs.TOL_LUT512) == [
        "corr=0.9985 not >= 0.999"
    ]
    assert cs.violations({**st, "corr": 0.9995}, cs.TOL_LUT512) == []
    assert cs.violations({**st, "max_abs": 1041}, cs.TOL_KP) == [
        "corr=0.9985 not >= 0.999", "max_abs=1041 not <= 1040"
    ]
    with pytest.raises(cs.PhaseFailed, match="identity"):
        cs.check("x", {"identity": 0.5, "max_abs": 0}, cs.TOL_BANDLIMIT)


def test_expected_bytes_follow_the_engine_epoch_count():
    # -d D emits round(10 D) - 1 epochs (the first epoch initialises)
    assert cs.expected_bytes(0.5) == 4 * 260000 * 4
    assert cs.expected_bytes(5.0) == 49 * 260000 * 4


def _run(script: Path, cwd: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_refuses_without_gpu():
    r = _run(REPO / "chip_smoke.py", REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "need 1 GPU" in r.stderr


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
