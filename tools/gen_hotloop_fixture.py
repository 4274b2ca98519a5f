"""Generate the sample-level hot-loop A/B fixture from the compiled
reference loop.

tests/ref_harness/hotloop.cpp carries a line-faithful transcription of
the reference's sequential NCO sample loop (galileo-sdr.cpp:481-539 —
double NCO accumulation, 512-entry integer trig LUT, integer channel
accumulation, C (short) truncation).  This script runs the repo's own
scenario engine to produce real per-epoch channel states from the
in-repo navigation file (rinex.NAV_FILE), drives the compiled loop with
those states and the repository's extracted reference tables, and
stores the resulting int16 I/Q epochs in tests/data/hotloop_ref_iq.npz.
It needs only g++.

What the fixture shares with the program, and what it does not: the
scene states come from the program's scenario engine (its geometry is
pinned separately, by tests/test_obs_ref_ab.py), and the code, LUT and
secondary-code tables are the ones tools/extract_reference_tables.py
took from the upstream headers.  The harness reads those tables raw and
does its own chip mapping and BOC(1,1) expansion, so an error in the
package's `codes` expansion or loaders would show as a mismatch.

tests/test_hotloop_ref_ab.py then re-derives the same states (the engine
is deterministic) and asserts the lut512 XLA engine reproduces the
reference loop's stream sample-for-sample (stated bound: exact-match
fraction + correlation; residual mismatches are single-sample chip/LUT
boundary ticks from the affine float32 phase vs the sequential float64
NCO — see the test's docstring).

Run from the repo root:  python tools/gen_hotloop_fixture.py
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "hotloop_ref_iq.npz"

sys.path.insert(0, str(REPO))

from galileo_sdr_sim_tpu.constants import NUM_IQ_SAMPLES, SAMP_RATE  # noqa: E402

# epochs (iumd) captured: first epoch, mid-chunk, and one past the first
# 30 s reallocation boundary
SCENE_EPOCHS = [1, 17, 305]


def build_harness(out_dir: Path) -> Path:
    exe = out_dir / "hotloop"
    subprocess.run(
        ["g++", "-O1", "-o", str(exe),
         str(REPO / "tests" / "ref_harness" / "hotloop.cpp")],
        check=True,
    )
    return exe


def _raw_tables() -> dict:
    """The extracted upstream tables, read straight from the archive and
    not through the package's `codes` loaders, so the harness's own
    codegen/sboc transcription stays an independent witness."""
    with np.load(REPO / "galileo_sdr_sim_tpu" / "data" / "e1_codes.npz") as z:
        return {k: z[k] for k in ("cos512", "sin512", "secondary",
                                  "e1b_bits", "e1c_bits")}


def tables_line() -> str:
    """The LUTs and secondary-code bits the transcribed loop reads."""
    t = _raw_tables()
    vals = [*t["cos512"].tolist(), *t["sin512"].tolist(),
            *t["secondary"].tolist()]
    return "tables " + " ".join(str(int(v)) for v in vals)


def code_bits(prn: int, component: str) -> str:
    """The PRN's 4092 primary-code bits as '0'/'1' (1-based PRN)."""
    key = {"E1B": "e1b_bits", "E1C": "e1c_bits"}[component]
    return "".join(str(int(b)) for b in _raw_tables()[key][prn - 1])


def scene_states():
    """Deterministic scenario states at SCENE_EPOCHS of the 08:00:01
    scene (galileo_sdr_sim_tpu/scenes.py)."""
    from galileo_sdr_sim_tpu import scenes

    _, tabs = scenes.epochs_at(scenes.load_nav(), SCENE_EPOCHS)
    return [tabs[i] for i in SCENE_EPOCHS]


def harness_page_bits(tab, slot) -> str:
    """Rebuild the 500-entry page the transcribed loop reads, from the
    tab's symbol window: sym_win[k] is the +-1 databit for wrap count k,
    i.e. symbol index (ibit0 + k) (mod 500 across a page rollover, where
    the loop wraps ibit back into the same array)."""
    page = np.zeros(500, np.int64)
    ib0 = int(tab.ibit0[slot])
    for k in range(tab.sym_win.shape[1]):
        page[(ib0 + k) % 500] = 1 if tab.sym_win[slot, k] < 0 else 0
    return "".join(str(b) for b in page)


def run_reference_loop(exe: Path, tab) -> np.ndarray:
    delt = 1.0 / SAMP_RATE
    lines = [tables_line()]
    for slot in range(len(tab.prn)):
        prn = int(tab.prn[slot])
        if prn <= 0:
            continue
        lines.append(
            f"chan {slot} {prn} "
            f"{float(tab.f_carr[slot])!r} {float(tab.f_code[slot])!r} "
            f"{float(tab.code_phase0[slot])!r} {float(tab.carr_phase0[slot])!r} "
            f"{int(tab.ibit0[slot])} {harness_page_bits(tab, slot)} "
            f"{code_bits(prn, 'E1B')} {code_bits(prn, 'E1C')}"
        )
    lines.append(f"hotrun {NUM_IQ_SAMPLES} {delt!r}")
    proc = subprocess.run(
        [str(exe)], input="\n".join(lines) + "\n",
        capture_output=True, text=True, check=True,
    )
    if proc.stderr:
        sys.stderr.write(proc.stderr)
    out = proc.stdout.strip().split()
    assert out[0] == "hot" and int(out[1]) == NUM_IQ_SAMPLES
    hexs = out[2]
    assert len(hexs) == NUM_IQ_SAMPLES * 8
    raw = np.frombuffer(bytes.fromhex(hexs), dtype=">u2").astype(np.uint16)
    return raw.view(np.int16).astype(np.int16)  # interleaved I/Q


def main() -> None:
    import tempfile

    from galileo_sdr_sim_tpu import scenes

    exe = build_harness(Path(tempfile.mkdtemp()))
    tabs = scene_states()
    arrays = {}
    meta = []
    for iumd, tab in zip(SCENE_EPOCHS, tabs):
        iq = run_reference_loop(exe, tab)
        arrays[f"iq_{iumd}"] = iq
        meta.append({
            "iumd": iumd,
            "grx_sec": float(tab.grx_sec),
            "n_chan": int((tab.prn > 0).sum()),
            "state_digest": scenes.state_digest(tab),
        })
        print(f"epoch {iumd}: {meta[-1]}")
    np.savez_compressed(
        OUT, meta=json.dumps({"scene_epochs": SCENE_EPOCHS, "scenes": meta}),
        **arrays,
    )
    print(f"wrote {OUT} ({OUT.stat().st_size/1e6:.2f} MB)")


if __name__ == "__main__":
    main()
