"""The repository's reference scenes, shared by the tests, the fixture
tools, bench.py and chip_smoke.py.

Both are a static receiver in Boston under the in-repo navigation file
(rinex.NAV_FILE):

* SCENE_START, 2022-02-20 08:00:01 GST — the hot-loop fixture's scene
  (tools/gen_hotloop_fixture.py) and the CLI examples' scene;
* PVT_START, 08:00:18 — the I/NAV schedule puts every ephemeris word
  type on air within its first 18 s, so a receiver can fix from it.
"""

from __future__ import annotations

import hashlib

import numpy as np

LLH = (42.3601, -71.0589, 100.0)  # deg, deg, m
SCENE_START = (2022, 2, 20, 8, 0, 1)
PVT_START = (2022, 2, 20, 8, 0, 18)


def load_nav():
    from .rinex import NAV_FILE, read_rinex_v3

    return read_rinex_v3(NAV_FILE)


def engine(nav, start=SCENE_START, duration_s: float = 1.0, **kw):
    """ScenarioEngine of the static Boston receiver from `start`
    ((y, mo, d, h, mi, s) GST); `kw` goes to the engine (e.g. model)."""
    from .gnss_time import DateTime, date2gal
    from .scenario import PositionProvider, ScenarioEngine, scenario_start_time

    g0 = scenario_start_time(nav, date2gal(DateTime(*start)))
    return ScenarioEngine(nav, PositionProvider(llh_deg=np.array(LLH)), g0,
                          duration_s=duration_s, **kw)


def epochs_at(nav, iumds, start=SCENE_START, **kw):
    """(engine, {iumd: EpochTab}) for the 1-based epoch numbers `iumds`
    of the scene from `start`; `engine._pack([tab])` makes a batch."""
    want = set(iumds)
    eng = engine(nav, start, (max(want) + 2) / 10.0, **kw)
    tabs = {}
    for iumd, tab in enumerate(eng.epochs(), start=1):
        if iumd in want:
            tabs[iumd] = tab
        if len(tabs) == len(want):
            break
    return eng, tabs


def state_digest(tab) -> str:
    """Short hash of an epoch's channel states: a fixture built from the
    scene records it, so a drifted scenario engine is named as such."""
    h = hashlib.sha256()
    for arr in (tab.prn, tab.f_carr, tab.f_code, tab.code_phase0,
                tab.carr_phase0, tab.ibit0, tab.sym_win, tab.pilot_win):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def stream(nav, start=PVT_START, duration_s: float = 19.0,
           block_epochs: int = 8) -> np.ndarray:
    """The scene's int16 interleaved I/Q through the production executor
    (StreamingSynthesizer), full blocks only, so one graph is compiled."""
    from .io.sinks import Sink
    from .io.stream import StreamingSynthesizer

    class _Collect(Sink):
        def __init__(self):
            self.blocks = []

        def write(self, b):
            self.blocks.append(np.asarray(b))

    sink = _Collect()
    StreamingSynthesizer(engine(nav, start, duration_s), sink,
                         block_epochs=block_epochs).run()
    full = [b for b in sink.blocks if b.shape[0] == block_epochs]
    return np.concatenate(full).reshape(-1).astype(np.int16)


def fix_error(x16: np.ndarray):
    """(error in m from the true position, satellites used) of the
    receiver's PVT fix from an int16 stream, or None without a fix."""
    from . import geodesy
    from .constants import R2D
    from .rx_pvt import receiver_fix
    from .rx_track import iq_to_complex

    fix = receiver_fix(iq_to_complex(x16))
    if fix is None:
        return None
    truth = geodesy.llh2xyz(np.array([LLH[0] / R2D, LLH[1] / R2D, LLH[2]]))
    return (float(np.linalg.norm(fix.solution.xyz - truth)),
            int(fix.solution.n_sats))
