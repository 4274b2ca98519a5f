"""CLI tests (reference: src/main.cpp option surface)."""

import subprocess
import sys

import numpy as np
import pytest

from galileo_sdr_sim_tpu.cli import build_parser, load_user_motion
from galileo_sdr_sim_tpu.rinex import NAV_FILE


def test_flag_parsing():
    p = build_parser()
    args = p.parse_args(
        ["-e", "nav.rnx", "-o", "out.bin", "-l", "1.5,-2.5,100",
         "-t", "2022/02/20,08:00:01", "-d", "30", "-U", "1", "-b", "1", "-v"]
    )
    assert args.navfile == "nav.rnx"
    assert args.outfile == "out.bin"
    assert args.llh == "1.5,-2.5,100"
    assert args.duration == 30.0
    assert args.disable_usrp == "1"
    assert args.disable_bitstream == "1"
    assert args.verbose


def test_defaults_match_reference():
    args = build_parser().parse_args(["-e", "nav.rnx"])
    # main.cpp:186-196: default duration 300 s, USRP on, bit stream on,
    # default Boston-ish location, default outfile name
    assert args.duration == 300.0
    assert args.disable_usrp is None
    assert args.disable_bitstream is None
    assert args.outfile == "galileosim.ishort"
    assert args.llh.startswith("42.3601")


def test_missing_navfile_errors():
    from galileo_sdr_sim_tpu.cli import main

    assert main([]) == 1


def test_model_flag(tmp_path):
    """--model cboc generates through the CBOC signal model; the output
    still acquires with a sine-BOC replica (full chain covered in
    test_cboc.py — here we pin the CLI plumbing)."""
    import numpy as np

    from galileo_sdr_sim_tpu.cli import main

    args = build_parser().parse_args(["-e", "nav.rnx"])
    assert args.model == "e1"  # reference-parity default

    out = tmp_path / "cboc.ishort"
    rc = main([
        "-e", str(NAV_FILE),
        "-U", "1", "-b", "1", "-d", "0.3", "-o", str(out),
        "-t", "2022/02/20,08:00:01", "--model", "cboc",
    ])
    assert rc == 0
    x16 = np.fromfile(out, dtype=np.int16)
    assert x16.size > 0
    from galileo_sdr_sim_tpu.rx_track import acquire, iq_to_complex

    a = acquire(iq_to_complex(x16), 15)
    assert a.metric > 8.0, a.metric


def test_invalid_time_rejected():
    from galileo_sdr_sim_tpu.cli import _parse_time

    with pytest.raises(SystemExit):
        _parse_time("2022/13/01,00:00:00")
    with pytest.raises(SystemExit):
        _parse_time("1979/01/01,00:00:00")
    g = _parse_time("2022/02/20,08:00:01")
    assert g.week == 2198


def test_user_motion_llh(tmp_path):
    f = tmp_path / "motion.csv"
    f.write_text("42.0,-71.0,100\n42.001,-71.0,100\n")
    traj = load_user_motion(f)
    assert traj.shape == (2, 3)
    assert traj[0, 0] == 42.0


def test_cli_relay_timeout_fallback(tmp_path):
    """Default bit-relay mode (no -b) must not hang forever when no bits
    arrive and --relay-timeout is given: it falls back to ephemeris nav
    messages and still produces the file."""
    from galileo_sdr_sim_tpu.cli import main

    out = tmp_path / "relay.ishort"
    rc = main([
        "-e", str(NAV_FILE),
        "-t", "2022/02/20,08:00:01", "-d", "0.5", "-U", "1",
        "-o", str(out), "--relay-timeout", "0.2", "--block-epochs", "2",
    ])
    assert rc == 0
    data = np.fromfile(out, dtype=np.int16)
    assert data.size == 4 * 260000 * 2  # numd-1 epochs of interleaved I/Q
    assert np.any(data != 0)


def test_cli_relay_bits_received(tmp_path):
    """With a live sender on UDP 7531 the CLI proceeds past the wait loop
    (reference: galileo-sdr.cpp:389-416) and completes."""
    import socket
    import struct
    import threading

    from galileo_sdr_sim_tpu.cli import main
    from galileo_sdr_sim_tpu.io.udp import INCOMING_SIZE

    stop = threading.Event()

    def sender():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        vals = [11.0] + [0.0] * (INCOMING_SIZE - 2) + [0.0]
        pkt = struct.pack(f"<{INCOMING_SIZE}d", *vals)
        while not stop.is_set():
            tx.sendto(pkt, ("127.0.0.1", 7531))
            stop.wait(0.1)
        tx.close()

    th = threading.Thread(target=sender, daemon=True)
    th.start()
    try:
        out = tmp_path / "relay2.ishort"
        rc = main([
            "-e", str(NAV_FILE),
            "-t", "2022/02/20,08:00:01", "-d", "0.4", "-U", "1",
            "-o", str(out), "--relay-timeout", "30", "--block-epochs", "2",
        ])
        assert rc == 0
        assert out.stat().st_size > 0
    finally:
        stop.set()
        th.join()


def test_user_motion_ecef(tmp_path):
    from galileo_sdr_sim_tpu.geodesy import llh2xyz

    xyz = llh2xyz(np.array([0.7, -1.2, 100.0]))
    f = tmp_path / "motion.csv"
    f.write_text(f"0.0,{xyz[0]},{xyz[1]},{xyz[2]}\n")
    traj = load_user_motion(f)
    assert traj.shape == (1, 3)
    assert np.isclose(traj[0, 0], np.degrees(0.7), atol=1e-6)
    assert np.isclose(traj[0, 2], 100.0, atol=0.1)
