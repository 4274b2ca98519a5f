#!/usr/bin/env python3
"""Extract ICD constant data tables from the reference headers into .npz files.

The Galileo E1 OS primary codes are *memory codes* defined by the Galileo OS
SIS ICD (Annex C) — there is no generating algorithm, so the hex strings are
data, not code.  This one-shot tool parses them (plus the NeQuick-G model
tables, which come from the ESA NeQuick-G reference implementation / Annex F
of the ICD) out of the reference C headers and packages them as NumPy
archives committed to this repo, so the framework is standalone.

Sources (data only):
  $GALILEO_UPSTREAM_DIR/include/constants.h   — E1B/E1C primary codes (50 PRNs x
                                          1023 hex chars), CRC24Q table,
                                          512-entry sin/cos tables
  $GALILEO_UPSTREAM_DIR/include/galileo-sdr.h — NeQuick-G MODIP 39x39, monthly
                                          F2[76x13]x2 / Fm3[49x9]x2 tables,
                                          Gauss-Kronrod K15/G7 nodes+weights

Run:  python tools/extract_reference_tables.py
"""

import os
import re
import sys
from pathlib import Path

import numpy as np

# the upstream galileo-sdr-sim checkout this tool reads
REF = Path(os.environ.get("GALILEO_UPSTREAM_DIR") or sys.exit(
    "set GALILEO_UPSTREAM_DIR to the upstream galileo-sdr-sim checkout")) / "include"
OUT = Path(__file__).resolve().parent.parent / "galileo_sdr_sim_tpu" / "data"


def _strip_comments(text: str) -> str:
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return text


def parse_string_array(text: str, name: str) -> list[str]:
    """Parse `char NAME[N][M] = { "..." "..." , "..." , ... };` into a list of
    concatenated strings (C adjacent-literal concatenation)."""
    m = re.search(re.escape(name) + r"[^=]*=\s*\{(.*?)\n\};", text, flags=re.S)
    if not m:
        raise ValueError(f"array {name} not found")
    body = m.group(1)
    # Split top-level on commas that are outside string literals.
    entries, cur, in_str = [], [], False
    for ch in body:
        if ch == '"':
            in_str = not in_str
            continue
        if ch == "," and not in_str:
            entries.append("".join(cur))
            cur = []
        elif in_str:
            cur.append(ch)
    if cur:
        entries.append("".join(cur))
    return [e for e in (s.strip() for s in entries) if e]


def parse_numeric_array(text: str, decl_regex: str) -> np.ndarray:
    m = re.search(decl_regex + r"\s*=\s*\{(.*?)\};", text, flags=re.S)
    if not m:
        raise ValueError(f"no match for {decl_regex}")
    body = m.group(1).replace("{", " ").replace("}", " ")
    vals = [
        float(int(t, 16)) if t.lower().startswith("0x") else float(t)
        for t in re.split(r"[,\s]+", body)
        if t
    ]
    return np.array(vals)


def crc24q_table() -> np.ndarray:
    """CRC-24Q (poly 0x1864CFB) byte-wise table, generated from the
    polynomial rather than copied."""
    poly = 0x1864CFB
    tab = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= poly
        tab[i] = crc & 0xFFFFFF
    return tab


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)

    constants_h = _strip_comments((REF / "constants.h").read_text())
    sdr_h_raw = (REF / "galileo-sdr.h").read_text()
    sdr_h = _strip_comments(sdr_h_raw)

    # --- E1 primary codes (hex) ---------------------------------------
    e1b = parse_string_array(constants_h, "GALILEO_E1_B_PRIMARY_CODE")
    e1c = parse_string_array(constants_h, "GALILEO_E1_C_PRIMARY_CODE")
    assert len(e1b) == 50 and len(e1c) == 50, (len(e1b), len(e1c))
    for s in e1b + e1c:
        assert len(s) == 1023, len(s)

    def hex_to_bits(strings: list[str]) -> np.ndarray:
        out = np.zeros((len(strings), 4092), dtype=np.uint8)
        for i, s in enumerate(strings):
            bits = np.frombuffer(
                bytes.fromhex("0" + s), dtype=np.uint8
            )  # pad to even length: leading nibble 0
            # unpack nibble-aligned: we padded on the left, so drop first 4 bits
            unpacked = np.unpackbits(bits)[4:]
            out[i] = unpacked
        return out

    codes_b = hex_to_bits(e1b)  # (50, 4092) bits {0,1}
    codes_c = hex_to_bits(e1c)

    # --- CRC24Q: generate + verify against reference table ------------
    crc_tab = crc24q_table()
    ref_crc = parse_numeric_array(
        sdr_h, r"const\s+unsigned\s+int\s+Crc24q\[256\]"
    ).astype(np.int64)
    # The reference stores entries pre-shifted left by 8 for its 32-bit
    # register algorithm (galileo-sdr.h:3459); verify modulo that shift.
    assert np.array_equal(ref_crc, crc_tab.astype(np.int64) << 8), "CRC24Q mismatch"

    # --- sin/cos 512 tables: generate analytically + verify -----------
    k = np.arange(512)
    cos_gen = np.round(250.0 * np.cos(2 * np.pi * (k + 0.5) / 512)).astype(np.int32)
    sin_gen = np.round(250.0 * np.sin(2 * np.pi * (k + 0.5) / 512)).astype(np.int32)
    ref_cos = parse_numeric_array(constants_h, r"cosTable512\[COS_TAB_LENGTH\]").astype(
        np.int32
    )
    ref_sin = parse_numeric_array(constants_h, r"sinTable512\[COS_TAB_LENGTH\]").astype(
        np.int32
    )
    if not np.array_equal(cos_gen, ref_cos) or not np.array_equal(sin_gen, ref_sin):
        print("NOTE: analytic sin/cos differ from reference; storing reference values")
        print("cos diffs:", np.nonzero(cos_gen != ref_cos)[0][:10])
        cos_gen, sin_gen = ref_cos, ref_sin

    np.savez_compressed(
        OUT / "e1_codes.npz",
        e1b_bits=codes_b,
        e1c_bits=codes_c,
        secondary=np.array(
            # E1C 25-chip secondary code CS25_1 (ICD table 19 / constants.h:213)
            [0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 1, 0, 0, 1, 0],
            dtype=np.uint8,
        ),
        sync=np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], dtype=np.uint8),
        crc24q=crc_tab,
        cos512=cos_gen,
        sin512=sin_gen,
    )
    print("wrote e1_codes.npz")

    # --- NeQuick-G tables ---------------------------------------------
    modip = parse_numeric_array(sdr_h, r"const\s+double\s+modipArr\[[^\]]*\]\[[^\]]*\]")
    modip = modip.reshape(39, 39)

    f2 = np.zeros((12, 2, 76, 13))
    fm3 = np.zeros((12, 2, 49, 9))
    for mth in range(1, 13):
        for i in (1, 2):
            f2[mth - 1, i - 1] = parse_numeric_array(
                sdr_h, rf"const\s+double\s+F2_{i}_{mth}\[76\]\[13\]"
            ).reshape(76, 13)
            fm3[mth - 1, i - 1] = parse_numeric_array(
                sdr_h, rf"const\s+double\s+Fm3_{i}_{mth}\[49\]\[9\]"
            ).reshape(49, 9)

    xi = parse_numeric_array(sdr_h, r"const\s+double\s+xi\[[^\]]*\]")
    wi = parse_numeric_array(sdr_h, r"const\s+double\s+wi\[[^\]]*\]")
    wig = parse_numeric_array(sdr_h, r"const\s+double\s+wig\[[^\]]*\]")
    assert xi.shape == (15,) and wi.shape == (15,) and wig.shape == (7,)

    np.savez_compressed(
        OUT / "nequick_tables.npz",
        modip=modip,
        f2=f2,
        fm3=fm3,
        kronrod_xi=xi,
        kronrod_wi=wi,
        gauss_wg=wig,
    )
    print("wrote nequick_tables.npz")


if __name__ == "__main__":
    sys.exit(main())
