"""D-STAR radio-header decode past the header sync.

reference behavior: decoder_modules/ch_extravhf_decoder/src/dsp/
dsd_dstar.cpp — on a D-STAR header sync the reference descrambles,
deinterleaves and Viterbi-decodes the 660-bit radio header into 41
octets (flags + RPT2/RPT1/UR/MY callsigns + suffix + FCS) and verifies
the checksum; the AMBE voice frames beyond the voice sync are the
vendored-MBE boundary.

Vectorized notes: the scrambler is GENERATED from its LFSR
(x^7 + x^4 + 1, seed 0b0000111 — derived by matching the published
sequence, not copied as a table); the (2,1,3) rate-1/2 FEC (g1 = 111b,
g2 = 101b) reuses the vectorized lax.scan Viterbi in ops/fec.py — the
header's 330 coded pairs are exactly 328 data bits + the K−1 zero
flush.  D-STAR is binary GMSK: the "dibit" stream contributes its SIGN
bit only.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

HEADER_BITS = 660


def scramble_sequence(n: int) -> np.ndarray:
    """D-STAR pseudo-random scrambler bits: LFSR x^7+x^4+1, seed
    0b0000111 (output = MSB)."""
    out = np.empty(n, np.uint8)
    st = 0b0000111
    for i in range(n):
        out[i] = (st >> 6) & 1
        fb = ((st >> 6) ^ (st >> 3)) & 1
        st = ((st << 1) | fb) & 0x7F
    return out


def deinterleave_indices() -> np.ndarray:
    """660-bit header interleaver (stride-24 block walk with the 672/660
    tail wraps, dsd_dstar.cpp:deinterleave)."""
    idx = np.empty(HEADER_BITS, np.int64)
    k = 0
    for i in range(HEADER_BITS):
        idx[i] = k
        k += 24
        if k >= 672:
            k -= 671
        elif k >= 660:
            k -= 647
    return idx


_DEINT: Optional[np.ndarray] = None


def crc16_dstar(data: bytes) -> int:
    """AX.25-style FCS (reflected CCITT: poly 0x8408, init/xorout
    0xFFFF, little-endian transmit)."""
    reg = 0xFFFF
    for byte in data:
        reg ^= byte
        for _ in range(8):
            if reg & 1:
                reg = (reg >> 1) ^ 0x8408
            else:
                reg >>= 1
    return reg ^ 0xFFFF


def encode_header(flags: bytes, rpt2: str, rpt1: str, ur: str, my: str,
                  suffix: str) -> np.ndarray:
    """Build the 660 on-air header bits (test/TX oracle — exact inverse
    of decode_header)."""
    from ..ops.fec import conv_encode
    body = (bytes(flags[:3].ljust(3, b"\x00"))
            + rpt2.ljust(8)[:8].encode()
            + rpt1.ljust(8)[:8].encode()
            + ur.ljust(8)[:8].encode()
            + my.ljust(8)[:8].encode()
            + suffix.ljust(4)[:4].encode())
    crc = crc16_dstar(body)
    octets = body + bytes([crc & 0xFF, (crc >> 8) & 0xFF])
    assert len(octets) == 41
    bits = np.unpackbits(np.frombuffer(octets, np.uint8),
                         bitorder="little")          # LSB-first
    coded = conv_encode(bits[:328], g1=0b111, g2=0b101, k=3)
    assert len(coded) == HEADER_BITS
    global _DEINT
    if _DEINT is None:
        _DEINT = deinterleave_indices()
    # interleave = inverse of the receive-side scatter out[idx[i]]=rx[i]
    inter = coded[_DEINT]
    return inter ^ scramble_sequence(HEADER_BITS)


def decode_header(bits660: np.ndarray) -> Optional[dict]:
    """660 received header bits → fields dict, or None on FCS failure."""
    from ..ops.fec import viterbi_decode
    global _DEINT
    if _DEINT is None:
        _DEINT = deinterleave_indices()
    b = np.asarray(bits660, np.uint8) ^ scramble_sequence(HEADER_BITS)
    deint = np.empty(HEADER_BITS, np.uint8)
    deint[_DEINT] = b                  # out[idx[i]] = rx[i]
    data = np.asarray(viterbi_decode(deint.astype(np.float32),
                                     g1=0b111, g2=0b101, k=3))
    octets = np.packbits(data[:328].astype(np.uint8),
                         bitorder="little").tobytes()
    body, fcs = octets[:39], octets[39:41]
    got = fcs[0] | (fcs[1] << 8)
    ok = crc16_dstar(body) == got

    def cs(lo, hi):
        return body[lo:hi].decode("ascii", errors="replace").rstrip()

    return {
        "flags": list(body[:3]),
        "rpt2": cs(3, 11), "rpt1": cs(11, 19),
        "ur": cs(19, 27), "my": cs(27, 35), "suffix": cs(35, 39),
        "crc_ok": bool(ok),
    }


class DStarProcessor:
    """Streaming D-STAR product tracker: header decodes (callsigns) +
    voice-sync counting (AMBE payload out of scope)."""

    def __init__(self):
        self.headers: List[dict] = []
        self.header_crc_ok = 0
        self.header_crc_bad = 0
        self.voice_syncs = 0

    def process_header(self, sign_bits660: np.ndarray):
        h = decode_header(sign_bits660)
        if h is None:
            return None
        if h["crc_ok"]:
            self.header_crc_ok += 1
            self.headers.append(h)
        else:
            self.header_crc_bad += 1
        return h

    def summary(self) -> dict:
        return {"headerCrcOk": self.header_crc_ok,
                "headerCrcBad": self.header_crc_bad,
                "voiceSyncs": self.voice_syncs,
                "lastHeader": self.headers[-1] if self.headers else None}
