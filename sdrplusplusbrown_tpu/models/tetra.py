"""TETRA downlink burst + lower-MAC decode (BSCH / AACH).

reference: decoder_modules/ch_tetra_demodulator (osmo-tetra derived) —
this build's π/4-DQPSK front end (ops/demod_digital.py) recovers the
18 ksym/s dibit stream; this module carries the decode one level
deeper: burst synchronization on the ETSI training sequences, then the
BSCH chain (descramble → block de-interleave → RCPC de-puncture →
rate-1/4 K=5 Viterbi → CRC-16) to the SYNC PDU fields (colour code,
timeslot/frame/multiframe numbers, MCC/MNC), and the AACH broadcast
block via (30,14) Reed-Muller ML decode using the cell scrambling code
learned from the BSCH.

All numeric constants are protocol DATA from ETSI EN 300 392-2
(clauses cited inline): training sequences 9.4.4.3, burst layouts
9.4.4.2, scrambling 8.2.5, interleaving 8.2.4.1, RCPC puncturing
8.2.3.1, RM(30,14) generator 8.2.3.2, CRC 8.2.3.3.  The decoder design
(vectorized correlation sync, numpy Viterbi, ML table decode for the
Reed-Muller code) is original.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# ---------------------------------------------------------------------
# ETSI EN 300 392-2 protocol constants

#: 9.4.4.3.4 synchronization training sequence y1..y38
Y_BITS = np.array([1, 1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1,
                   1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1,
                   1, 1], np.int8)
#: 9.4.4.3.2 normal training sequence 1 (n1..n22)
N_BITS = np.array([1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1,
                   0, 1, 0, 0], np.int8)
#: 9.4.4.3.2 normal training sequence 2 (p1..p22)
P_BITS = np.array([0, 1, 1, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1,
                   1, 1, 1, 0], np.int8)

BURST_BITS = 510                       # 255 symbols per timeslot

# 9.4.4.2.7 synchronization continuous downlink burst (bit offsets)
SB_BLK1_OFF, SB_BLK1_LEN = (6 + 1 + 40) * 2, 120
SB_SYNC_TRAIN_OFF = SB_BLK1_OFF + SB_BLK1_LEN          # y1..y38
SB_BBK_OFF, SB_BBK_LEN = (6 + 1 + 40 + 60 + 19) * 2, 30
SB_BLK2_OFF, SB_BLK2_LEN = (6 + 1 + 40 + 60 + 19 + 15) * 2, 216

# 9.4.4.2.5/6 normal continuous downlink burst
NDB_BLK1_OFF = (5 + 1 + 1) * 2
NDB_BBK1_OFF, NDB_BBK1_LEN = (5 + 1 + 1 + 108) * 2, 14
NDB_TRAIN_OFF = NDB_BBK1_OFF + NDB_BBK1_LEN            # n/p 22 bits
NDB_BBK2_OFF, NDB_BBK2_LEN = (5 + 1 + 1 + 108 + 7 + 11) * 2, 16
NDB_BLK2_OFF = (5 + 1 + 1 + 108 + 7 + 11 + 8) * 2
NDB_BLK_LEN = 216

SCRAMB_INIT = 3                        # 8.2.5.2: lower 2 bits '11'

#: 8.2.3.2 (30,14) shortened Reed-Muller generator (parity part)
_RM_GEN = np.array([
    [1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 0, 0],
    [0, 0, 1, 0, 1, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    [1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0],
    [1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0],
    [0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1, 0],
    [0, 0, 1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1],
    [0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1],
    [0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 0, 1, 1, 0, 1],
    [0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1],
    [0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1],
    [0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1]], np.uint8)

#: rate-1/4 K=5 mother code generators (8.2.3.1.1), taps on
#: [input, D, D², D³, D⁴]
_CONV_TAPS = np.array([
    [1, 1, 0, 0, 1],     # g1 = b + d0 + d3
    [1, 0, 1, 1, 1],     # g2 = b + d1 + d2 + d3
    [1, 1, 1, 0, 1],     # g3 = b + d0 + d1 + d3
    [1, 1, 0, 1, 1]], np.uint8)   # g4 = b + d0 + d2 + d3

#: 8.2.3.1.3 rate-2/3 puncturing: P[1..3], t=3, period 8
_P23 = (1, 2, 5)


# ---------------------------------------------------------------------
# primitive stages (numpy; the BSCH runs once per multiframe — host
# cost is nil next to the jitted symbol demod)

def scramble_sequence(init: int, n: int) -> np.ndarray:
    """8.2.5 scrambling bits: 32-bit Fibonacci LFSR, taps
    {32,26,23,22,16,12,11,10,8,7,5,4,2,1} (counted from the MSB)."""
    taps = (32, 26, 23, 22, 16, 12, 11, 10, 8, 7, 5, 4, 2, 1)
    lfsr = int(init) & 0xFFFFFFFF
    out = np.empty(n, np.uint8)
    for i in range(n):
        bit = 0
        for t in taps:
            bit ^= (lfsr >> (32 - t)) & 1
        lfsr = ((lfsr >> 1) | (bit << 31)) & 0xFFFFFFFF
        out[i] = bit
    return out


def cell_scramb_init(mcc: int, mnc: int, colour: int) -> int:
    return (((colour & 0x3F) | ((mnc & 0x3FFF) << 6)
             | ((mcc & 0x3FF) << 20)) << 2) | SCRAMB_INIT


def block_deinterleave(bits: np.ndarray, a: int) -> np.ndarray:
    """8.2.4.1: interleaving k = 1 + (a·i mod K); inverse gather."""
    K = len(bits)
    i = np.arange(1, K + 1)
    k = 1 + (a * i) % K
    out = np.empty(K, bits.dtype)
    out[i - 1] = bits[k - 1]
    return out


def depuncture_23(bits: np.ndarray, n_type2: int):
    """8.2.3.1.2/3 rate-2/3 de-puncture into the rate-1/4 mother stream.
    Returns (soft values in {-1, +1, 0=erasure} as float, length
    4·n_type2)."""
    mother = np.zeros(4 * n_type2, np.float32)
    j = np.arange(1, len(bits) + 1)
    i = j
    blk = (i - 1) // 3
    k = 8 * blk + np.array(_P23)[(i - 3 * blk) - 1]
    mother[k - 1] = 2.0 * bits.astype(np.float32) - 1.0
    return mother


def viterbi_k5_r14(soft_mother: np.ndarray) -> np.ndarray:
    """Rate-1/4 K=5 Viterbi over ±1 soft bits (0 = erasure).  Input
    length 4·N; returns N decoded bits (the encoder is zero-flushed by
    the 4 tail bits included in N)."""
    N = len(soft_mother) // 4
    obs = soft_mother.reshape(N, 4)
    n_states = 16
    # expected outputs for (state, input): state = [d0 d1 d2 d3] packed
    st = np.arange(n_states)
    d = np.stack([(st >> k) & 1 for k in range(4)], axis=1)   # [S, 4]
    exp = np.empty((n_states, 2, 4), np.float32)
    nxt = np.empty((n_states, 2), np.int64)
    for b in (0, 1):
        vec = np.concatenate([np.full((n_states, 1), b), d], axis=1)
        exp[:, b, :] = (vec @ _CONV_TAPS.T % 2) * 2.0 - 1.0
        # shift register: d0' = b, d_k' = d_{k-1} (state bit k = D^{k+1})
        nxt[:, b] = ((st << 1) & 0xF) | b
    big = 1e9
    metrics = np.full(n_states, big, np.float32)
    metrics[0] = 0.0
    back = np.empty((N, n_states), np.int64)
    for t in range(N):
        # branch metric: negative correlation (erasures contribute 0)
        bm = -(exp @ obs[t])                                 # [S, 2]
        cand = metrics[:, None] + bm
        new = np.full(n_states, big, np.float32)
        arg = np.zeros(n_states, np.int64)
        flat_to = nxt.reshape(-1)
        flat_cand = cand.reshape(-1)
        order = np.argsort(flat_cand, kind="stable")[::-1]
        # scatter-min: iterate ascending so the best lands last
        for idx in order:
            s2 = flat_to[idx]
            if flat_cand[idx] <= new[s2]:
                new[s2] = flat_cand[idx]
                arg[s2] = idx
        back[t] = arg
        metrics = new
    s = int(np.argmin(metrics))
    bits = np.empty(N, np.uint8)
    for t in range(N - 1, -1, -1):
        idx = back[t, s]
        s_prev, b = idx // 2, idx % 2
        bits[t] = b
        s = s_prev
    return bits


def crc16_itut(bits: np.ndarray, init: int = 0xFFFF) -> int:
    crc = init
    for b in bits:
        crc ^= int(b) << 15
        crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 \
            else (crc << 1) & 0xFFFF
    return crc


TETRA_CRC_OK = 0x1D0F                  # remainder over data+crc


# RM(30,14): codeword = [14 data bits | 16 parity], ML decode by
# nearest codeword over all 2^14 (one vectorized matmul)
_RM_DATA = ((np.arange(1 << 14)[:, None] >> np.arange(13, -1, -1)) & 1
            ).astype(np.uint8)
_RM_CODE = np.concatenate([_RM_DATA, _RM_DATA @ _RM_GEN % 2], axis=1)


def rm3014_decode(bits30: np.ndarray):
    """ML decode: returns (data14 bits, hamming distance)."""
    d = np.count_nonzero(_RM_CODE != bits30[None, :], axis=1)
    best = int(np.argmin(d))
    return _RM_DATA[best], int(d[best])


# ---------------------------------------------------------------------
# burst sync + decode

def dibits_to_bits(dibits: np.ndarray) -> np.ndarray:
    """π/4-DQPSK dibit (ops/demod_digital.py convention: gray index of
    the ±π/4/±3π/4 grid) → TETRA bit pair (table 9.4.1: +π/4→00,
    +3π/4→01, −π/4→10, −3π/4→11)."""
    # demod dibit k encodes phase (2k+1)·π/4 wrapped: 0→+π/4, 1→+3π/4,
    # 2→−3π/4, 3→−π/4
    pair = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.int8)
    return pair[dibits].reshape(-1)


class SyncInfo:
    __slots__ = ("colour", "tn", "fn", "mn", "mcc", "mnc", "offset")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}


def find_sync_bursts(bits: np.ndarray) -> List[int]:
    """Offsets (bit index of burst start) where the 38-bit sync
    training sequence matches exactly at its in-burst position."""
    n = len(bits)
    y = Y_BITS
    hits = []
    if n < 38:
        return hits
    # correlate: positions p where bits[p:p+38] == y
    win = np.lib.stride_tricks.sliding_window_view(bits, 38)
    eq = (win == y[None, :]).all(axis=1)
    for p in np.flatnonzero(eq):
        start = p - SB_SYNC_TRAIN_OFF
        if 0 <= start <= n - BURST_BITS:
            hits.append(int(start))
    return hits


def decode_bsch(burst_bits: np.ndarray) -> Optional[SyncInfo]:
    """SB block 1 (120 type-5 bits) → SYNC PDU fields, or None when
    the CRC fails."""
    t5 = burst_bits[SB_BLK1_OFF:SB_BLK1_OFF + SB_BLK1_LEN].copy()
    t4 = t5 ^ scramble_sequence(SCRAMB_INIT, SB_BLK1_LEN)
    t3 = block_deinterleave(t4, a=11)
    mother = depuncture_23(t3, n_type2=80)
    t2 = viterbi_k5_r14(mother)
    if crc16_itut(t2[:76]) != TETRA_CRC_OK:
        return None

    def u(off, n):
        v = 0
        for b in t2[off:off + n]:
            v = (v << 1) | int(b)
        return v

    # SYNC PDU field layout (EN 300 392-2 table 21.4.4.1; offsets as in
    # the reference lower MAC, tetra_lower_mac.c:258-266)
    return SyncInfo(colour=u(4, 6), tn=u(10, 2) + 1, fn=u(12, 5),
                    mn=u(17, 6), mcc=u(31, 10), mnc=u(41, 14))


def decode_aach(burst_bits: np.ndarray, scramb_init: int,
                is_sb: bool = True):
    """Broadcast block (AACH): 30 bits → RM(30,14) ML decode.
    Returns (header, field1, field2, hamming_distance)."""
    if is_sb:
        t5 = burst_bits[SB_BBK_OFF:SB_BBK_OFF + SB_BBK_LEN].copy()
    else:
        t5 = np.concatenate([
            burst_bits[NDB_BBK1_OFF:NDB_BBK1_OFF + NDB_BBK1_LEN],
            burst_bits[NDB_BBK2_OFF:NDB_BBK2_OFF + NDB_BBK2_LEN]])
    t4 = t5 ^ scramble_sequence(scramb_init, 30)
    data, dist = rm3014_decode(t4)

    def u(off, n):
        v = 0
        for b in data[off:off + n]:
            v = (v << 1) | int(b)
        return v

    return u(0, 2), u(2, 6), u(8, 6), dist


def find_normal_bursts(bits: np.ndarray) -> List[tuple]:
    """Offsets of normal continuous downlink bursts: the 22-bit normal
    training sequence (n: both halves one logical channel, p: two
    half-slot channels — 9.4.4.3.2) matched exactly at its in-burst
    position.  Returns (start, kind) with kind 1 (n) or 2 (p)."""
    n = len(bits)
    hits = []
    if n < 22:
        return hits
    win = np.lib.stride_tricks.sliding_window_view(bits, 22)
    for kind, seq in ((1, N_BITS), (2, P_BITS)):
        eq = (win == seq[None, :]).all(axis=1)
        for p in np.flatnonzero(eq):
            start = p - NDB_TRAIN_OFF
            if 0 <= start <= n - BURST_BITS:
                hits.append((int(start), kind))
    return sorted(hits)


def decode_sch_hd(burst_bits: np.ndarray, scramb_init: int,
                  blk: int) -> Optional[np.ndarray]:
    """NDB block ``blk`` (1/2; 216 type-5 bits) through the SCH/HD
    chain: descramble (cell code) → (216,101) de-interleave →
    rate-2/3 de-puncture → rate-1/4 K=5 Viterbi → CRC-16.  Returns the
    124 type-1 bits or None (8.2: K=216 → a=101, type-2 = 144)."""
    off = NDB_BLK1_OFF if blk == 1 else NDB_BLK2_OFF
    t5 = burst_bits[off:off + NDB_BLK_LEN].copy()
    t4 = t5 ^ scramble_sequence(scramb_init, NDB_BLK_LEN)
    t3 = block_deinterleave(t4, a=101)
    mother = depuncture_23(t3, n_type2=144)
    t2 = viterbi_k5_r14(mother)
    if crc16_itut(t2[:140]) != TETRA_CRC_OK:
        return None
    return t2[:124]


def decode_sch_f(burst_bits: np.ndarray,
                 scramb_init: int) -> Optional[np.ndarray]:
    """SCH/F (full-slot signalling): both NDB halves form ONE 432-bit
    type-5 block (the 'n' training sequence marks it, 9.4.4.3.2):
    descramble → (432,103) de-interleave → rate-2/3 de-puncture →
    rate-1/4 K=5 Viterbi → CRC-16.  Returns the 268 type-1 bits or
    None (8.2: K=432 → a=103, type-2 = 288)."""
    t5 = np.concatenate([
        burst_bits[NDB_BLK1_OFF:NDB_BLK1_OFF + NDB_BLK_LEN],
        burst_bits[NDB_BLK2_OFF:NDB_BLK2_OFF + NDB_BLK_LEN]])
    t4 = t5 ^ scramble_sequence(scramb_init, 2 * NDB_BLK_LEN)
    t3 = block_deinterleave(t4, a=103)
    mother = depuncture_23(t3, n_type2=288)
    t2 = viterbi_k5_r14(mother)
    if crc16_itut(t2[:284]) != TETRA_CRC_OK:
        return None
    return t2[:268]


def _u(bits, off, n):
    v = 0
    for b in bits[off:off + n]:
        v = (v << 1) | int(b)
    return v


def parse_mac_pdu(t1: np.ndarray) -> dict:
    """Upper-MAC parse of a downlink SCH/HD type-1 block (EN 300 392-2
    §21.4; field layouts as in the reference's vendored osmo-tetra
    macpdu.h): MAC-RESOURCE header, or the SYSINFO broadcast PDU with
    its MLE cell info (main carrier, LA, subscriber class, BS service
    details)."""
    pdu_type = _u(t1, 0, 2)
    out = {"pduType": pdu_type}
    if pdu_type == 0:                       # MAC-RESOURCE (21.4.3.1)
        out["name"] = "MAC-RESOURCE"
        out["fillBits"] = _u(t1, 2, 1)
        out["posOfGrant"] = _u(t1, 3, 1)
        out["encryptionMode"] = _u(t1, 4, 2)
        out["randomAccessFlag"] = _u(t1, 6, 1)
        out["lengthIndication"] = _u(t1, 7, 6)
        out["addressType"] = _u(t1, 13, 3)
        if out["addressType"] in (1, 2, 3):  # SSI-based addresses
            out["ssi"] = _u(t1, 16, 24)
        # TM-SDU start: address element then the power-control /
        # slot-granting / channel-allocation flagged elements
        # (21.4.3.1; reference macpdu.h mac_resource layout)
        addr_len = {0: 0, 1: 24, 2: 10, 3: 24, 4: 24,
                    5: 34, 6: 30, 7: 34}[out["addressType"]]
        p = 16 + addr_len
        if out["addressType"] != 0 and p + 3 <= len(t1):
            if _u(t1, p, 1):                 # power control element
                p += 5
            else:
                p += 1
            if _u(t1, p, 1):                 # slot granting element
                p += 9
            else:
                p += 1
            ca = _u(t1, p, 1)
            p += 1
            out["chanAllocPresent"] = ca
            # channel-allocation element is variable-length; the SDU
            # offset is only trustworthy without one
            if not ca:
                out["sdu"] = t1[p:]
        # 0b111111 = start of fragmentation, 0b111110 = second half
        # slot stolen (21.4.3.1 length-indication reserved values)
        out["startFrag"] = out["lengthIndication"] == 63
    elif pdu_type == 2:                     # MAC broadcast (21.4.4)
        btype = _u(t1, 2, 2)
        out["broadcastType"] = btype
        if btype == 0:                      # SYSINFO (21.4.4.1)
            out["name"] = "SYSINFO"
            out["mainCarrier"] = _u(t1, 4, 12)
            out["freqBand"] = _u(t1, 16, 4)
            out["freqOffset"] = _u(t1, 20, 2)
            out["duplexSpacing"] = _u(t1, 22, 3)
            out["reverseOperation"] = _u(t1, 25, 1)
            out["numCommonSCCH"] = _u(t1, 26, 2)
            out["msTxpwrMaxCell"] = _u(t1, 28, 3)
            out["rxlevAccessMin"] = _u(t1, 31, 4)
            out["accessParameter"] = _u(t1, 35, 4)
            out["radioDownlinkTimeout"] = _u(t1, 39, 4)
            out["hyperframeCipherFlag"] = _u(t1, 43, 1)
            out["hyperframeOrCck"] = _u(t1, 44, 16)
            out["optionalField"] = _u(t1, 60, 2)
            out["tsCommonFrames"] = _u(t1, 62, 20)
            # MLE SYSINFO trailer (18.4.2.2): LA + subscriber class +
            # BS service details
            out["locationArea"] = _u(t1, 82, 14)
            out["subscriberClass"] = _u(t1, 96, 16)
            out["bsServiceDetails"] = _u(t1, 112, 12)
        elif btype == 1:
            out["name"] = "ACCESS-DEFINE"
    elif pdu_type == 1:                     # MAC-FRAG / MAC-END
        if _u(t1, 2, 1) == 0:               # MAC-FRAG (21.4.3.2)
            out["name"] = "MAC-FRAG"
            out["fillBits"] = _u(t1, 3, 1)
            out["sdu"] = t1[4:]
        else:                               # MAC-END (21.4.3.3)
            out["name"] = "MAC-END"
            out["fillBits"] = _u(t1, 3, 1)
            out["posOfGrant"] = _u(t1, 4, 1)
            li = _u(t1, 5, 6)
            out["lengthIndication"] = li
            p = 11
            if _u(t1, p, 1):                 # slot granting element
                p += 9
            else:
                p += 1
            if _u(t1, p, 1):                 # channel allocation
                out["chanAllocPresent"] = 1
                p += 1
                out["sdu"] = None            # length untrustworthy
            else:
                p += 1
                # length indication counts OCTETS of remaining SDU
                # (calibrated on the golden capture: two independent
                # fragmentations of the same broadcast reassemble to
                # equal 513-bit TM-SDUs only with 8-bit units)
                out["sdu"] = t1[p:p + 8 * li]
    else:
        out["name"] = "MAC-SUPPL" if pdu_type == 3 else f"MAC-{pdu_type}"
    return out


# -- LLC / MLE / CMCE parse of a reassembled TM-SDU -------------------------

MLE_PDISC = {1: "MM", 2: "CMCE", 4: "SNDCP", 5: "MLE", 6: "MGMT",
             7: "TEST"}
#: downlink CMCE PDU types (EN 300 392-2 §14.8; reference
#: tetra_cmce_pdu.h) — D-SDS-DATA = 0x0F
CMCE_PDU_NAMES = {1: "D-ALERT", 3: "D-CALL-PROCEEDING", 5: "D-CONNECT",
                  7: "D-DISCONNECT", 8: "D-INFO", 9: "D-RELEASE",
                  14: "D-STATUS", 15: "D-SDS-DATA", 16: "D-SETUP"}
MLE_PDU_NAMES = {0: "D-NEW-CELL", 1: "D-PREPARE-FAIL",
                 2: "D-NWRK-BROADCAST", 3: "D-NWRK-BROADCAST-EXT",
                 4: "D-RESTORE-ACK", 5: "D-RESTORE-FAIL"}


def parse_tm_sdu(bits: np.ndarray) -> dict:
    """LLC → MLE → (CMCE) parse of a reassembled TM-SDU (EN 300 392-2
    §21 LLC / §18 MLE / §14 CMCE; enums as in the reference's vendored
    osmo-tetra tetra_llc_pdu.h / tetra_mle_pdu.h / tetra_cmce_pdu.h)."""
    out = {"bits": len(bits)}
    llc_type = _u(bits, 0, 4)
    out["llcType"] = llc_type
    p = 4
    if llc_type == 0:                       # BL-ADATA: N(R) + N(S)
        out["llc"] = "BL-ADATA"
        p += 2
    elif llc_type == 1:                     # BL-DATA: N(S)
        out["llc"] = "BL-DATA"
        p += 1
    elif llc_type == 2:
        out["llc"] = "BL-UDATA"
    elif llc_type == 3:                     # BL-ACK: N(R)
        out["llc"] = "BL-ACK"
        p += 1
    else:
        out["llc"] = f"LLC-{llc_type}"
        return out
    pdisc = _u(bits, p, 3)
    out["mlePdisc"] = MLE_PDISC.get(pdisc, str(pdisc))
    p += 3
    if pdisc == 5:                          # MLE protocol
        mtype = _u(bits, p, 3)
        out["mlePdu"] = MLE_PDU_NAMES.get(mtype, f"MLE-{mtype}")
        p += 3
        if mtype == 2:                      # D-NWRK-BROADCAST (18.4.1.4.1)
            out["cellReselectParams"] = _u(bits, p, 16)
    elif pdisc == 2:                        # CMCE (14.8)
        ctype = _u(bits, p, 5)
        out["cmcePdu"] = CMCE_PDU_NAMES.get(ctype, f"CMCE-{ctype}")
        p += 5
        if ctype == 15:                     # D-SDS-DATA (14.7.1.10)
            cpti = _u(bits, p, 2)
            out["callingPartyType"] = cpti
            p += 2
            if cpti == 1:                   # SSI
                out["callingSsi"] = _u(bits, p, 24)
                p += 24
            elif cpti == 2:                 # SSI + extension
                out["callingSsi"] = _u(bits, p, 24)
                p += 48
            sdti = _u(bits, p, 2)
            p += 2
            out["shortDataType"] = sdti
            if sdti < 3:                    # user-defined data 1/2/3
                n = (16, 32, 64)[sdti]
            else:                           # length indicator + TL data
                n = _u(bits, p, 11)
                p += 11
            n = min(n, len(bits) - p)
            out["userDataBits"] = n
            data = bits[p:p + n]
            out["userData"] = "".join(
                f"{_u(data, i, min(8, n - i)):02x}"
                for i in range(0, n, 8))
    return out


class TmSduReassembler:
    """Downlink MAC fragment reassembly, one pending buffer per
    timeslot (fragments continue in the SAME timeslot of following
    frames, 23.4.2; the reference's vendored osmo-tetra keeps the
    analogous per-slot fragslots).  Feed MAC PDUs in stream order with
    their absolute bit offsets; completed TM-SDUs are parsed through
    LLC/MLE/CMCE."""

    def __init__(self):
        self._pending = {}                  # slot -> list of bit arrays
        self.completed: List[dict] = []

    def feed(self, bit_offset: int, pdu: dict):
        slot = (bit_offset // BURST_BITS) % 4
        name = pdu.get("name")
        sdu = pdu.get("sdu")
        if name == "MAC-RESOURCE" and pdu.get("startFrag"):
            if sdu is not None:
                self._pending[slot] = [sdu]
            return
        if slot not in self._pending:
            return
        if name == "MAC-FRAG" and sdu is not None:
            self._pending[slot].append(sdu)
            return
        if name == "MAC-END":
            frags = self._pending.pop(slot)
            if sdu is None:
                return
            frags.append(sdu)
            tm = np.concatenate(frags)
            parsed = parse_tm_sdu(tm)
            parsed["offset"] = bit_offset
            parsed["fragments"] = len(frags)
            parsed["tmSdu"] = tm
            self.completed.append(parsed)


class TetraDownlinkDecoder:
    """Dibit stream → synchronized bursts → BSCH/AACH decodes.

    Feed ``push(dibits)``; ``sync_infos`` collects CRC-clean SYNC PDUs,
    ``aach`` the access-assign fields of every synchronized burst."""

    def __init__(self):
        self._bits = np.zeros(0, np.int8)
        self._abs = 0                 # absolute index of _bits[0]
        self._done = -1               # absolute offset last processed
        self._done_ndb = -1
        self.sync_infos: List[SyncInfo] = []
        self.aach: List[tuple] = []
        self.cell_init: Optional[int] = None
        self.bursts_seen = 0
        # upper MAC (normal downlink bursts)
        self.ndb_seen = 0
        self.sch_hd_decodes = 0
        self.sch_f_decodes = 0
        self.sysinfo: List[dict] = []
        self.mac_resource: List[dict] = []
        self.mac_pdu_counts: dict = {}
        self.reassembler = TmSduReassembler()

    def push(self, dibits: np.ndarray):
        bits = dibits_to_bits(np.asarray(dibits))
        self._bits = np.concatenate([self._bits, bits.astype(np.int8)])
        for s in find_sync_bursts(self._bits):
            if self._abs + s <= self._done:
                continue              # already decoded this burst
            self._done = self._abs + s
            burst = self._bits[s:s + BURST_BITS].astype(np.uint8)
            self.bursts_seen += 1
            info = decode_bsch(burst)
            if info is not None:
                info.offset = self._abs + s
                self.sync_infos.append(info)
                self.cell_init = cell_scramb_init(info.mcc, info.mnc,
                                                  info.colour)
            if self.cell_init is not None:
                self.aach.append(decode_aach(burst, self.cell_init,
                                             is_sb=True))
        # upper MAC: normal downlink bursts, decodable once the cell
        # scrambling is learned from a BSCH
        if self.cell_init is not None:
            for s, kind in find_normal_bursts(self._bits):
                if self._abs + s <= self._done_ndb:
                    continue
                self._done_ndb = self._abs + s
                burst = self._bits[s:s + BURST_BITS].astype(np.uint8)
                self.ndb_seen += 1
                self.aach.append(decode_aach(burst, self.cell_init,
                                             is_sb=False))
                # kind 1 ('n' training): ONE full-slot channel — try
                # SCH/F; kind 2 ('p'): two half-slot SCH/HD blocks
                if kind == 1:
                    t1 = decode_sch_f(burst, self.cell_init)
                    decs = [(0, t1)] if t1 is not None else []
                    self.sch_f_decodes += len(decs)
                else:
                    decs = []
                    for blk in (1, 2):
                        t1 = decode_sch_hd(burst, self.cell_init, blk)
                        if t1 is not None:
                            decs.append((blk, t1))
                            self.sch_hd_decodes += 1
                for blk, t1 in decs:
                    pdu = parse_mac_pdu(t1)
                    pdu["offset"] = self._abs + s
                    pdu["blk"] = blk
                    name = pdu.get("name", "?")
                    self.mac_pdu_counts[name] = \
                        self.mac_pdu_counts.get(name, 0) + 1
                    if name == "SYSINFO":
                        self.sysinfo.append(pdu)
                    elif name == "MAC-RESOURCE":
                        self.mac_resource.append(pdu)
                    self.reassembler.feed(self._abs + s, pdu)
        # keep a tail long enough for a burst straddling the boundary
        keep = min(len(self._bits), BURST_BITS + 64)
        self._abs += len(self._bits) - keep
        self._bits = self._bits[-keep:]
