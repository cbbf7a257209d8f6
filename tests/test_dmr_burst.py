"""DMR burst layer: FEC primitives, field codecs, superframe tracking,
the grown DSD sync family, and CTCSS/DCS detection.

reference behavior: dsd_dmr.cpp (burst processing past findFrameSync),
dsd.h:633-668 (sync family), ctcss.h / dcs.h (subaudible squelch).
The embedded-LC path is additionally validated on the golden capture in
test_golden_capture_embedded_lc (skips when recordings aren't mounted).
"""

import os

import numpy as np
import pytest

from sdrplusplusbrown_tpu.models import dmr_burst as dbm
from sdrplusplusbrown_tpu.models.dsd import DSDFrameSync, SYNC_PATTERNS
from sdrplusplusbrown_tpu.models.dmr_burst import (
    DMRBurstProcessor, OUR_TO_AIR, golay_20_8_encode, golay_20_8_decode,
    hamming_16_11_4_encode, hamming_16_11_4_correct, hamming_7_4_encode,
    hamming_7_4_decode, hamming_17_12_3_encode, hamming_17_12_3_correct,
    encode_embedded_lc, decode_embedded_lc, encode_short_lc,
    decode_short_lc, encode_cach, decode_cach, encode_slot_type,
    decode_slot_type)

AIR_TO_OUR = np.argsort(OUR_TO_AIR)     # inverse dibit translation

rng = np.random.default_rng(7)


# ---------------------------------------------------------------------------
# FEC primitives
# ---------------------------------------------------------------------------

def test_golay_20_8_distance_and_correction():
    # shortened extended-Golay construction: computed dmin must be >= 7
    # (3-error correction; measured 8)
    tab = dbm._golay_20_8_table().astype(np.int8)
    dists = []
    for i in range(256):
        d = np.count_nonzero(tab ^ tab[i], axis=1)
        d[i] = 99
        dists.append(d.min())
    assert min(dists) >= 7, min(dists)
    # corrects any <=3 bit errors
    for trial in range(50):
        v = rng.integers(0, 256)
        cw = tab[v].astype(np.uint8)
        err = rng.choice(20, size=rng.integers(0, 4), replace=False)
        rx = cw.copy()
        rx[err] ^= 1
        got, dist = golay_20_8_decode(rx)
        assert got == v and dist == len(err)


def test_hamming_16_11_4_correct_and_detect():
    d = rng.integers(0, 2, 11).astype(np.uint8)
    cw = hamming_16_11_4_encode(d)
    # single-bit errors corrected
    for e in range(16):
        rx = cw.copy()
        rx[e] ^= 1
        fixed, n = hamming_16_11_4_correct(rx)
        assert n == 1 and np.array_equal(fixed[:11], d)
    # double-bit errors detected (d=4), never miscorrected silently
    for _ in range(30):
        e = rng.choice(16, size=2, replace=False)
        rx = cw.copy()
        rx[e] ^= 1
        _, n = hamming_16_11_4_correct(rx)
        assert n == -1


def test_hamming_7_4_and_17_12():
    d = rng.integers(0, 2, 4).astype(np.uint8)
    cw = hamming_7_4_encode(d)
    for e in range(7):
        rx = cw.copy()
        rx[e] ^= 1
        v, dist = hamming_7_4_decode(rx)
        assert dist == 1
        assert v == int("".join(map(str, d)), 2)
    d = rng.integers(0, 2, 12).astype(np.uint8)
    cw = hamming_17_12_3_encode(d)
    for e in range(17):
        rx = cw.copy()
        rx[e] ^= 1
        fixed, n = hamming_17_12_3_correct(rx)
        assert n == 1 and np.array_equal(fixed[:12], d)


# ---------------------------------------------------------------------------
# Field codecs (loopback)
# ---------------------------------------------------------------------------

def test_embedded_lc_roundtrip():
    lc = np.array([0, 0, 8, 0xFF, 0xFF, 0xFF, 0x02, 0x4C, 0x3B],
                  np.uint8)
    raw = encode_embedded_lc(lc)
    out = decode_embedded_lc(raw)
    assert out is not None
    assert out["flco"] == 0 and out["flco_name"] == "Group Voice"
    assert out["dst"] == 0xFFFFFF and out["src"] == 0x024C3B
    # survives one bit error per Hamming row region
    rx = raw.copy()
    rx[5] ^= 1
    assert decode_embedded_lc(rx) is not None
    # a trashed stream must NOT validate
    assert decode_embedded_lc(rng.integers(0, 2, 128).astype(np.uint8)) \
        is None


def test_short_lc_roundtrip():
    raw = encode_short_lc(0x2, 0xABCDE1)
    out = decode_short_lc(raw)
    assert out == {"opcode": 0x2, "data": 0xABCDE1}
    rx = raw.copy()
    rx[3] ^= 1
    assert decode_short_lc(rx) == out
    assert decode_short_lc(rng.integers(0, 2, 68).astype(np.uint8)) \
        is None


def test_cach_and_slot_type_roundtrip():
    payload = rng.integers(0, 2, 17).astype(np.uint8)
    cach = decode_cach(encode_cach(1, 0, 2, payload))
    assert (cach["at"], cach["tc"], cach["lcss"]) == (1, 0, 2)
    assert cach["tact_errs"] == 0
    assert np.array_equal(cach["payload"], payload)
    st_bits = encode_slot_type(cc=9, data_type=3)
    st_bits[7] ^= 1          # one channel error
    st = decode_slot_type(st_bits)
    assert st["cc"] == 9 and st["data_type"] == 3
    assert st["type_name"] == "CSBK" and st["ok"]


# ---------------------------------------------------------------------------
# Synthetic burst streams through the processor
# ---------------------------------------------------------------------------

def _pattern_air(pat: str) -> np.ndarray:
    """sync pattern chars -> on-air dibits ('1'=+3 -> 01b, '3'=-3 -> 11b)."""
    return np.array([1 if c == "1" else 3 for c in pat], np.uint8)


def _sync_air(name: str) -> np.ndarray:
    pat = dict((n, p) for n, p, _ in SYNC_PATTERNS)[name]
    return _pattern_air(pat)


def _bits_to_air(bits: np.ndarray) -> np.ndarray:
    return (bits[0::2] << 1 | bits[1::2]).astype(np.uint8)


def test_voice_superframe_and_embedded_lc_through_processor():
    lc = np.array([0, 0, 0, 0, 0, 9, 0x00, 0x12, 0x34], np.uint8)
    frag128 = encode_embedded_lc(lc)
    stream = rng.integers(0, 4, 4000).astype(np.uint8)
    a_end = 500
    sync = _sync_air("DMR_BS_VOICE")
    stream[a_end - 23:a_end + 1] = sync
    lcss_seq = [1, 3, 3, 2, 0]
    for k in range(1, 6):
        emb_bits = np.zeros(16, np.uint8)
        cc = 7
        for i in range(4):
            emb_bits[i] = (cc >> (3 - i)) & 1
        emb_bits[5] = (lcss_seq[k - 1] >> 1) & 1
        emb_bits[6] = lcss_seq[k - 1] & 1
        frag = frag128[32 * (k - 1):32 * k] if k <= 4 \
            else np.zeros(32, np.uint8)
        cf = np.concatenate([emb_bits[:8], frag, emb_bits[8:]])
        e = a_end + 288 * k
        stream[e - 23:e + 1] = _bits_to_air(cf)
    bp = DMRBurstProcessor()
    ours = AIR_TO_OUR[stream]
    # feed in uneven chunks to exercise the deferred-window path
    for lo in range(0, len(ours), 777):
        bp.push(ours[lo:lo + 777])
    s = bp.summary()
    assert s["voiceSuperframes"] == 1, s
    assert s["lcDecodes"] == 1
    assert s["lastLC"]["src"] == 0x1234 and s["lastLC"]["dst"] == 9
    assert s["colorCode"] == 7
    assert s["burstTypes"]["VOICE"] == 6


def test_data_burst_slot_type_and_short_lc():
    slc_raw = encode_short_lc(0x1, 0x00AB12)
    stream = rng.integers(0, 4, 4000).astype(np.uint8)
    sync = _sync_air("DMR_BS_DATA")
    bp_ref = []
    for k in range(4):
        e = 300 + 288 * k
        st_bits = encode_slot_type(cc=11, data_type=3 if k % 2 else 9)
        cach = encode_cach(1, 0, [1, 3, 3, 2][k],
                           slc_raw[17 * k:17 * (k + 1)])
        stream[e - 89:e - 77] = _bits_to_air(cach)
        stream[e - 28:e - 23] = _bits_to_air(st_bits[:10])
        stream[e - 23:e + 1] = sync
        stream[e + 1:e + 6] = _bits_to_air(st_bits[10:])
        bp_ref.append(e)
    bp = DMRBurstProcessor()
    bp.push(AIR_TO_OUR[stream])
    s = bp.summary()
    assert s["counts"]["DMR_BS_DATA"] == 4
    assert s["burstTypes"].get("Idle", 0) == 2, s["burstTypes"]
    assert s["burstTypes"].get("CSBK", 0) == 2, s["burstTypes"]
    assert s["colorCode"] == 11
    assert s["shortLcDecodes"] == 1
    assert s["lastShortLC"] == {"opcode": 0x1, "data": 0x00AB12}


@pytest.mark.parametrize("name", [
    "NXDN_BS_VOICE", "DSTAR_SYNC", "X2TDMA_MS_DATA", "PROVOICE_EA"])
def test_extended_sync_family(name):
    stream = rng.integers(0, 4, 2000).astype(np.uint8)
    air = _sync_air(name)
    for e in (400, 1100):
        stream[e - len(air) + 1:e + 1] = air
    fs = DSDFrameSync()
    hits = fs.push(AIR_TO_OUR[stream])
    assert fs.counts[name] >= 2, (name, fs.counts)
    assert any(h[1] == name for h in hits)


# ---------------------------------------------------------------------------
# CTCSS / DCS
# ---------------------------------------------------------------------------

def test_ctcss_detects_injected_tone():
    from sdrplusplusbrown_tpu.ops.ctcss import CTCSSDetector
    sr = 16000.0
    t = np.arange(int(2.0 * sr)) / sr
    # 127.3 Hz subaudible tone at 15% deviation + voice-band noise
    audio = 0.15 * np.sin(2 * np.pi * 127.3 * t) \
        + 0.5 * np.sin(2 * np.pi * 1100.0 * t) \
        + 0.2 * rng.standard_normal(len(t))
    det = CTCSSDetector(sr)
    det.push(audio.astype(np.float32))
    assert det.detected == 127.3, det.summary()
    det2 = CTCSSDetector(sr)
    det2.push((0.5 * rng.standard_normal(len(t))).astype(np.float32))
    assert det2.detected is None, det2.summary()


@pytest.mark.parametrize("inverted", [False, True])
def test_dcs_detects_injected_code(inverted):
    from sdrplusplusbrown_tpu.ops.ctcss import (DCSDetector, dcs_codeword,
                                                DCS_BITRATE)
    sr = 16000.0
    code = 0o023
    w = dcs_codeword(code)
    bits = np.array([(w >> b) & 1 for b in range(23)], np.float64)
    if inverted:
        bits = 1.0 - bits
    nrz = 2.0 * bits - 1.0
    n = int(3.0 * sr)
    tt = np.arange(n) / sr
    phase = (tt * DCS_BITRATE).astype(np.int64) % 23
    audio = 0.2 * nrz[phase] + 0.05 * rng.standard_normal(n) \
        + 0.4 * np.sin(2 * np.pi * 1000.0 * tt)
    det = DCSDetector(sr)
    det.push(audio.astype(np.float32))
    if not inverted:
        assert det.detected == code, det.summary()
        assert det.inverted is False
    else:
        # DCS inversion aliasing: inverted 023 is bit-identical to a
        # rotation of normal 047, and like real DCS squelches the
        # detector prefers the normal-polarity reading
        assert det.detected in (code, 0o047), det.summary()


# ---------------------------------------------------------------------------
# Golden capture (skip when not mounted)
# ---------------------------------------------------------------------------

DMR_REC = "/root/reference/e2e/recordings/dmr_sample.wav"


@pytest.mark.skipif(not os.path.exists(DMR_REC),
                    reason="reference recordings not mounted")
def test_golden_capture_embedded_lc():
    """Full DSP chain on the golden capture: 13 voice superframes, >=8
    checksum-valid embedded LCs, and the capture's actual call
    (Group Voice, dst 16777215 all-call, src 150587, colour code 1)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sdrplusplusbrown_tpu.io.wav import read_wav_iq
    from sdrplusplusbrown_tpu.models.rx_vfo import RxVFO
    from sdrplusplusbrown_tpu.ops.demod_digital import FourFSKDemod
    from sdrplusplusbrown_tpu.runtime.pump import Rechunker
    iq, sr = read_wav_iq(DMR_REC)
    chan = RxVFO(sr, 16000.0, 12500.0, offset_hz=0.0)
    dem = FourFSKDemod(4800.0, 16000.0, 1944.0)
    cstep = jax.jit(lambda p, s, x: chan.apply(p, s, x))
    dstep = jax.jit(lambda s, x: dem.apply(None, s, x))
    cp, cs = chan.make_params(0.0), chan.init_state(())
    ds = dem.init_state(())
    g = int(chan.in_multiple)
    rc = Rechunker(((int(0.1 * sr) + g - 1) // g) * g)
    bp = DMRBurstProcessor()
    for chunk in rc.push(iq):
        y, cs = cstep(cp, cs, jnp.asarray(chunk))
        (soft, dibit, valid), ds = dstep(ds, y)
        db = np.asarray(dibit)[np.asarray(valid)]
        if db.size:
            bp.push(db)
    s = bp.summary()
    assert s["voiceSuperframes"] >= 10, s
    assert s["lcDecodes"] >= 8, s
    assert s["lastLC"]["flco_name"] == "Group Voice"
    assert s["lastLC"]["dst"] == 16777215
    assert s["lastLC"]["src"] == 150587
    assert s["colorCode"] == 1


# ---------------------------------------------------------------------------
# P25 NID layer (round-5; reference dsd_p25.cpp:6-175)
# ---------------------------------------------------------------------------

def test_bch_63_16_distance_and_ml_decode():
    from sdrplusplusbrown_tpu.models import p25 as p25m
    g = p25m.bch_63_16_generator()
    assert g.bit_length() - 1 == 47
    # spot-check dmin >= 23 on random codeword pairs + low-weight words
    t = p25m._table()
    base = int(t[0x1234])
    for v in (0x0001, 0x8000, 0x1235, 0xFFFF, 0x0E21):
        d = bin(base ^ int(t[v])).count("1")
        assert d >= 23, (hex(v), d)
    # ML decode corrects 11 errors
    info = 0x293F
    cw = int(t[info])
    bits = np.array([(cw >> (62 - i)) & 1 for i in range(63)], np.uint8)
    err = rng.choice(63, size=11, replace=False)
    bits[err] ^= 1
    got, dist = p25m.bch_63_16_decode(bits)
    assert got == info and dist == 11


def _p25_nid_dibits(nac, duid, flip_bits=()):
    """Sync + NID dibit stream (on-air), status dibit inserted."""
    from sdrplusplusbrown_tpu.models import p25 as p25m
    cw = p25m.bch_63_16_encode((nac << 4) | duid)
    bits = [(cw >> (62 - i)) & 1 for i in range(63)] + [0]   # + parity
    for fb in flip_bits:
        bits[fb] ^= 1
    d = []
    for k in range(11):
        d.append(bits[2 * k] * 2 + bits[2 * k + 1])
    d.append(1)                                   # status dibit
    for k in range(11, 31):
        d.append(bits[2 * k] * 2 + bits[2 * k + 1])
    d.append(bits[62] * 2 + bits[63])
    return np.array(d, np.uint8)


@pytest.mark.parametrize("inv", [False, True])
def test_p25_nid_through_processor(inv):
    nac, duid = 0x293, 0x5                        # LDU1 (dibits 1,1)
    nid = _p25_nid_dibits(nac, duid, flip_bits=(3, 40, 50))
    sync = _sync_air("P25P1")
    stream = rng.integers(0, 4, 1500).astype(np.uint8)
    for e in (300, 900):
        stream[e - 23:e + 1] = sync
        stream[e + 1:e + 1 + len(nid)] = nid
    if inv:
        stream = stream ^ 2                       # polarity inversion
    bp = DMRBurstProcessor()
    bp.push(AIR_TO_OUR[stream])
    s = bp.summary()
    key = "P25P1_INV" if inv else "P25P1"
    assert s["counts"][key] >= 2, s["counts"]
    p = s["p25"]
    assert p["nac"] == nac, p
    assert p["lastDuid"] == "LDU1", p
    assert p["duidCounts"]["LDU1"] >= 2, p
    assert p["nidOk"] >= 2 and p["nidErrors"] == 0, p


# ---------------------------------------------------------------------------
# D-STAR radio header (round-5; reference dsd_dstar.cpp)
# ---------------------------------------------------------------------------

def test_dstar_header_roundtrip_and_fec():
    from sdrplusplusbrown_tpu.models import dstar as dsm
    bits = dsm.encode_header(b"\x00\x00\x00", "REPEAT2", "REPEAT1",
                             "CQCQCQ", "N0CALL", "JAX")
    h = dsm.decode_header(bits)
    assert h["crc_ok"], h
    assert h["my"] == "N0CALL" and h["ur"] == "CQCQCQ"
    assert h["rpt1"] == "REPEAT1" and h["rpt2"] == "REPEAT2"
    assert h["suffix"] == "JAX"
    # the rate-1/2 K=3 FEC corrects scattered channel errors
    rx = bits.copy()
    rx[np.asarray([10, 200, 400, 600])] ^= 1
    h2 = dsm.decode_header(rx)
    assert h2["crc_ok"] and h2["my"] == "N0CALL"


@pytest.mark.parametrize("inv", [False, True])
def test_dstar_header_through_processor(inv):
    from sdrplusplusbrown_tpu.models import dstar as dsm
    bits = dsm.encode_header(b"\x00\x00\x00", "", "XLX999 B",
                             "CQCQCQ", "TP9UZT", "73")
    # sign bit -> air dibit: bit 1 = negative deviation (msb set)
    hdr_dibits = np.where(bits == 1, 3, 1).astype(np.uint8)
    sync = _sync_air("DSTAR_HD")
    stream = rng.integers(0, 4, 2000).astype(np.uint8)
    e = 500
    stream[e - 23:e + 1] = sync
    stream[e + 1:e + 1 + len(hdr_dibits)] = hdr_dibits
    vs = _sync_air("DSTAR_SYNC")
    stream[1500 - 23:1500 + 1] = vs
    if inv:
        stream = stream ^ 2
    bp = DMRBurstProcessor()
    for lo in range(0, len(stream), 613):
        bp.push(AIR_TO_OUR[stream[lo:lo + 613]])
    s = bp.summary()
    d = s["dstar"]
    assert d["headerCrcOk"] >= 1, d
    assert d["lastHeader"]["my"] == "TP9UZT", d
    assert d["lastHeader"]["rpt1"] == "XLX999 B", d
    assert d["voiceSyncs"] >= 1, d


def test_p25_rs_24_12_corrects_six_errors():
    from sdrplusplusbrown_tpu.models import p25 as p25m
    r = np.random.default_rng(11)
    for ne in (0, 3, 6):
        data = r.integers(0, 64, 12).astype(np.uint8)
        par = p25m.rs_24_12_encode(data)
        wd, wp = data.copy(), par.copy()
        pos = r.choice(24, size=ne, replace=False)
        for p in pos:
            e = r.integers(1, 64)
            if p < 12:
                wd[p] ^= e
            else:
                wp[p - 12] ^= e
        fixed, n = p25m.rs_24_12_decode(wd, wp)
        assert fixed is not None and np.array_equal(fixed, data), ne
        assert n == len(pos)


def test_p25_ldu1_link_control_through_processor():
    from sdrplusplusbrown_tpu.models import p25 as p25m
    r = np.random.default_rng(13)
    nac, duid = 0x1A5, 0x5              # LDU1
    nid = _p25_nid_dibits(nac, duid)
    lcinfo = np.zeros(56, np.uint8)
    tg, src = 4321, 778899
    for b in range(16):
        lcinfo[16 + b] = (tg >> (15 - b)) & 1
    for b in range(24):
        lcinfo[32 + b] = (src >> (23 - b)) & 1
    ldu = p25m.encode_ldu1(0x00, 0x00, lcinfo, r)
    sync = _sync_air("P25P1")
    frame = np.concatenate([sync, nid, ldu])
    stream = np.concatenate([r.integers(0, 4, 300).astype(np.uint8),
                             frame,
                             r.integers(0, 4, 300).astype(np.uint8)])
    bp = DMRBurstProcessor()
    for lo in range(0, len(stream), 401):
        bp.push(AIR_TO_OUR[stream[lo:lo + 401]])
    p = bp.summary()["p25"]
    assert p["duidCounts"].get("LDU1", 0) == 1, p
    assert p["lcDecodes"] == 1, p
    assert p["lastLC"]["talkgroup"] == tg, p
    assert p["lastLC"]["src"] == src, p
    assert p["lastLC"]["lcformat"] == 0, p


def test_p25_hdu_ldu2_tdulc_roundtrips():
    from sdrplusplusbrown_tpu.models import p25 as p25m
    r = np.random.default_rng(17)
    mi = r.integers(0, 2, 72).astype(np.uint8)
    h = p25m.parse_hdu(p25m.encode_hdu(mi, 0x00, 0x80, 0x1234, 999, r))
    assert h["algid"] == 0x80 and h["kid"] == 0x1234
    assert h["talkgroup"] == 999 and h["mi"] == "".join(map(str, mi))
    h = p25m.parse_ldu2(p25m.encode_ldu2(mi, 0xAA, 0xBEEF, r))
    assert h["algid"] == 0xAA and h["kid"] == 0xBEEF
    assert h["mi"] == "".join(map(str, mi))
    lcinfo = np.zeros(56, np.uint8)
    for b in range(16):
        lcinfo[16 + b] = (777 >> (15 - b)) & 1
    for b in range(24):
        lcinfo[32 + b] = (888999 >> (23 - b)) & 1
    d = p25m.encode_tdulc(0x00, 0x00, lcinfo, r)
    pos = r.choice(len(d), 10, replace=False)
    d[pos] ^= r.integers(1, 4, 10).astype(np.uint8)
    lc = p25m.parse_tdulc(d)
    assert lc["talkgroup"] == 777 and lc["src"] == 888999


def test_p25_hdu_through_processor():
    from sdrplusplusbrown_tpu.models import p25 as p25m
    r = np.random.default_rng(19)
    mi = r.integers(0, 2, 72).astype(np.uint8)
    nid = _p25_nid_dibits(0x293, 0x0)   # HDU
    hdu = p25m.encode_hdu(mi, 0x00, 0x84, 0x2222, 4242, r)
    sync = _sync_air("P25P1")
    stream = np.concatenate([r.integers(0, 4, 200).astype(np.uint8),
                             sync, nid, hdu,
                             r.integers(0, 4, 200).astype(np.uint8)])
    bp = DMRBurstProcessor()
    bp.push(AIR_TO_OUR[stream])
    p = bp.summary()["p25"]
    assert p["duidCounts"].get("HDU", 0) == 1, p
    assert p["hduDecodes"] == 1, p
    assert p["lastHDU"]["talkgroup"] == 4242, p
    assert p["lastHDU"]["algid"] == 0x84, p


def test_p25_trellis_and_crc_roundtrip():
    """1/2-rate trellis + CRC-CCITT TSBK loopback with bit errors."""
    from sdrplusplusbrown_tpu.models import p25 as p25m
    r = np.random.default_rng(17)
    bits = r.integers(0, 2, 96).astype(np.uint8)
    tx = p25m.trellis_1_2_encode(bits)
    got, dist = p25m.trellis_1_2_decode(tx)
    assert dist == 0 and np.array_equal(got, bits)
    # the 4-state code corrects scattered single-bit constellation hits
    for errs in ([5], [10, 120], [3, 77, 150]):
        noisy = tx.copy()
        for e in errs:
            noisy[e] ^= 1
        got, dist = p25m.trellis_1_2_decode(noisy)
        assert np.array_equal(got, bits), errs
    # CRC gates trellis-consistent payload corruption
    blk = p25m.encode_tsbk(0x3D, 0x00, r.integers(0, 2, 64), lb=True)
    good, _ = p25m.trellis_1_2_decode(blk)
    assert p25m.parse_tsbk(blk) is not None
    bad = good.copy()
    bad[20] ^= 1                          # payload flip, stale CRC
    assert p25m.parse_tsbk(p25m.trellis_1_2_encode(bad)) is None


def test_p25_tsbk_opcode_fields():
    from sdrplusplusbrown_tpu.models import p25 as p25m
    a = np.zeros(64, np.uint8)
    ch, grp, src = 0x123A, 5150, 0xBEEF5
    for b in range(8):
        a[b] = (0xA0 >> (7 - b)) & 1
    for b in range(16):
        a[8 + b] = (ch >> (15 - b)) & 1
        a[24 + b] = (grp >> (15 - b)) & 1
    for b in range(24):
        a[40 + b] = (src >> (23 - b)) & 1
    t = p25m.parse_tsbk(p25m.encode_tsbk(0x00, 0x00, a, lb=True))
    assert t["opcodeName"] == "GRP_V_CH_GRANT"
    assert t["channel"] == ch and t["group"] == grp and t["src"] == src
    assert t["svcOpts"] == 0xA0 and t["lb"] == 1


def test_p25_tsdu_through_processor():
    """Synthetic TSDU (2 TSBKs + LB) through the burst processor."""
    from sdrplusplusbrown_tpu.models import p25 as p25m
    r = np.random.default_rng(23)
    nac, duid = 0x25F, 0x7                        # TSDU (dibits 1,3)
    nid = _p25_nid_dibits(nac, duid)
    grant = np.zeros(64, np.uint8)
    ch, grp, src = 0x0C21, 9000, 123456
    for b in range(16):
        grant[8 + b] = (ch >> (15 - b)) & 1
        grant[24 + b] = (grp >> (15 - b)) & 1
    for b in range(24):
        grant[40 + b] = (src >> (23 - b)) & 1
    net = np.zeros(64, np.uint8)
    wacn, sysid = 0xBEE00, 0x3A1
    for b in range(20):
        net[8 + b] = (wacn >> (19 - b)) & 1
    for b in range(12):
        net[28 + b] = (sysid >> (11 - b)) & 1
    tsdu = p25m.encode_tsdu([
        p25m.encode_tsbk(0x00, 0x00, grant),
        p25m.encode_tsbk(0x3B, 0x00, net, lb=True)])
    sync = _sync_air("P25P1")
    frame = np.concatenate([sync, nid, tsdu])
    stream = np.concatenate([r.integers(0, 4, 200).astype(np.uint8),
                             frame,
                             r.integers(0, 4, 200).astype(np.uint8)])
    bp = DMRBurstProcessor()
    for lo in range(0, len(stream), 173):
        bp.push(AIR_TO_OUR[stream[lo:lo + 173]])
    p = bp.summary()["p25"]
    assert p["duidCounts"].get("TSDU", 0) == 1, p
    assert p["tsbkDecodes"] == 2, p
    assert p["lastTSBK"]["opcodeName"] == "NET_STS_BCST", p
    assert p["lastTSBK"]["wacn"] == wacn, p
    assert p["lastTSBK"]["sysId"] == sysid, p


def test_bptc_196_96_roundtrip_and_correction():
    from sdrplusplusbrown_tpu.models import dmr_burst as m
    r = np.random.default_rng(31)
    b96 = r.integers(0, 2, 96).astype(np.uint8)
    tx = m.bptc_196_96_encode(b96)
    got, n = m.bptc_196_96_decode(tx)
    assert n == 0 and np.array_equal(got, b96)
    for errs in ([7], [20, 90], [5, 60, 130]):
        t = tx.copy()
        for e in errs:
            t[e] ^= 1
        got, n = m.bptc_196_96_decode(t)
        assert np.array_equal(got, b96), errs


def test_full_lc_rs_mask_and_csbk_crc():
    from sdrplusplusbrown_tpu.models import dmr_burst as m
    lc = np.array([0, 0, 0, 0xFF, 0xFF, 0xFF, 2, 0x4C, 0x3B], np.uint8)
    for dt in (1, 2):
        d = m.decode_full_lc(m.encode_full_lc(lc, dt), dt)
        assert d["dst"] == 16777215 and d["src"] == 150587, d
    # header/terminator masks must not cross-validate
    assert m.decode_full_lc(m.encode_full_lc(lc, 1), 2) is None
    a = np.zeros(64, np.uint8)
    for b in range(24):
        a[16 + b] = (7001 >> (23 - b)) & 1
        a[40 + b] = (150587 >> (23 - b)) & 1
    c = m.decode_csbk(m.encode_csbk(56, 0, a))
    assert c["csbkoName"] == "BS_Dwn_Act" and c["dst"] == 7001, c
    bad = m.encode_csbk(56, 0, a)
    bad[30] ^= 1
    assert m.decode_csbk(bad) is None


def test_data_burst_payloads_through_processor():
    """Voice header + TLC + CSBK payloads decode past the slot type."""
    from sdrplusplusbrown_tpu.models import dmr_burst as m
    lc = np.array([0, 0, 0, 0, 0x10, 0x65, 2, 0x4C, 0x3B], np.uint8)
    a = np.zeros(64, np.uint8)
    for b in range(24):
        a[16 + b] = (4197 >> (23 - b)) & 1
        a[40 + b] = (150587 >> (23 - b)) & 1
    payloads = [
        (1, m.bptc_196_96_encode(m.encode_full_lc(lc, 1))),
        (3, m.bptc_196_96_encode(m.encode_csbk(56, 0, a))),
        (2, m.bptc_196_96_encode(m.encode_full_lc(lc, 2))),
    ]
    stream = rng.integers(0, 4, 2500).astype(np.uint8)
    sync = _sync_air("DMR_BS_DATA")
    slc_raw = encode_short_lc(0x1, 0x00AB12)
    for k, (dt, pay) in enumerate(payloads):
        e = 300 + 288 * k
        st_bits = encode_slot_type(cc=7, data_type=dt)
        cach = encode_cach(1, 0, [1, 3, 3][k], slc_raw[17*k:17*(k+1)])
        stream[e - 89:e - 77] = _bits_to_air(cach)
        stream[e - 77:e - 28] = _bits_to_air(pay[:98])
        stream[e - 28:e - 23] = _bits_to_air(st_bits[:10])
        stream[e - 23:e + 1] = sync
        stream[e + 1:e + 6] = _bits_to_air(st_bits[10:])
        stream[e + 6:e + 55] = _bits_to_air(pay[98:])
    bp = DMRBurstProcessor()
    for lo in range(0, len(stream), 257):
        bp.push(AIR_TO_OUR[stream[lo:lo + 257]])
    s = bp.summary()
    assert s["burstTypes"].get("VOICE Header", 0) == 1, s["burstTypes"]
    assert s["burstTypes"].get("TLC", 0) == 1, s["burstTypes"]
    assert s["burstTypes"].get("CSBK", 0) == 1, s["burstTypes"]
    assert s["fullLcDecodes"] == 2, s
    assert s["lastFullLC"]["burst"] == "TLC", s["lastFullLC"]
    assert s["lastFullLC"]["dst"] == 0x1065, s["lastFullLC"]
    assert s["lastFullLC"]["src"] == 150587, s["lastFullLC"]
    assert s["csbkDecodes"] == 1, s
    assert s["lastCSBK"]["csbkoName"] == "BS_Dwn_Act", s["lastCSBK"]
    assert s["lastCSBK"]["dst"] == 4197, s["lastCSBK"]


def test_x2tdma_data_burst_fields():
    """X2-TDMA data burst: CACH slot bit, 3-bit CC, burst type at the
    reference's raw offsets (dsd_x2tdma.cpp processX2TDMAdata)."""
    stream = rng.integers(0, 4, 2000).astype(np.uint8)
    sync = _sync_air("X2TDMA_BS_DATA")
    for k, bt in enumerate([3, 9]):                # CSBK, Idle
        e = 400 + 288 * k
        st_bits = np.zeros(10, np.uint8)
        cc = 5
        st_bits[0], st_bits[1], st_bits[2] = (cc >> 2) & 1, \
            (cc >> 1) & 1, cc & 1
        st_bits[3] = 0                             # AIEI
        for b in range(4):
            st_bits[4 + b] = (bt >> (3 - b)) & 1
        cach_bits = np.zeros(24, np.uint8)
        cach_bits[4] = 1                           # slot bit (dibit 2)
        stream[e - 89:e - 77] = _bits_to_air(cach_bits)
        stream[e - 28:e - 23] = _bits_to_air(st_bits)
        stream[e - 23:e + 1] = sync
    bp = DMRBurstProcessor()
    for lo in range(0, len(stream), 331):
        bp.push(AIR_TO_OUR[stream[lo:lo + 331]])
    s = bp.summary()
    assert s["counts"]["X2TDMA_BS_DATA"] == 2, s["counts"]
    assert s["x2BurstTypes"].get("CSBK", 0) == 1, s["x2BurstTypes"]
    assert s["x2BurstTypes"].get("Idle", 0) == 1, s["x2BurstTypes"]
    assert s["x2ColorCode"] == 5, s
    assert s["x2Slot"] == 1, s
