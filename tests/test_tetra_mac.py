"""TETRA lower-MAC decode (VERDICT r2 item 7): burst sync, BSCH chain
(descramble → de-interleave → de-puncture → Viterbi → CRC) and AACH
RM(30,14), asserted on the reference golden capture down to decoded
FRAME FIELDS — not just constellation SNR.

reference: decoder_modules/ch_tetra_demodulator (osmo-tetra); protocol
constants are ETSI EN 300 392-2 data (models/tetra.py)."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sdrplusplusbrown_tpu.models import tetra as tt

RECDIR = "/root/reference/e2e/recordings"
CAP = os.path.join(RECDIR, "tetra_sample.wav")


def _encode_bsch(t1: np.ndarray) -> np.ndarray:
    """Reference-faithful type-1 → type-5 encoder (test oracle)."""
    r = tt.crc16_itut(t1)
    c = np.array([((r ^ 0xFFFF) >> (15 - i)) & 1 for i in range(16)],
                 np.uint8)
    t2 = np.concatenate([t1, c, np.zeros(4, np.uint8)])
    dd = np.zeros(4, np.int64)
    mom = []
    for b in t2:
        mom += [(b + dd[0] + dd[3]) % 2,
                (b + dd[1] + dd[2] + dd[3]) % 2,
                (b + dd[0] + dd[1] + dd[3]) % 2,
                (b + dd[0] + dd[2] + dd[3]) % 2]
        dd = np.roll(dd, 1)
        dd[0] = b
    mom = np.array(mom, np.uint8)
    t3 = np.zeros(120, np.uint8)
    for j in range(1, 121):
        blk = (j - 1) // 3
        t3[j - 1] = mom[8 * blk + (1, 2, 5)[(j - 3 * blk) - 1] - 1]
    t4 = np.zeros(120, np.uint8)
    for i in range(1, 121):
        t4[(11 * i) % 120] = t3[i - 1]
    return t4 ^ tt.scramble_sequence(tt.SCRAMB_INIT, 120)


def test_bsch_chain_round_trip_and_error_correction(rng):
    for trial in range(5):
        t1 = rng.integers(0, 2, 60).astype(np.uint8)
        t5 = _encode_bsch(t1)
        # clean round trip
        burst = np.zeros(tt.BURST_BITS, np.uint8)
        burst[tt.SB_BLK1_OFF:tt.SB_BLK1_OFF + 120] = t5
        t4 = t5 ^ tt.scramble_sequence(tt.SCRAMB_INIT, 120)
        t3 = tt.block_deinterleave(t4, 11)
        t2 = tt.viterbi_k5_r14(tt.depuncture_23(t3, 80))
        assert np.array_equal(t2[:60], t1)
        assert tt.crc16_itut(t2[:76]) == tt.TETRA_CRC_OK
        # the rate-2/3 RCPC corrects scattered channel errors
        t5e = t5.copy()
        for p in rng.choice(120, 2, replace=False):
            t5e[p] ^= 1
        t4e = t5e ^ tt.scramble_sequence(tt.SCRAMB_INIT, 120)
        t2e = tt.viterbi_k5_r14(
            tt.depuncture_23(tt.block_deinterleave(t4e, 11), 80))
        assert np.array_equal(t2e[:60], t1), trial


def test_rm3014_ml_decode(rng):
    for _ in range(20):
        data = rng.integers(0, 2, 14).astype(np.uint8)
        code = np.concatenate([data, data @ tt._RM_GEN % 2])
        got, dist = tt.rm3014_decode(code)
        assert dist == 0 and np.array_equal(got, data)
        # d_min = 6: ML corrects 2 errors
        codee = code.copy()
        for p in rng.choice(30, 2, replace=False):
            codee[p] ^= 1
        got, dist = tt.rm3014_decode(codee)
        assert np.array_equal(got, data) and dist == 2


@pytest.mark.skipif(not os.path.exists(CAP),
                    reason="reference recordings not mounted")
@pytest.mark.slow
def test_golden_capture_bsch_frame_fields():
    """The shipped tetra_sample.wav decodes to a consistent cell with
    CRC-clean SYNC PDUs and a correctly advancing TDMA clock."""
    from sdrplusplusbrown_tpu.io.wav import read_wav_iq
    from sdrplusplusbrown_tpu.ops.demod_digital import Pi4DQPSKDemod
    x, fs = read_wav_iq(CAP)
    dem = Pi4DQPSKDemod(18_000.0, fs)
    st = dem.init_state(())
    dec = tt.TetraDownlinkDecoder()
    B = 100_000
    for i in range(len(x) // B):
        (d, dibit, valid), st = dem.apply(
            None, st, jnp.asarray(x[i * B:(i + 1) * B]))
        dec.push(np.asarray(dibit)[np.asarray(valid)])

    assert dec.bursts_seen > 300
    # every synchronized burst yields a CRC-clean SYNC PDU
    assert len(dec.sync_infos) == dec.bursts_seen
    # one consistent cell across the whole capture
    cells = {(s.colour, s.mcc, s.mnc) for s in dec.sync_infos}
    assert cells == {(22, 250, 13)}, cells
    # TDMA clock advances: fn in 1..18, mn in 0..59, and the multiframe
    # number increments by one exactly when fn wraps 18 -> 1
    fns = [s.fn for s in dec.sync_infos]
    mns = [s.mn for s in dec.sync_infos]
    assert all(1 <= f <= 18 for f in fns)
    assert all(0 <= m <= 59 for m in mns)
    steps = 0
    for k in range(1, len(fns)):
        if mns[k] != mns[k - 1]:
            assert mns[k] == (mns[k - 1] % 60) + 1, (k, mns[k - 1],
                                                     mns[k])
            assert fns[k] < fns[k - 1]          # fn wrapped
            steps += 1
    assert steps > 5
    # AACH: broadcast blocks decode as exact RM(30,14) codewords under
    # the cell scrambling learned from the BSCH
    assert len(dec.aach) > 300
    dists = np.array([a[3] for a in dec.aach])
    assert np.mean(dists == 0) > 0.95


@pytest.mark.skipif(not os.path.exists(CAP),
                    reason="reference recordings not mounted")
@pytest.mark.slow
def test_tetra_module_decodes_capture(tmp_path):
    """App-level: file source + ch_tetra_demodulator module decodes the
    cell identity over the control plane."""
    import json
    from sdrplusplusbrown_tpu.app import SDRApp
    root = str(tmp_path / "root")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"source": {"type": "file", "path": CAP},
                   "fftSize": 4096,
                   "modules": {"Tetra": {
                       "type": "ch_tetra_demodulator", "offset": 0.0}}},
                  f)
    app = SDRApp(root, run_pump=False)
    try:
        mod = app.modules["Tetra"]
        from sdrplusplusbrown_tpu.io.wav import read_wav_iq
        x, fs = read_wav_iq(CAP)
        g = mod.rc.out_len
        n = (200_000 // g) * g
        app.baseband_event.emit(x[:n])
        st = mod.handle_debug_command("status", "")
        assert st["sync_decodes"] > 10, st
        assert st["cell"]["mcc"] == 250 and st["cell"]["mnc"] == 13
        assert st["cell"]["colour"] == 22
    finally:
        app.shutdown()


@pytest.mark.skipif(not os.path.exists(CAP),
                    reason="reference recordings not mounted")
def test_golden_capture_upper_mac_sysinfo():
    """Upper MAC (round-4): normal downlink bursts decode through the
    SCH/HD chain using the cell scrambling learned from the BSCH, and
    the MAC broadcast PDUs carry ONE consistent SYSINFO cell
    description (EN 300 392-2 21.4.4.1; reference: vendored osmo-tetra
    macpdu parsing)."""
    from sdrplusplusbrown_tpu.io.wav import read_wav_iq
    from sdrplusplusbrown_tpu.ops.demod_digital import Pi4DQPSKDemod
    x, fs = read_wav_iq(CAP)
    dem = Pi4DQPSKDemod(18_000.0, fs)
    st = dem.init_state(())
    dec = tt.TetraDownlinkDecoder()
    B = 100_000
    for i in range(len(x) // B):
        (d, dibit, valid), st = dem.apply(
            None, st, jnp.asarray(x[i * B:(i + 1) * B]))
        dec.push(np.asarray(dibit)[np.asarray(valid)])

    assert dec.ndb_seen > 500, dec.ndb_seen
    assert dec.sch_hd_decodes > 1000, dec.sch_hd_decodes
    assert len(dec.sysinfo) > 400, len(dec.sysinfo)
    assert len(dec.mac_resource) > 400, len(dec.mac_resource)
    # one consistent broadcast cell description across the capture
    assert {s["mainCarrier"] for s in dec.sysinfo} == {2725}
    assert {s["locationArea"] for s in dec.sysinfo} == {1030}
    assert {s["freqBand"] for s in dec.sysinfo} == {4}
    assert {s["subscriberClass"] for s in dec.sysinfo} == {65535}
    # SYSINFO dominantly rides the BNCH on block 2 of its burst
    blk2 = sum(1 for s in dec.sysinfo if s["blk"] == 2)
    assert blk2 > 0.8 * len(dec.sysinfo), (blk2, len(dec.sysinfo))
    # MAC-RESOURCE: mostly null PDUs (idle downlink filler), but real
    # SSI-addressed grants are present and repeat for the same
    # subscribers
    ssis = [m["ssi"] for m in dec.mac_resource if "ssi" in m]
    assert len(ssis) >= 5, ssis
    from collections import Counter
    repeats = [s for s, c in Counter(ssis).items() if c >= 2]
    assert repeats, ssis


# ---------------------------------------------------------------------------
# Round-5: SCH/F + MAC fragment reassembly (VERDICT r4 ask #6)
# ---------------------------------------------------------------------------

def _encode_sch(t1: np.ndarray, K: int, a: int, n_type2: int,
                init: int) -> np.ndarray:
    """Generic type-1 → type-5 encoder for SCH/HD (K=216,a=101,144) and
    SCH/F (K=432,a=103,288) — reference-faithful test oracle, same
    construction as _encode_bsch."""
    r = tt.crc16_itut(t1)
    c = np.array([((r ^ 0xFFFF) >> (15 - i)) & 1 for i in range(16)],
                 np.uint8)
    t2 = np.concatenate([t1, c, np.zeros(4, np.uint8)])
    assert len(t2) == n_type2
    dd = np.zeros(4, np.int64)
    mom = []
    for b in t2:
        mom += [(b + dd[0] + dd[3]) % 2,
                (b + dd[1] + dd[2] + dd[3]) % 2,
                (b + dd[0] + dd[1] + dd[3]) % 2,
                (b + dd[0] + dd[2] + dd[3]) % 2]
        dd = np.roll(dd, 1)
        dd[0] = b
    mom = np.array(mom, np.uint8)
    t3 = np.zeros(K, np.uint8)
    for j in range(1, K + 1):
        blk = (j - 1) // 3
        t3[j - 1] = mom[8 * blk + (1, 2, 5)[(j - 3 * blk) - 1] - 1]
    t4 = np.zeros(K, np.uint8)
    for i in range(1, K + 1):
        t4[(a * i) % K] = t3[i - 1]
    return t4 ^ tt.scramble_sequence(init, K)


def _bits(val: int, n: int) -> list:
    return [(val >> (n - 1 - i)) & 1 for i in range(n)]


def _mk_bsch_burst(mcc, mnc, colour):
    t1 = np.zeros(60, np.uint8)
    t1[4:10] = _bits(colour, 6)
    t1[31:41] = _bits(mcc, 10)
    t1[41:55] = _bits(mnc, 14)
    t5 = _encode_bsch(t1)
    burst = np.zeros(tt.BURST_BITS, np.uint8)
    burst[tt.SB_BLK1_OFF:tt.SB_BLK1_OFF + 120] = t5
    burst[tt.SB_SYNC_TRAIN_OFF:tt.SB_SYNC_TRAIN_OFF + 38] = tt.Y_BITS
    return burst


def _mk_hd_burst(t1_blk1: np.ndarray, init: int) -> np.ndarray:
    burst = np.zeros(tt.BURST_BITS, np.uint8)
    t5 = _encode_sch(t1_blk1, 216, 101, 144, init)
    burst[tt.NDB_BLK1_OFF:tt.NDB_BLK1_OFF + 216] = t5
    burst[tt.NDB_TRAIN_OFF:tt.NDB_TRAIN_OFF + 22] = tt.P_BITS
    return burst


def _mk_f_burst(t1: np.ndarray, init: int) -> np.ndarray:
    burst = np.zeros(tt.BURST_BITS, np.uint8)
    t5 = _encode_sch(t1, 432, 103, 288, init)
    burst[tt.NDB_BLK1_OFF:tt.NDB_BLK1_OFF + 216] = t5[:216]
    burst[tt.NDB_BLK2_OFF:tt.NDB_BLK2_OFF + 216] = t5[216:]
    burst[tt.NDB_TRAIN_OFF:tt.NDB_TRAIN_OFF + 22] = tt.N_BITS
    return burst


def _bits_to_dibits(bits: np.ndarray) -> np.ndarray:
    """Inverse of tt.dibits_to_bits: TETRA bit pair → demod dibit."""
    pair2d = {(0, 0): 0, (0, 1): 1, (1, 1): 2, (1, 0): 3}
    return np.array([pair2d[(int(bits[2 * i]), int(bits[2 * i + 1]))]
                     for i in range(len(bits) // 2)], np.int32)


def test_sch_f_chain_round_trip(rng):
    init = tt.cell_scramb_init(250, 13, 22)
    t1 = rng.integers(0, 2, 268).astype(np.uint8)
    burst = _mk_f_burst(t1, init)
    out = tt.decode_sch_f(burst, init)
    assert out is not None and np.array_equal(out, t1)
    # scattered channel errors are corrected by the RCPC
    b2 = burst.copy()
    for e in (30, 150, 300, 430):
        b2[tt.NDB_BLK1_OFF + e % 216] ^= 1
    assert tt.decode_sch_f(b2, init) is not None


def test_fragmented_sds_loopback(rng):
    """End-to-end loopback: a D-SDS-DATA TM-SDU fragmented over
    MAC-RESOURCE(start) + MAC-FRAG + MAC-END on SCH/HD, through the
    full burst/Viterbi/reassembly chain (EN 300 392-2 §21.4.3,
    §14.7.1.10; reference vendored osmo-tetra fragslots)."""
    mcc, mnc, colour = 250, 13, 22
    init = tt.cell_scramb_init(mcc, mnc, colour)
    # TM-SDU: BL-UDATA + CMCE D-SDS-DATA, SSI 0x123456, SDS-TL (type 3)
    payload = b"HELLO JAX"
    data_bits = np.unpackbits(np.frombuffer(payload, np.uint8))
    sdu = np.array(
        _bits(0b0010, 4) + _bits(2, 3) + _bits(15, 5) + _bits(1, 2)
        + _bits(0x123456, 24) + _bits(3, 2) + _bits(len(data_bits), 11),
        np.uint8)
    sdu = np.concatenate([sdu, data_bits])          # 51 + 72 = 123 bits
    # START (MAC-RESOURCE, li=63=start-frag, SSI addr, no elements)
    hdr = np.array(_bits(0, 2) + [0, 0] + _bits(0, 2) + [0]
                   + _bits(63, 6) + _bits(1, 3) + _bits(0xFFFFFF, 24)
                   + [0, 0, 0], np.uint8)
    start_blk = np.concatenate([hdr, sdu[:124 - len(hdr)]])
    used = 124 - len(hdr)
    # FRAG: 01|0|fill header, SDU chunk = the whole rest of the block
    # (zero-padded; the inner CMCE length indicator bounds the parse)
    frag_sdu_len = 124 - 4
    used2 = used + frag_sdu_len
    frag_blk = np.concatenate([np.array([0, 1, 0, 0], np.uint8),
                               np.concatenate([
                                   sdu[used:], np.zeros(
                                       frag_sdu_len - (len(sdu) - used),
                                       np.uint8)])[:frag_sdu_len]])
    rest = max(0, len(sdu) - used2)
    li = (rest + 7) // 8 if rest else 1
    end_sdu = np.zeros(8 * li, np.uint8)
    if rest:
        end_sdu[:rest] = sdu[used2:]
    end_blk = np.concatenate([
        np.array([0, 1, 1, 1, 0], np.uint8), np.array(_bits(li, 6),
                                                      np.uint8),
        np.array([0, 0], np.uint8), end_sdu])
    end_blk = np.concatenate([end_blk,
                              np.zeros(124 - len(end_blk), np.uint8)])
    # assemble the bit stream: BSCH, then the three fragments in the
    # SAME timeslot of consecutive frames (4 slots = 2040 bits apart)
    stream = np.zeros(510 * 14, np.uint8)
    stream[0:510] = _mk_bsch_burst(mcc, mnc, colour)
    for i, blk in enumerate((start_blk, frag_blk, end_blk)):
        o = 510 + i * 2040
        stream[o:o + 510] = _mk_hd_burst(blk, init)
    dec = tt.TetraDownlinkDecoder()
    dib = _bits_to_dibits(stream)
    # feed in two chunks to cross a block boundary
    dec.push(dib[:2000])
    dec.push(dib[2000:])
    assert dec.mac_pdu_counts.get("MAC-FRAG", 0) == 1, dec.mac_pdu_counts
    assert dec.mac_pdu_counts.get("MAC-END", 0) == 1, dec.mac_pdu_counts
    done = dec.reassembler.completed
    assert len(done) == 1, done
    r = done[0]
    assert r["llc"] == "BL-UDATA"
    assert r["mlePdisc"] == "CMCE"
    assert r["cmcePdu"] == "D-SDS-DATA"
    assert r["callingSsi"] == 0x123456
    assert r["shortDataType"] == 3
    assert r["userDataBits"] == 72
    assert bytes.fromhex(r["userData"]) == payload
    assert r["fragments"] == 3


@pytest.mark.skipif(not os.path.exists(CAP),
                    reason="reference recordings not mounted")
def test_golden_capture_fragment_reassembly():
    """SCH/F decode + MAC fragment reassembly on the golden capture:
    >=3 completed TM-SDUs, and the repeated fragmented broadcast
    reassembles to BIT-IDENTICAL 513-bit BL-UDATA / MLE
    D-NWRK-BROADCAST PDUs across independent transmissions."""
    from sdrplusplusbrown_tpu.io.wav import read_wav_iq
    from sdrplusplusbrown_tpu.ops.demod_digital import Pi4DQPSKDemod
    x, fs = read_wav_iq(CAP)
    dem = Pi4DQPSKDemod(18_000.0, fs)
    st = dem.init_state(())
    dec = tt.TetraDownlinkDecoder()
    B = 100_000
    for i in range(len(x) // B):
        (d, dibit, valid), st = dem.apply(
            None, st, jnp.asarray(x[i * B:(i + 1) * B]))
        dec.push(np.asarray(dibit)[np.asarray(valid)])
    assert dec.sch_f_decodes >= 10, dec.sch_f_decodes
    assert dec.mac_pdu_counts.get("MAC-FRAG", 0) >= 3
    assert dec.mac_pdu_counts.get("MAC-END", 0) >= 3
    done = dec.reassembler.completed
    assert len(done) >= 3, len(done)
    full = [r for r in done if r["bits"] == 513]
    assert len(full) >= 2, [r["bits"] for r in done]
    for r in full:
        assert r["llc"] == "BL-UDATA"
        assert r["mlePdisc"] == "MLE"
        assert r["mlePdu"] == "D-NWRK-BROADCAST"
    # independent fragmentations of the same broadcast: equal content
    assert np.array_equal(full[0]["tmSdu"], full[1]["tmSdu"])
