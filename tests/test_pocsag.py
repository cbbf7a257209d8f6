"""POCSAG pager decoder tests: codeword codec, bit-stream decode, and a
full RF loopback through GFSK mod/demod."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdrplusplusbrown_tpu.models.pocsag import (
    POCSAGDecoder, SYNC_WORD, check_codeword, encode_codeword,
    encode_transmission)
from sdrplusplusbrown_tpu.ops.mod import GFSKMod
from sdrplusplusbrown_tpu.ops.demod_digital import GFSKDemod


def test_bch_codeword_roundtrip(rng):
    for _ in range(20):
        data = int(rng.integers(0, 1 << 21))
        cw = encode_codeword(data)
        assert check_codeword(cw) == cw
        # single-bit error corrected
        flip = int(rng.integers(0, 32))
        assert check_codeword(cw ^ (1 << flip)) == cw
    # triple-bit error detected as bad
    cw = encode_codeword(0x0F0F0)
    assert check_codeword(cw ^ 0b10101) is None


def test_bitstream_decode_both_polarities():
    bits = encode_transmission(0x1234C8, "HELLO SDR", function=1)
    for stream in (bits, 1 - bits):
        dec = POCSAGDecoder()
        dec.push_bits(stream)
        assert len(dec.messages) == 1
        assert dec.messages[0]["text"] == "HELLO SDR"


def test_bitstream_decode_with_bit_errors(rng):
    bits = encode_transmission(0x0ABCD0, "PAGE ME", function=0)
    # single-bit errors: one in the sync word (sync spans bits 576-608,
    # tolerated by hamming-distance matching) and two inside codewords
    bits = bits.copy()
    bits[600] ^= 1
    bits[620] ^= 1
    bits[700] ^= 1
    dec = POCSAGDecoder()
    dec.push_bits(bits)
    assert dec.messages and dec.messages[0]["text"] == "PAGE ME"


@pytest.mark.slow
def test_pocsag_rf_loopback(rng):
    """bits → GFSK at 1200 baud ±4.5 kHz → noisy channel → GFSK demod →
    slicer → POCSAG decode."""
    fs, baud, dev = 24_000.0, 1200.0, 4500.0
    sps = int(fs / baud)
    bits = encode_transmission(0x15ABC8, "JAX PAGER OK")
    # trailing idle bits: clock recovery eats a few start-up symbols, so
    # without a tail the last codeword would truncate
    bits = np.concatenate([bits, np.tile([1, 0], 32).astype(np.uint8)])
    nrz = (1.0 - 2.0 * bits).astype(np.float32).repeat(sps)
    mod = GFSKMod(fs, dev, baud, bt=0.5)
    tx, _ = mod.apply(None, mod.init_state(()), jnp.asarray(nrz))
    T = tx.shape[-1]
    ch = (np.asarray(tx) * np.exp(1j * 0.4)
          + 0.05 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
          ).astype(np.complex64)
    dem = GFSKDemod(baud, fs, dev)
    st = dem.init_state(())
    (sym, valid), st = dem.apply(None, st, jnp.asarray(ch))
    s = np.asarray(sym)[np.asarray(valid)]
    hard = (s < 0).astype(np.uint8)       # polarity-agnostic decoder
    dec = POCSAGDecoder()
    dec.push_bits(hard)
    assert dec.messages, "no POCSAG message decoded from RF loopback"
    assert dec.messages[0]["text"] == "JAX PAGER OK"
    assert dec.messages[0]["address"] == 0x15ABC8


def test_kmeans_clusters(rng):
    from sdrplusplusbrown_tpu.utils.kmeans import kmeans
    a = rng.standard_normal((50, 2)) + [10, 0]
    b = rng.standard_normal((50, 2)) + [-10, 0]
    centers, assign = kmeans(np.concatenate([a, b]), 2, seed=1)
    assert len(set(assign[:50])) == 1 and len(set(assign[50:])) == 1
    assert assign[0] != assign[99]


def test_source_manager_registry_and_fallback():
    from sdrplusplusbrown_tpu.io.source_manager import (SourceManager,
                                                        NullSource)
    sm = SourceManager()
    made = {}

    class Fake:
        samplerate = 48000.0

        def blocks(self):
            yield np.zeros(10, np.complex64)

        def tune(self, f):
            made["tuned"] = f

    sm.register("fake", lambda: Fake())
    assert sm.names() == ["fake"]
    assert sm.select("fake")
    sm.tune(7.1e6)
    assert made["tuned"] == 7.1e6
    sm.unregister("fake")
    assert isinstance(sm.source, NullSource)
    assert not sm.select("fake")


def test_long_message_spans_batches():
    """A message overflowing the first 16-codeword batch must decode in
    full (continuation batches carry message codewords only)."""
    # start at a high frame slot so the message spills into batch 2
    long_text = "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG 0123456789"
    bits = encode_transmission(0x1ABCD7, long_text)   # frame 7 → slot 14
    dec = POCSAGDecoder()
    dec.push_bits(bits)
    assert dec.messages, "no message"
    assert dec.messages[0]["text"] == long_text
    assert dec.messages[0]["address"] == 0x1ABCD7
