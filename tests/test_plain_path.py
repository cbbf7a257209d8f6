"""The plain JAX path end to end, on the grids the removed hand kernels
were tested on: the spectrum path against numpy, the shared front end
against broadcast RxVFOs, the channelized bank against the per-channel
chain, and WFM stereo separation across bank widths."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdrplusplusbrown_tpu.models.radio import (Radio, DEMOD_NFM, DEMOD_WFM,
                                               DEMOD_AM, DEMOD_USB)
from sdrplusplusbrown_tpu.models.rx_vfo import RxVFO, SharedRxVFOBank
from sdrplusplusbrown_tpu.ops import windows
from sdrplusplusbrown_tpu.ops.spectrum import SpectrumPath
from sdrplusplusbrown_tpu.utils import synth

FS = 2_400_000.0


def _blocks(g, target):
    return ((target + g - 1) // g) * g


# ---------------------------------------------------------------- spectrum
def numpy_spectra(x, keep, interval, fft_size, window="nuttall"):
    """Keep/skip framing, (−1)^i-centred window, zero pad, |X|²/N² in dB
    (reference iq_frontend.cpp:267-311)."""
    n = len(x) // interval
    w = windows.fft_window(window, keep) * np.where(
        np.arange(keep) % 2, -1.0, 1.0)
    frames = np.stack([x[f * interval:f * interval + keep] * w
                       for f in range(n)])
    X = np.fft.fft(frames, n=fft_size, axis=-1)
    return 10 * np.log10(np.maximum(np.abs(X) ** 2 / fft_size ** 2, 1e-30))


@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("fft_size", [1024, 4096, 16384, 65536])
def test_spectrum_path_matches_numpy(rng, fft_size, skip, planes):
    # interval above fft_size → keep = fft_size and a skipped tail;
    # below → keep = interval, zero-padded to fft_size
    interval = int(fft_size * (1.5 if skip else 0.75))
    sp = SpectrumPath(interval * 20.0, fft_size=fft_size, fft_rate=20.0)
    assert sp.reshaper.interval == interval
    assert sp.reshaper.keep == min(interval, fft_size)
    T = 2 * interval
    n = np.arange(T)
    x = (np.exp(2j * np.pi * 0.1234 * n)
         + 0.01 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
         ).astype(np.complex64)
    feed = ((jnp.asarray(x.real), jnp.asarray(x.imag)) if planes
            else jnp.asarray(x))
    got, _ = sp.apply(None, None, feed)
    want = numpy_spectra(x.astype(np.complex128), sp.reshaper.keep,
                         interval, fft_size)
    got = np.asarray(got)
    assert got.shape == want.shape == (2, fft_size)
    assert np.array_equal(np.argmax(got, -1), np.argmax(want, -1))
    # float32 FFT: the strong bins agree to a few hundredths of a dB
    strong = want > want.max() - 60.0
    np.testing.assert_allclose(got[strong], want[strong], atol=0.05)


# ---------------------------------------------------------------- front end
@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("demod", [DEMOD_NFM, DEMOD_WFM, DEMOD_AM,
                                   DEMOD_USB])
def test_shared_front_end_matches_broadcast_rxvfo(rng, demod, C):
    """SharedRxVFOBank (mix-down folded into the first decimator) gives
    the IF a broadcast RxVFO bank gives, to float32 rounding."""
    radio = Radio(FS, demod)
    T = _blocks(radio.in_multiple, 48_000)
    offs = np.linspace(-0.9e6, 0.9e6, C) + 1234.0
    x = (rng.standard_normal(T) + 1j * rng.standard_normal(T)
         ).astype(np.complex64) * 0.3
    base = RxVFO(FS, radio.vfo.out_samplerate, radio.vfo.bandwidth)
    want, _ = base.apply(base.make_params(offs), base.init_state((C,)),
                         jnp.broadcast_to(jnp.asarray(x), (C, T)))
    vs = SharedRxVFOBank(FS, radio.vfo.out_samplerate, radio.vfo.bandwidth)
    got, _ = vs.apply(vs.make_params(offs), vs.init_state(C),
                      jnp.asarray(x))
    assert got.shape == want.shape
    assert synth.snr_db(np.asarray(want), np.asarray(got)) > 70.0


# ---------------------------------------------------------------- channelized
@pytest.mark.parametrize("C", [2, 4])
def test_channelized_matches_per_channel_oracle(C):
    """PFB front end vs the per-channel chain: each channel's tone at
    least as clean (within 1 dB) and above 25 dB."""
    radio = Radio(FS, DEMOD_NFM, pll_mode="normalize")
    T = _blocks(radio.in_multiple, 240_000)
    offs = np.linspace(-1.05e6, 1.08e6, C) + 3217.0
    tones = 400.0 + 150.0 * np.arange(C)
    n = np.arange(T)
    x = synth.band([synth.nfm(n, FS, o, f) for o, f in zip(offs, tones)],
                   T, seed=C)
    yu, _ = jax.jit(lambda p, s, b: radio.apply(p, s, b))(
        radio.make_params(offs), radio.init_state((C,)),
        jnp.broadcast_to(jnp.asarray(x)[None, :], (C, T)))
    yc, _ = jax.jit(lambda p, s, b: radio.apply_channelized(p, s, b))(
        radio.make_params_channelized(offs),
        radio.init_state_channelized(C), jnp.asarray(x))
    assert yc.shape == yu.shape
    for i, f in enumerate(tones):
        su = synth.tone_snr(np.asarray(yu)[i, 0, 1000:], f)
        sc = synth.tone_snr(np.asarray(yc)[i, 0, 1000:], f)
        assert sc > 25.0, (i, sc)
        assert sc > su - 1.0, (i, su, sc)


# ---------------------------------------------------------------- WFM stereo
@pytest.mark.parametrize("C,planes", [(1, True), (4, True), (8, True),
                                      (4, False)])
def test_wfm_stereo_separation(C, planes):
    """apply_shared on a band of C stereo stations: each station's L tone
    lands in L and its R tone in R, ≥ 12 dB apart (the repo's stereo
    oracle, tests/test_radio.py)."""
    radio = Radio(FS, DEMOD_WFM, pll_mode="normalize")
    T = _blocks(radio.in_multiple, 240_000)
    offs = np.linspace(-0.9e6, 0.9e6, C) if C > 1 else np.array([3e5])
    f_l = 600.0 + 200.0 * np.arange(C)
    f_r = 2500.0 + 200.0 * np.arange(C)
    n = np.arange(2 * T)
    x = synth.band([synth.fm_stereo(n, FS, o, a, b)
                    for o, a, b in zip(offs, f_l, f_r)], len(n), seed=C)
    step = jax.jit(lambda p, s, b: radio.apply_shared(p, s, b))
    p, s = radio.make_params_shared(offs), radio.init_state_shared(C)
    out = []
    for b in (x[:T], x[T:]):
        feed = ((jnp.asarray(b.real), jnp.asarray(b.imag)) if planes
                else jnp.asarray(b))
        y, s = step(p, s, feed)
        out.append(np.asarray(y))
    y = np.concatenate(out, -1)[..., 2000:]
    assert y.shape[:2] == (C, 2)
    for c in range(C):
        l, r = y[c]
        assert synth.tone_power(l, f_l[c], 48e3) > 0.1
        assert synth.tone_power(l, f_l[c], 48e3) > \
            4 * synth.tone_power(l, f_r[c], 48e3)
        assert synth.tone_power(r, f_r[c], 48e3) > \
            4 * synth.tone_power(r, f_l[c], 48e3)
