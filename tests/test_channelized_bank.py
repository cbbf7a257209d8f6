"""Channelized (PFB) VFO bank: the wide-C front end.

The oversampled channelizer path (models/rx_vfo.py:ChannelizedRxVFOBank)
is signal-equivalent — not bit-near — to the per-channel RxVFO chain
(reference: core/src/dsp/channel/rx_vfo.h:89-121), so these tests assert
signal-level oracles: tone placement at the op level, demod-audio parity
with the per-channel path, streaming continuity, and params-only retune.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdrplusplusbrown_tpu.ops.channelizer import OversampledChannelizer
from sdrplusplusbrown_tpu.ops import taps as taps_mod
from sdrplusplusbrown_tpu.models.rx_vfo import ChannelizedRxVFOBank
from sdrplusplusbrown_tpu.models.radio import Radio, DEMOD_NFM

FS = 2_400_000.0
OUT = 50_000.0
BW = 12_500.0
M = 48


def test_oversampled_channelizer_tone_placement(rng):
    proto = taps_mod.low_pass(OUT, OUT - BW, FS)
    chz = OversampledChannelizer(FS, M, proto)
    st = chz.init_state()

    T = 48_000
    n = np.arange(2 * T)
    b, delta = 7, 11_000.0
    x = np.exp(2j * np.pi * (b * OUT + delta) * n / FS).astype(np.complex64)

    y1, st = chz.apply(None, st, jnp.asarray(x[:T]))
    y2, st = chz.apply(None, st, jnp.asarray(x[T:]))
    y = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=-1)

    # bin b must carry exp(j*2π*delta*t_j/fs) at frame positions
    # t_j = j*M/2 - M/2 (odd/delayed frames interleave half a hop early)
    j = np.arange(y.shape[-1])
    ref = np.exp(2j * np.pi * delta * (j * (M // 2) - M // 2) / FS)
    seg, refs = y[b, 50:-50], ref[50:-50]
    g = np.vdot(refs, seg) / np.vdot(refs, refs)
    err = seg - g * refs
    snr = 10 * np.log10(np.mean(np.abs(g * refs) ** 2)
                        / max(np.mean(np.abs(err) ** 2), 1e-30))
    assert abs(abs(g) - 1.0) < 1e-3
    assert snr > 100.0


def _nfm_multiplex(offs, T, rng, dev=2.5e3):
    n = np.arange(T)
    x = np.zeros(T, np.complex128)
    for i, off in enumerate(offs):
        tone = 0.6 * np.sin(2 * np.pi * (400 + 150 * i) * n / FS)
        ph = 2 * np.pi * np.cumsum(dev * tone) / FS
        x += np.exp(1j * (ph + 2 * np.pi * off * n / FS))
    x = x / len(offs) + 0.002 * (rng.standard_normal(T)
                                 + 1j * rng.standard_normal(T))
    return x.astype(np.complex64)


def _tone_snr(a, f0, sr=48_000.0):
    a = np.asarray(a, np.float64) - np.mean(a)
    N = len(a)
    S = np.abs(np.fft.rfft(a * np.hanning(N))) ** 2
    fr = np.fft.rfftfreq(N, 1.0 / sr)
    sig = S[np.abs(fr - f0) < 50].sum()
    tot = S[fr > 20].sum()
    return 10 * np.log10(sig / max(tot - sig, 1e-30))


@pytest.mark.slow
def test_channelized_audio_matches_per_channel(rng):
    C = 8
    radio = Radio(FS, DEMOD_NFM, squelch_enabled=True, pll_mode="normalize")
    assert radio.can_channelize()
    g = radio.in_multiple
    T = ((240_000 + g - 1) // g) * g
    offs = np.linspace(-1.05e6, 1.08e6, C) + 3217.0   # off-grid offsets
    x = _nfm_multiplex(offs, T, rng)

    yu, _ = jax.jit(lambda p, s, b: radio.apply(p, s, b))(
        radio.make_params(offs), radio.init_state((C,)),
        jnp.broadcast_to(jnp.asarray(x)[None, :], (C, T)))
    yc, _ = jax.jit(lambda p, s, b: radio.apply_channelized(p, s, b))(
        radio.make_params_channelized(offs), radio.init_state_channelized(C),
        jnp.asarray(x))
    assert yc.shape == yu.shape
    for i in range(C):
        f0 = 400 + 150 * i
        su = _tone_snr(np.asarray(yu)[i, 0, 2000:], f0)
        sc = _tone_snr(np.asarray(yc)[i, 0, 2000:], f0)
        assert sc > 25.0, (i, sc)
        assert sc > su - 1.0, (i, su, sc)   # parity with per-channel path


def test_channelized_bank_streaming_continuity(rng):
    """Block-wise IF output == one-shot (state carries are exact)."""
    C, nblk = 4, 3
    bank = ChannelizedRxVFOBank(FS, OUT, BW)
    T = 48_000
    offs = np.array([-913e3, -201e3, 47e3, 1.013e6]) + 1234.0
    p = bank.make_params(offs)
    x = (rng.standard_normal(nblk * T)
         + 1j * rng.standard_normal(nblk * T)).astype(np.complex64) * 0.3

    st = bank.init_state(C)
    parts = []
    for b in range(nblk):
        y, st = bank.apply(p, st, jnp.asarray(x[b * T:(b + 1) * T]))
        parts.append(np.asarray(y))
    blocked = np.concatenate(parts, axis=-1)

    y1, _ = bank.apply(p, bank.init_state(C), jnp.asarray(x))
    oneshot = np.asarray(y1)
    err = np.abs(blocked - oneshot)
    ref = np.mean(np.abs(oneshot) ** 2)
    snr = 10 * np.log10(ref / max(np.mean(err ** 2), 1e-30))
    # bound set by the fp32 NCO phase carry (~1e-4 rad/block, see
    # ops/xlator.py), same as the fused-front-end continuity tests
    assert snr > 80.0


def test_channelized_retune_is_params_only(rng):
    """Same jitted fn serves a retuned bank: new offsets, no rebuild."""
    C = 4
    radio = Radio(FS, DEMOD_NFM, pll_mode="normalize")
    g = radio.in_multiple
    T = ((360_000 + g - 1) // g) * g   # ≥7200 audio samples post-slice
    step = jax.jit(lambda p, s, b: radio.apply_channelized(p, s, b))

    f_target = 731e3 + 911.0
    offs_a = np.array([-1.0e6, -0.4e6, 0.2e6, 0.9e6])       # none on target
    offs_b = np.array([-1.0e6, f_target, 0.2e6, 0.9e6])     # ch1 retuned
    x = _nfm_multiplex([f_target], T, rng)

    ya, _ = step(radio.make_params_channelized(offs_a),
                 radio.init_state_channelized(C), jnp.asarray(x))
    yb, _ = step(radio.make_params_channelized(offs_b),
                 radio.init_state_channelized(C), jnp.asarray(x))
    sa = _tone_snr(np.asarray(ya)[1, 0, 2000:], 400)
    sb = _tone_snr(np.asarray(yb)[1, 0, 2000:], 400)
    assert sb > 25.0
    assert sb > sa + 20.0


def test_radio_bank_auto_channelize(rng):
    """Wide NFM group auto-selects the PFB path; narrow group stays on
    the fused front end; both produce working audio."""
    from sdrplusplusbrown_tpu.models.radio_bank import RadioBank, VFOSpec
    from sdrplusplusbrown_tpu.models.radio import DEMOD_WFM

    C = 16
    f0s = np.linspace(-1.0e6, 1.0e6, C) + 531.0
    vfos = [VFOSpec(f"nfm{i}", DEMOD_NFM, f0s[i]) for i in range(C)]
    vfos.append(VFOSpec("wfm0", DEMOD_WFM, 150e3))
    bank = RadioBank(FS, vfos, pll_mode="normalize")
    assert bank.channelized[DEMOD_NFM] is True
    assert bank.channelized[DEMOD_WFM] is False   # ratio 4.8, not even

    g = bank.in_multiple
    T = ((360_000 + g - 1) // g) * g
    x = _nfm_multiplex(f0s[:3], T, rng)
    outs, _ = jax.jit(lambda p, s, b: bank.apply(p, s, b))(
        bank.make_params(), bank.init_state(), jnp.asarray(x))
    for i in range(3):
        s = _tone_snr(np.asarray(outs[DEMOD_NFM])[i, 0, 2000:], 400 + 150 * i)
        assert s > 25.0, (i, s)


def test_channelized_rejects_bad_ratio():
    with pytest.raises(ValueError):
        ChannelizedRxVFOBank(FS, 500_000.0, 150e3)   # ratio 4.8
    with pytest.raises(ValueError):
        ChannelizedRxVFOBank(FS, 50_000.0, 50_000.0)  # no transition room


def test_offchannel_alias_rejection(rng):
    """A strong carrier ~out_sr away from a channel's center must not
    open that channel's squelch: components at out_sr ± bw/2 fold into
    the channel passband after the 2:1 decimation, so decim2's stopband
    must start by out_sr − bw/2 (regression: transition out_sr − bw put
    the stopband edge past Nyquist and ±50 kHz-offset carriers aliased
    in at −20 dB, tripping neighbouring squelches)."""
    radio = Radio(FS, DEMOD_NFM, squelch_enabled=True,
                  pll_mode="normalize")
    g = radio.in_multiple
    T = ((240_000 + g - 1) // g) * g
    C = 128
    offs = np.linspace(-1.1e6, 1.1e6, C) + 917.0
    n = np.arange(2 * T)
    m = 0.6 * np.sin(2 * np.pi * 800.0 * n / FS)
    ph = 2 * np.pi * 2.5e3 * np.cumsum(m) / FS
    x = (0.5 * np.exp(1j * (2 * np.pi * offs[17] * n / FS + ph))
         ).astype(np.complex64)
    params = radio.make_params_channelized(offs, squelch_level=-30.0)
    st = radio.init_state_channelized(C)
    _, st = radio.apply_channelized(params, st, jnp.asarray(x[:T]))
    audio, _ = radio.apply_channelized(params, st, jnp.asarray(x[T:]))
    pw = np.mean(np.asarray(audio)[:, 0] ** 2, axis=-1)
    active = set(np.nonzero(pw > 1e-8)[0].tolist())
    assert active == {17}, sorted(active)
    assert pw[17] > 1e-3
