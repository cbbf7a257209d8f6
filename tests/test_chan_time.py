"""Sharded channelized (PFB) pipeline equality vs the unsharded
production path — BASELINE config 5 on the real architecture, over the
virtual 8-device CPU mesh (tests/conftest.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from sdrplusplusbrown_tpu.models.radio import Radio, DEMOD_NFM
from sdrplusplusbrown_tpu.parallel.chan_time import (
    ShardedChannelizedPipeline)

FS = 2_400_000.0
C = 16


def _mesh(nt, nc):
    devs = jax.devices()[:nt * nc]
    if len(devs) < nt * nc:
        pytest.skip(f"needs {nt * nc} devices")
    return Mesh(np.array(devs).reshape(nt, nc), ("time", "ch"))


def _signal(T, offsets, seed=0, live_every=4):
    """FM carriers on every ``live_every``-th channel + noise floor."""
    rng = np.random.default_rng(seed)
    n = np.arange(T)
    x = np.zeros(T, np.complex128)
    for off in offsets[::live_every]:
        tone = 0.5 * np.sin(2 * np.pi * 700.0 * n / FS)
        ph = 2 * np.pi * np.cumsum(2500 * tone) / FS
        x += np.exp(1j * (ph + 2 * np.pi * off * n / FS))
    x = x / max(len(offsets[::live_every]), 1)
    x += 0.003 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    return x.astype(np.complex64)


def _snr_db(ref, test):
    err = np.mean((np.asarray(ref) - np.asarray(test)) ** 2)
    sig = np.mean(np.asarray(ref) ** 2)
    return 10 * np.log10(sig / max(err, 1e-30))


def _run_pair(mesh, n_blocks, squelch_level, t_local=24_000):
    radio = Radio(FS, DEMOD_NFM, squelch_enabled=True,
                  pll_mode="normalize")
    pipe = ShardedChannelizedPipeline(
        FS, mesh, C, t_local, DEMOD_NFM, squelch_enabled=True)
    offsets = np.linspace(-1.0e6, 1.0e6, C) + 917.0
    T = pipe.t_global
    x_blocks = [_signal(T, offsets, seed=b) for b in range(n_blocks)]

    params_s = pipe.make_params(offsets, squelch_level=squelch_level)
    carry = pipe.init_carry()
    audio_s = []
    for xb in x_blocks:
        y, carry = pipe.step(params_s, carry, jnp.asarray(xb))
        audio_s.append(np.asarray(jax.device_get(y)))

    params_u = radio.make_params_channelized(
        offsets, squelch_level=squelch_level)
    state = radio.init_state_channelized(C)
    audio_u = []
    for xb in x_blocks:
        y, state = radio.apply_channelized(params_u, state,
                                           jnp.asarray(xb))
        audio_u.append(np.asarray(jax.device_get(y)))

    a_s = np.concatenate(audio_s, axis=-1)
    a_u = np.concatenate(audio_u, axis=-1)
    assert a_s.shape == a_u.shape, (a_s.shape, a_u.shape)
    return a_s, a_u


def test_sharded_channelized_chained_equality():
    """Sharded (2 time × 4 ch) chained path == unsharded chained path
    across a 3-block stream (carry correctness included)."""
    mesh = _mesh(2, 4)
    a_s, a_u = _run_pair(mesh, 3, squelch_level=-20.0)
    snr = _snr_db(a_u, a_s)
    assert snr > 55.0, snr
    # the squelch actually did something: some channels gated silent
    ch_pow = np.mean(a_u ** 2, axis=(1, 2))
    assert (ch_pow < 1e-12).any() and (ch_pow > 1e-6).any(), ch_pow


def test_sharded_channelized_squelch_open():
    """Level low enough that every channel passes — exercises the
    all-open gate path."""
    mesh = _mesh(2, 4)
    a_s, a_u = _run_pair(mesh, 2, squelch_level=-100.0)
    assert _snr_db(a_u, a_s) > 55.0


def test_sharded_channelized_time_only_mesh():
    """nt=4, nc=1 — pure time sharding."""
    mesh = _mesh(4, 1)
    a_s, a_u = _run_pair(mesh, 2, squelch_level=-20.0)
    assert _snr_db(a_u, a_s) > 55.0


# ---------------------------------------------------------------------
# round-4: every demod mode on the channelized front (generic DemodTail)

def _run_mode_pair(demod_id, fs, offsets, make_mod, n_blocks=3,
                   t_target=40_000, live_every=4, atol_db=55.0,
                   **radio_kwargs):
    """Sharded-vs-unsharded stream equality for one demod mode.

    Equality is scored on the POPULATED channels only: an idle
    FM-family channel demodulates pure noise floor, whose quadrature
    angle is a chaotic ±π-wrap walk — both pipelines are 'correct'
    there but decohere from f32 phase-table rounding, which says
    nothing about the signal path."""
    from sdrplusplusbrown_tpu.models.radio import Radio
    radio_kwargs.setdefault("pll_mode", "normalize")
    radio_kwargs.setdefault("squelch_enabled", False)
    radio = Radio(fs, demod_id, **radio_kwargs)
    if not radio.can_channelize():
        pytest.skip(f"config cannot channelize (if {radio.if_rate})")
    g = ShardedChannelizedPipeline.granularity(radio)
    mesh = _mesh(2, 2)
    t_local = ((t_target + g - 1) // g) * g
    Cm = len(offsets)
    pipe = ShardedChannelizedPipeline(fs, mesh, Cm, t_local, demod_id,
                                      **radio_kwargs)
    assert not pipe._nfm_fast or demod_id == DEMOD_NFM
    params = pipe.make_params(offsets)
    carry = pipe.init_carry()
    T = pipe.t_global
    x = make_mod(n_blocks * T, offsets[::live_every], fs)
    st = radio.init_state_channelized(Cm)
    pu = radio.make_params_channelized(offsets)
    for b in range(n_blocks):
        xb = jnp.asarray(x[b * T:(b + 1) * T])
        audio, carry = pipe.step(params, carry, xb)
        au, st = radio.apply_channelized(pu, st, xb)
        a = np.asarray(audio)[::live_every]
        u = np.asarray(au)[::live_every]
        snr = _snr_db(u, a)
        assert snr > atol_db, (demod_id, b, snr)


def _fm_stereo_x(T, live, fs):
    n = np.arange(T)
    t = n / fs
    tone = np.sin(2 * np.pi * 800 * t)
    mpx = (0.4 * tone + 0.1 * np.sin(2 * np.pi * 19000 * t)
           + 0.4 * tone * (-np.cos(2 * np.pi * 38000 * t)))
    ph = 2 * np.pi * np.cumsum(75000 * mpx) / fs
    x = np.zeros(T, np.complex128)
    for o in live:
        x += np.exp(1j * (ph + 2 * np.pi * o * n / fs))
    return (x / max(len(live), 1)).astype(np.complex64)


def _am_x(T, live, fs):
    n = np.arange(T)
    t = n / fs
    x = np.zeros(T, np.complex128)
    for o in live:
        x += (1.0 + 0.6 * np.sin(2 * np.pi * 700 * t)) \
            * np.exp(2j * np.pi * o * n / fs)
    return (x / max(len(live), 1)).astype(np.complex64)


@pytest.mark.slow
def test_sharded_channelized_wfm_stereo():
    from sdrplusplusbrown_tpu.models.radio import DEMOD_WFM
    offs = np.linspace(-3.4e6, 3.4e6, 16)
    _run_mode_pair(DEMOD_WFM, 8_000_000.0, offs, _fm_stereo_x)


@pytest.mark.slow
def test_sharded_channelized_am():
    from sdrplusplusbrown_tpu.models.radio import DEMOD_AM
    offs = np.linspace(-700e3, 700e3, 16) + 517.0
    _run_mode_pair(DEMOD_AM, 1_920_000.0, offs, _am_x,
                   t_target=200_000)


@pytest.mark.slow
def test_sharded_channelized_usb():
    from sdrplusplusbrown_tpu.models.radio import DEMOD_USB
    offs = np.linspace(-700e3, 700e3, 16) + 517.0
    _run_mode_pair(DEMOD_USB, 1_920_000.0, offs, _am_x,
                   t_target=200_000, atol_db=45.0)


@pytest.mark.slow
def test_sharded_channelized_nfm_deemph():
    """NFM with standalone de-emphasis routes through the generic
    DemodTail (not the fast path) — the affine-scan deemp rule under
    the channelized front."""
    def fm_x(T, live, fs):
        n = np.arange(T)
        t = n / fs
        tone = 0.5 * np.sin(2 * np.pi * 700.0 * t)
        ph = 2 * np.pi * np.cumsum(2500 * tone) / fs
        x = np.zeros(T, np.complex128)
        for o in live:
            x += np.exp(1j * (ph + 2 * np.pi * o * n / fs))
        return (x / max(len(live), 1)).astype(np.complex64)

    offs = np.linspace(-1.0e6, 1.0e6, 16) + 917.0
    _run_mode_pair(DEMOD_NFM, FS, offs, fm_x, deemphasis="50us")
