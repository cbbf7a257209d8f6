"""Seeded synthetic RF and the signal-level oracles of the benchmark.

A copy, kept with the benchmark so that a change to the program cannot
move the yardstick, of the repository's generators and oracles
(``sdrplusplusbrown_tpu/utils/synth.py`` and the VFO SNR estimator of
``ops/spectrum.py``, itself SDR++'s ``waterfall.cpp:688-756``).

Every generator takes absolute sample indices ``n`` so a capture built in
one call is phase-continuous across the blocks it is later cut into.
"""

from __future__ import annotations

import numpy as np

_TWO_PI = 2.0 * np.pi


def _carrier(n: np.ndarray, fs: float, offset: float) -> np.ndarray:
    return np.exp(1j * _TWO_PI * offset * n / fs)


def _fm(n, fs, offset, msg, deviation):
    phase = _TWO_PI * deviation * np.cumsum(msg) / fs
    return _carrier(n, fs, offset) * np.exp(1j * phase)


def fm_stereo(n, fs, offset, f_left, f_right, deviation=75e3):
    """Broadcast FM stereo: a tone in L only and another in R only, the
    19 kHz pilot at sin and the 38 kHz L−R subcarrier at −cos (the
    phasing SDR++'s conj(vco)² downconversion expects)."""
    t = n / fs
    left = 0.5 * np.sin(_TWO_PI * f_left * t)
    right = 0.5 * np.sin(_TWO_PI * f_right * t)
    mpx = (0.45 * (left + right)
           + 0.45 * (left - right) * -np.cos(_TWO_PI * 38_000.0 * t)
           + 0.1 * np.sin(_TWO_PI * 19_000.0 * t))
    return _fm(n, fs, offset, mpx, deviation)


def nfm(n, fs, offset, f_tone, deviation=2.5e3):
    """Narrowband FM carrying one tone."""
    return _fm(n, fs, offset, 0.6 * np.sin(_TWO_PI * f_tone * n / fs),
               deviation)


def am(n, fs, offset, f_tone, depth=0.6):
    """Double-sideband AM with carrier, one tone."""
    return (1.0 + depth * np.sin(_TWO_PI * f_tone * n / fs)) \
        * _carrier(n, fs, offset)


def usb(n, fs, offset, f_tone):
    """Upper-sideband voice stand-in: a single tone above the dial
    frequency ``offset`` (the suppressed carrier)."""
    return _carrier(n, fs, offset + f_tone)


def band(carriers, T: int, noise: float, rng: np.random.Generator):
    """Sum ``carriers`` at equal power (total peak 1), each turned by a
    random phase, plus complex white noise of standard deviation
    ``noise`` per component → complex64."""
    x = np.zeros(T, np.complex128)
    for c in carriers:
        x += c * np.exp(1j * rng.uniform(0.0, _TWO_PI))
    x /= max(len(carriers), 1)
    x += noise * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    return x.astype(np.complex64)


def tone_power(x, f: float, fs: float) -> float:
    """Amplitude of frequency ``f`` in the real signal ``x``."""
    x = np.asarray(x, np.float64)
    c = np.exp(-2j * np.pi * f * np.arange(x.shape[-1]) / fs)
    return float(2.0 * np.abs(np.mean(x * c)))


def tone_snr(audio, f0: float, sr: float) -> float:
    """dB of the ±50 Hz band around ``f0`` over everything else above
    20 Hz (Hann-windowed periodogram)."""
    a = np.asarray(audio, np.float64)
    a = a - np.mean(a)
    S = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    fr = np.fft.rfftfreq(len(a), 1.0 / sr)
    sig = S[np.abs(fr - f0) < 50].sum()
    tot = S[fr > 20].sum()
    return float(10 * np.log10(max(sig, 1e-300) / max(tot - sig, 1e-300)))


def stereo_separation_db(lr, f_left: float, f_right: float,
                         sr: float) -> float:
    """The worse of L's own tone over R's tone leaking into L, and the
    same for R, in dB."""
    l, r = lr
    pl, pr = tone_power(l, f_left, sr), tone_power(r, f_right, sr)
    return float(20 * np.log10(min(
        pl / max(tone_power(l, f_right, sr), 1e-12),
        pr / max(tone_power(r, f_left, sr), 1e-12))))


def _fft_index(freq: float, samplerate: float, fft_size: int) -> int:
    idx = int((freq / samplerate + 0.5) * fft_size)
    return max(0, min(idx, fft_size))


def vfo_snr_db(line_db, center: float, bandwidth: float,
               samplerate: float) -> float:
    """SDR++'s per-VFO SNR estimate from one dB spectrum line: the
    strongest bin of the passband over the mean of the side bands, less
    the side bands' excess over their quietest quarter."""
    line_db = np.asarray(line_db, np.float64)
    n = line_db.shape[-1]
    lo_side = _fft_index(center - bandwidth, samplerate, n)
    lo = _fft_index(center - bandwidth / 2.0, samplerate, n)
    hi = _fft_index(center + bandwidth / 2.0, samplerate, n)
    hi_side = _fft_index(center + bandwidth, samplerate, n)
    side = np.concatenate([line_db[lo_side:lo], line_db[hi + 1:hi_side]])
    avg = side.mean()
    lower = len(side) // 4
    kth = np.sort(side)[lower]
    qavg = np.sum(np.where(side <= kth, side, 0.0)) / lower
    return float(line_db[lo:hi + 1].max() - avg - (avg - qavg))
