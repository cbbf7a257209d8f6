"""Seeded synthetic RF captures and the repo's signal-level oracles.

The benchmark cells and the chip smoke test feed the receiver bands of
modulated carriers, so that what comes out is demodulated signal and not
the chaotic output of FM-demodulating noise, and they judge it with the
oracles the tests use: a tone's level in the audio, stereo separation,
and the waterfall SNR estimator (ops/spectrum.calculate_vfo_signal_info).

Every generator takes absolute sample indices ``n`` so a capture built in
one call is phase-continuous across the blocks it is later cut into.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_TWO_PI = 2.0 * np.pi


def _carrier(n: np.ndarray, fs: float, offset: float) -> np.ndarray:
    return np.exp(1j * _TWO_PI * offset * n / fs)


def _fm(n: np.ndarray, fs: float, offset: float, msg: np.ndarray,
        deviation: float) -> np.ndarray:
    phase = _TWO_PI * deviation * np.cumsum(msg) / fs
    return _carrier(n, fs, offset) * np.exp(1j * phase)


def fm_stereo(n, fs, offset, f_left, f_right, deviation=75e3):
    """Broadcast FM stereo: a tone in L only and another in R only, the
    19 kHz pilot at sin and the 38 kHz L−R subcarrier at −cos (the
    phasing the reference's conj(vco)² downconversion expects)."""
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
    """Upper-sideband voice stand-in: a single tone above the dial."""
    return _carrier(n, fs, offset + f_tone)


def tone(n, fs, offset):
    """Unmodulated carrier."""
    return _carrier(n, fs, offset)


def band(carriers: Sequence[np.ndarray], T: int, noise: float = 0.002,
         seed: int = 0) -> np.ndarray:
    """Sum ``carriers`` at equal power (total peak 1) plus complex white
    noise of standard deviation ``noise`` per component → complex64."""
    rng = np.random.default_rng(seed)
    x = np.zeros(T, np.complex128)
    for c in carriers:
        x += c
    x /= max(len(carriers), 1)
    x += noise * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    return x.astype(np.complex64)


def tone_power(x: np.ndarray, f: float, fs: float) -> float:
    """Amplitude of frequency ``f`` in the real signal ``x``."""
    x = np.asarray(x, np.float64)
    c = np.exp(-2j * np.pi * f * np.arange(x.shape[-1]) / fs)
    return float(2.0 * np.abs(np.mean(x * c)))


def tone_snr(audio: np.ndarray, f0: float, sr: float = 48_000.0) -> float:
    """dB of the ±50 Hz band around ``f0`` over everything else above
    20 Hz (Hann-windowed periodogram)."""
    a = np.asarray(audio, np.float64)
    a = a - np.mean(a)
    S = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    fr = np.fft.rfftfreq(len(a), 1.0 / sr)
    sig = S[np.abs(fr - f0) < 50].sum()
    tot = S[fr > 20].sum()
    return float(10 * np.log10(sig / max(tot - sig, 1e-30)))


def snr_db(ref, test) -> float:
    """Output-vs-reference SNR: 10·log10(Σ|ref|² / Σ|test − ref|²)."""
    ref = np.asarray(ref, np.complex128 if np.iscomplexobj(ref)
                     else np.float64)
    err = np.asarray(test) - ref
    sig = float(np.sum(np.abs(ref) ** 2))
    noise = float(np.sum(np.abs(err) ** 2))
    if noise == 0.0:
        return float("inf")
    return float(10 * np.log10(max(sig, 1e-300) / noise))
