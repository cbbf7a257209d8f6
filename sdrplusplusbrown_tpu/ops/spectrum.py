"""Spectrum path: frame reshaping, windowed FFT → dB power, VFO SNR.

reference:
  * Reshaper keep/skip framing — core/src/dsp/buffer/reshaper.h:61-128 with
    parameters from IQFrontEnd::genReshapeParams
    (core/src/signal_path/iq_frontend.h:88-92): fftInterval = round(SR/rate),
    nzSampCount = min(fftInterval, fftSize), skip = fftInterval − nz.
  * Window multiply with the alternating-sign DC-centering trick and zero
    padding to fftSize — iq_frontend.cpp:267-311 (window ``w[i]·(−1)^i``
    shifts the spectrum by N/2, i.e. a built-in fftshift).
  * dB conversion — volk_32fc_s32f_power_spectrum_32f with normalization
    factor = fftSize: 10·log10(|X|²/N²)  (iq_frontend.cpp:282).
  * Per-VFO signal strength / SNR estimator — the waterfall math the
    reference's tests assert on (core/src/gui/widgets/waterfall.cpp:688-756):
    side-lobe regions [c−bw, c−bw/2) ∪ (c+bw/2, c+bw] give a base noise
    floor (mean) and a "true" noise floor (mean of the quietest 25% of side
    bins); snr = max_inband − avg − (avg − qavg).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..runtime.block import Block
from . import windows


def gen_reshape_params(samplerate: float, fft_size: int,
                       fft_rate: float) -> Tuple[int, int]:
    """(nz_samp_count, skip) — reference iq_frontend.h:88-92."""
    fft_interval = int(round(samplerate / fft_rate))
    nz = min(fft_interval, fft_size)
    skip = fft_interval - nz
    return nz, skip


class Reshaper(Block):
    """Keep/skip framing: emit frames of ``keep`` samples every
    ``keep+skip`` samples.  Requiring block length to be a multiple of the
    frame interval keeps the frame count static (the reference instead
    carries a partial frame across blocks, reshaper.h:101-128)."""

    def __init__(self, keep: int, skip: int):
        self.keep = int(keep)
        self.skip = int(skip)
        self.interval = self.keep + self.skip
        self.in_multiple = self.interval

    def out_frames(self, in_len: int) -> int:
        assert in_len % self.interval == 0
        return in_len // self.interval

    def apply(self, params, state, x):
        T = x.shape[-1]
        n = T // self.interval
        frames = x.reshape(x.shape[:-1] + (n, self.interval))[..., :self.keep]
        return frames, state


def make_fft_window(name: str, nz_size: int) -> np.ndarray:
    """Window including the (−1)^i DC-centering factor
    (reference iq_frontend.cpp:304-311)."""
    w = windows.fft_window(name, nz_size)
    signs = np.where(np.arange(nz_size) % 2 == 1, -1.0, 1.0)
    return (w * signs).astype(np.float32)


class SpectrumFFT(Block):
    """frames [..., F, nz] → centered dB power spectra [..., F, fft_size].

    Window-multiply, zero-pad to fft_size, FFT, 10·log10(|X|²/N²).
    """

    def __init__(self, fft_size: int, nz_size: Optional[int] = None,
                 window: str = "nuttall", floor_db: float = -300.0):
        self.fft_size = int(fft_size)
        self.nz_size = int(nz_size) if nz_size is not None else self.fft_size
        assert self.nz_size <= self.fft_size
        self.window = make_fft_window(window, self.nz_size)
        self.floor_db = float(floor_db)

    def apply(self, params, state, x):
        pad = self.fft_size - self.nz_size
        w = jnp.asarray(self.window)
        xw = x * w
        if pad:
            padding = [(0, 0)] * (xw.ndim - 1) + [(0, pad)]
            xw = jnp.pad(xw, padding)
        X = jnp.fft.fft(xw, axis=-1)
        p = (jnp.real(X) ** 2 + jnp.imag(X) ** 2) / float(self.fft_size ** 2)
        db = 10.0 * jnp.log10(jnp.maximum(p, 10.0 ** (self.floor_db / 10.0)))
        return db.astype(jnp.float32), state


class SpectrumPath(Block):
    """Reshaper + windowed FFT: wideband block → [..., n_frames, fft_size]
    dB spectra at ``fft_rate`` Hz (defaults 65536 bins @ 20 fps Nuttall,
    reference core.cpp:559-561, main_window.cpp:104)."""

    def __init__(self, samplerate: float, fft_size: int = 65536,
                 fft_rate: float = 20.0, window: str = "nuttall"):
        self.samplerate = float(samplerate)
        nz, skip = gen_reshape_params(samplerate, fft_size, fft_rate)
        self.reshaper = Reshaper(nz, skip)
        self.fft = SpectrumFFT(fft_size, nz, window)
        self.fft_size = int(fft_size)
        self.in_multiple = self.reshaper.in_multiple

    def apply(self, params, state, x):
        """x: complex wideband [..., T] or its (xr, xi) float32 planes."""
        if isinstance(x, tuple):
            x = jax.lax.complex(*x)
        frames, _ = self.reshaper.apply(None, None, x)
        db, _ = self.fft.apply(None, None, frames)
        return db, state


# ----------------------------------------------------------------------
# Host-side per-VFO SNR estimator (runs at fft_rate on tiny data — kept on
# host like the reference's GUI-thread implementation).

def raw_fft_index(freq: float, samplerate: float, fft_size: int) -> int:
    """Bin index of ``freq`` (Hz, relative to center) in a DC-centered
    spectrum — truncating and clamped like the reference's rawFFTIndex
    (waterfall.cpp)."""
    idx = int((freq / samplerate + 0.5) * fft_size)
    return max(0, min(idx, fft_size))


def calculate_vfo_signal_info(fft_line_db: np.ndarray, center_offset: float,
                              bandwidth: float, samplerate: float):
    """(strength, snr) in dB — reference waterfall.cpp:688-756."""
    fft_line_db = np.asarray(fft_line_db)
    n = fft_line_db.shape[-1]
    lo_side = raw_fft_index(center_offset - bandwidth, samplerate, n)
    lo = raw_fft_index(center_offset - bandwidth / 2.0, samplerate, n)
    hi = raw_fft_index(center_offset + bandwidth / 2.0, samplerate, n)
    hi_side = raw_fft_index(center_offset + bandwidth, samplerate, n)
    if min(lo_side, lo, hi, hi_side) < 0 or hi_side >= n:
        return None
    side = np.concatenate([fft_line_db[..., lo_side:lo],
                           fft_line_db[..., hi + 1:hi_side]], axis=-1)
    if side.shape[-1] == 0:
        return None
    avg = side.mean(axis=-1)
    svals = np.sort(side, axis=-1)
    lower = side.shape[-1] // 4
    if lower <= 0:
        return None
    kth = svals[..., lower:lower + 1]
    mask = side <= kth
    qavg = np.sum(np.where(mask, side, 0.0), axis=-1) / lower
    avgdiff = avg - qavg
    mx = fft_line_db[..., lo:hi + 1].max(axis=-1)
    strength = mx - avgdiff
    snr = mx - avg - avgdiff
    return strength, snr
