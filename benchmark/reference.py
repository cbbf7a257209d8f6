"""Plain float64 reference of the served receiver, for the output check.

It imports nothing of the program. It follows the receiver's documented
signal chain (SDR++'s ``core/src/dsp`` and ``decoder_modules/radio`` as
the program re-designs them: the WFM stereo section runs on the MPX
decimated by cascaded halfbands, the 19 kHz pilot is normalised rather
than tracked by a PLL, and the 15 kHz audio low-pass is merged into the
polyphase resampler to 48 kHz), written again from those descriptions in
numpy/scipy: filters are designed here from SDR++'s windowed-sinc rules,
every stream starts from zeroed state, and mixing uses the exact phase of
each absolute sample index.

``Numerics(control=True)`` computes the same chain with every stage's
input and every filter's taps rounded to bfloat16 (products and sums stay
wide): the control that the output check must fail.

Streams are processed whole: ``x`` is the stream from absolute sample
``n0``, and every function returns the stream the program would have
produced from the same point with zeroed state.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal as sps

# ---------------------------------------------------------------- numerics


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round to bfloat16 (nearest, ties to even) and back to float64."""
    u = np.asarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32).astype(np.float64)


class Numerics:
    """Where the reference rounds: nowhere (float64), or every stage's
    input and taps to bfloat16 (the control)."""

    def __init__(self, control: bool = False):
        self.control = bool(control)

    def q(self, x):
        if not self.control:
            return x
        x = np.asarray(x)
        if np.iscomplexobj(x):
            return _bf16(x.real) + 1j * _bf16(x.imag)
        return _bf16(x)


# ------------------------------------------- tap design (SDR++ dsp/taps)
NUTTALL = (0.355768, 0.487396, 0.144232, 0.012604)   # window/nuttall.h


def nuttall(n, N):
    n = np.asarray(n, np.float64)
    return sum((-1) ** i * c * np.cos(2.0 * np.pi * i * n / N)
               for i, c in enumerate(NUTTALL))


def tap_count(trans_hz: float, fs: float) -> int:
    """taps/estimate_tap_count.h: 3.8 · fs / transition width."""
    return int(3.8 * fs / trans_hz)


def windowed_sinc(count: int, cutoff_hz: float, fs: float) -> np.ndarray:
    """taps/windowed_sinc.h: half-sample centred sinc × Nuttall."""
    omega = 2.0 * np.pi * cutoff_hz / fs
    t = np.arange(count, dtype=np.float64) - count / 2.0 + 0.5
    return np.sinc(t * omega / np.pi) * nuttall(t - count / 2.0, count) \
        * omega / np.pi


def low_pass(cutoff_hz, trans_hz, fs) -> np.ndarray:
    return windowed_sinc(max(tap_count(trans_hz, fs), 1), cutoff_hz, fs)


def band_pass_complex(lo_hz, hi_hz, trans_hz, fs) -> np.ndarray:
    """taps/band_pass.h, complex branch, odd tap count: a low-pass of
    half the band modulated by exp(−j·ω0·n) (pre-flipped for
    correlation)."""
    count = tap_count(trans_hz, fs)
    count += 1 - count % 2
    t = np.arange(count, dtype=np.float64) - count / 2.0 + 0.5
    n = t - count / 2.0
    omega = 2.0 * np.pi * (hi_hz - lo_hz) / 2.0 / fs
    w0 = 2.0 * np.pi * (lo_hz + hi_hz) / 2.0 / fs
    return np.sinc(t * omega / np.pi) * nuttall(n, count) * omega / np.pi \
        * np.exp(-1j * w0 * n)


# ------------------------------------------------ multirate plans


def decim_stage(fs_in: float, d: int, protect: float) -> np.ndarray:
    """One decimate-by-``d`` low-pass protecting [0, protect] Hz: pass
    edge at ``protect``, stop edge where aliases into it start."""
    stop = fs_in / d - protect
    return windowed_sinc(max(tap_count((stop - protect) / 2.0, fs_in), 7),
                         (protect + stop) / 2.0, fs_in)


def power_decim_plan(fs_in: float, ratio: int, protect_frac=0.45,
                     max_taps=320):
    """Cascade of decimate-by-4 (where the transition stays open and the
    taps fit the budget) and decimate-by-2 stages → [(taps, d)]."""
    protect = protect_frac * fs_in / ratio
    stages, fs, rem = [], fs_in, ratio
    while rem > 1:
        d, taps = (4 if rem % 4 == 0 else 2), None
        if d == 4:
            if fs / 4.0 - protect <= protect:
                d = 2
            else:
                taps = decim_stage(fs, 4, protect)
                if len(taps) > max_taps:
                    d = 2
        if d == 2:
            taps = decim_stage(fs, 2, protect)
        stages.append((taps, d))
        fs /= d
        rem //= d
    return stages


def rational_plan(fs_in: float, fs_out: float):
    """multirate/rational_resampler.h: the largest power-of-two
    predecimation that keeps the rate whole, then interp/decim reduced by
    their gcd with a Nuttall low-pass prototype (cutoff min(in, out)/2,
    transition a tenth of it) scaled by interp → (stages, poly|None)."""
    p = 0
    if fs_in > fs_out:
        p = min(int(math.floor(math.log2(fs_in / fs_out))), 13)
    while p > 0 and fs_in / (1 << p) != round(fs_in / (1 << p)):
        p -= 1
    stages = power_decim_plan(fs_in, 1 << p) if p > 0 else []
    int_sr = fs_in / (1 << p)
    g = math.gcd(round(int_sr), round(fs_out))
    interp, decim = round(fs_out) // g, round(int_sr) // g
    poly = None
    if interp != decim:
        bw = min(fs_in, fs_out) / 2.0
        poly = (interp, decim,
                low_pass(bw, bw * 0.1, int_sr * interp) * interp)
    return stages, poly


# ------------------------------------------------ streaming operations


def fir(x, taps, d: int = 1):
    """y[i] = Σ_k X[i·d + k]·taps[k], X = (K−1 zeros, x): SDR++'s
    correlation with its history buffer zeroed."""
    y = sps.oaconvolve(x, np.asarray(taps)[::-1])[:len(x)]
    return y[::d]


def polyphase(x, interp: int, decim: int, proto):
    """multirate/polyphase_resampler.h: output o takes phase
    (o·decim) mod interp of the reversed-phase bank at input offset
    ⌊o·decim/interp⌋ — the textbook upsample-filter-downsample with the
    zero-padded prototype reversed."""
    tpp = -(-len(proto) // interp)
    r = np.pad(np.asarray(proto), (0, tpp * interp - len(proto)))[::-1]
    n_out = len(x) * interp // decim
    return sps.upfirdn(r, x, interp, decim)[:n_out]


def mix(x, freq_hz: float, fs: float, n0: int):
    """x · exp(j·2π·f·n/fs) at absolute indices n, phase exact."""
    n = np.arange(n0, n0 + len(x), dtype=np.int64)
    ph = np.mod(np.int64(round(freq_hz)) * n, np.int64(round(fs)))
    return x * np.exp(2j * np.pi * ph / fs)


def quadrature(x, deviation_hz: float, fs: float):
    """demod/quadrature.h: wrapped phase step over the deviation; the
    carried previous sample starts at 1+0j; a zero product gives 0."""
    ext = np.concatenate([[1.0 + 0j], x])
    d = ext[1:] * np.conj(ext[:-1])
    y = np.where(d == 0, 0.0, np.angle(d))
    return y / (2.0 * np.pi * deviation_hz / fs)


def delay(x, d: int):
    return np.concatenate([np.zeros(d, x.dtype), x[:len(x) - d]])


def one_pole(x, alpha: float):
    """y[n] = α·x[n] + (1−α)·y[n−1], y[−1] = 0."""
    return sps.lfilter([alpha], [1.0, -(1.0 - alpha)], x)


def dc_block(x, rate: float):
    """correction/dc_blocker.h: out = x − offset; offset tracks x."""
    o = one_pole(x, rate)
    return x - np.concatenate([[0.0], o[:-1]])


def agc_gain(x, attack: float, decay: float, n0: int, set_point=1.0,
             max_gain=10e6, ramp_len=4800):
    """loop/agc.h: attack/decay envelope follower of |x|, gain
    min(set_point/amp, max_gain), times the start ramp over the first
    ``ramp_len`` samples of the stream."""
    amp = set_point
    g = np.ones(len(x))
    for i, ia in enumerate(np.abs(x).tolist()):
        if ia != 0.0:
            a = attack if ia > amp else decay
            amp = amp * (1.0 - a) + ia * a
            g[i] = min(set_point / amp, max_gain)
    ramp = np.minimum((n0 + np.arange(len(x))) / ramp_len, 1.0)
    return g * ramp


def squelch(x, block: int, level_db: float):
    """noise_reduction/squelch.h, per pump block: zero a block whose
    mean magnitude is below ``level_db``."""
    xb = x.reshape(-1, block)
    mean = np.mean(np.abs(xb), axis=-1)
    keep = 10.0 * np.log10(np.maximum(mean, 1e-20)) >= level_db
    return (xb * keep[:, None]).reshape(-1)


# ------------------------------------------------ the receiver


def spectrum_line(frame, fft_size: int, nq: Numerics):
    """iq_frontend.cpp: symmetric Nuttall window with the (−1)^i
    centring, zero padding, |X|²/N² in dB (floor −300 dB)."""
    nz = len(frame)
    i = np.arange(nz)
    w = nuttall(i, nz - 1) * np.where(i % 2 == 1, -1.0, 1.0)
    xw = np.zeros(fft_size, np.complex128)
    xw[:nz] = nq.q(frame) * nq.q(w)
    p = np.abs(np.fft.fft(xw)) ** 2 / float(fft_size) ** 2
    return 10.0 * np.log10(np.maximum(p, 1e-30))


def vfo(x, n0, fs, offset, bw, if_rate, nq: Numerics):
    """channel/rx_vfo.h: translate by −offset, resample to the IF rate,
    band-limit to the radio's bandwidth."""
    y = mix(nq.q(x), -offset, fs, n0)
    stages, poly = rational_plan(fs, if_rate)
    for taps, d in stages:
        y = fir(nq.q(y), nq.q(taps), d)
    if poly is not None:
        y = polyphase(nq.q(y), poly[0], poly[1], nq.q(poly[2]))
    if bw != if_rate:
        y = fir(nq.q(y), nq.q(low_pass(bw / 2.0, bw / 20.0, if_rate)))
    return y


def wfm(y, mode: dict, audio_sr: float, nq: Numerics):
    """demod/broadcast_fm.h, stereo, as the program runs it → [2, T]."""
    fs = float(mode["if_rate"])
    mpx = quadrature(nq.q(y), mode["deviation_hz"], fs)
    protect, md = 53500.0, 4          # L−R top 38k + 15k; MPX decim 4
    while md > 1 and fs / md <= 2.0 * protect * 1.02:
        md //= 2
    while md > 1:
        mpx = fir(nq.q(mpx), nq.q(decim_stage(fs, 2, protect)), 2)
        fs /= 2.0
        md //= 2
    pilot_taps = band_pass_complex(18750.0, 19250.0, 3000.0, fs)
    pilot = fir(nq.q(mpx), nq.q(pilot_taps))
    vco = delay(pilot / np.maximum(np.abs(pilot), 1e-12), 1)
    w19 = 2.0 * np.pi * mode["pilot_hz"] / fs
    vco = vco * np.exp(-1j * w19 * len(pilot_taps) / 2.0)
    d = (len(pilot_taps) - 1) // 2 + 1
    lpr = delay(nq.q(mpx), d)
    lmr = 2.0 * np.real(lpr * np.conj(nq.q(vco)) ** 2)
    g = math.gcd(int(audio_sr), int(fs))
    interp, decim = int(audio_sr) // g, int(fs) // g
    proto = low_pass(mode["audio_lpf_hz"], mode["audio_lpf_trans_hz"],
                     fs * interp) * interp
    dt = 1.0 / audio_sr
    alpha = dt / (mode["deemphasis_us"] * 1e-6 + dt)
    return np.stack([one_pole(polyphase(nq.q(s), interp, decim,
                                        nq.q(proto)), alpha)
                     for s in (lpr + lmr, lpr - lmr)])


def nfm(y, mode: dict, nq: Numerics):
    """demod/fm.h: discriminator (deviation bw/2) then a low-pass at
    bw/2."""
    fs, bw = float(mode["if_rate"]), float(mode["bandwidth"])
    a = quadrature(nq.q(y), bw / 2.0, fs)
    return fir(nq.q(a), nq.q(low_pass(bw / 2.0, bw / 20.0, fs)))


def am(y, mode: dict, n0_if: int, nq: Numerics):
    """demod/am.h with audio AGC: envelope, DC block, AGC, low-pass."""
    fs, bw = float(mode["if_rate"]), float(mode["bandwidth"])
    env = dc_block(np.abs(nq.q(y)), mode["dc_rate_hz"] / fs)
    env = nq.q(env)
    env = env * agc_gain(env, mode["agc_attack_hz"] / fs,
                         mode["agc_decay_hz"] / fs, n0_if)
    return fir(nq.q(env), nq.q(low_pass(bw / 2.0, bw / 20.0, fs)))


def usb(y, mode: dict, n0_if: int, nq: Numerics):
    """demod/ssb.h: shift up by bw/2, real part, AGC. Returns the
    in-phase output and its quadrature twin (the imaginary part under
    the same gain), since a product detector leaves the carrier phase
    undefined."""
    fs, bw = float(mode["if_rate"]), float(mode["bandwidth"])
    z = mix(nq.q(y), bw / 2.0, fs, n0_if)
    g = agc_gain(np.real(z), mode["agc_attack_hz"] / fs,
                 mode["agc_decay_hz"] / fs, n0_if)
    return np.real(z) * g, np.imag(z) * g


def af(a, fs_in: float, audio_sr: float, nq: Numerics):
    """The radio's AF resampler to the audio rate (mono)."""
    stages, poly = rational_plan(fs_in, audio_sr)
    for taps, d in stages:
        a = fir(nq.q(a), nq.q(taps), d)
    if poly is not None:
        a = polyphase(nq.q(a), poly[0], poly[1], nq.q(poly[2]))
    return a


def radio(x, n0: int, block: int, config: dict, demod: str,
          offset: float, nq: Numerics):
    """Audio of one radio module for the stream ``x`` starting at
    absolute sample ``n0`` (a multiple of the pump ``block``):
    [2, T] float64, or for USB [2, 2, T] (in-phase, quadrature)."""
    fs = float(config["samplerate"])
    audio_sr = float(config["audio_samplerate"])
    mode = config["demods"][demod]
    if_rate = float(mode["if_rate"])
    y = vfo(x, n0, fs, offset, float(mode["bandwidth"]), if_rate, nq)
    y = squelch(y, int(block * if_rate / fs), config["squelch_level"])
    n0_if = int(n0 * if_rate / fs)
    if demod == "WFM":
        return wfm(y, mode, audio_sr, nq)
    if demod == "NFM":
        a = af(nfm(y, mode, nq), if_rate, audio_sr, nq)
    elif demod == "AM":
        a = af(am(y, mode, n0_if, nq), if_rate, audio_sr, nq)
    elif demod == "USB":
        i, q = usb(y, mode, n0_if, nq)
        a = np.stack([af(i, if_rate, audio_sr, nq),
                      af(q, if_rate, audio_sr, nq)])
        return np.stack([a, a], axis=1)
    else:
        raise ValueError(f"no reference for demod {demod}")
    return np.stack([a, a])
