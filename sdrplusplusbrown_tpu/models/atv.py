"""Analog TV (PAL 625/25) decoder — amplitude video demod, line sync
PLL, field sync and frame assembly.

reference: decoder_modules/atv_decoder/src/ —
  * Amplitude demod: video = −|x| (negative modulation, amplitude.h:39-43)
    after a fast AGC;
  * LineSync (linesync.h): one output line = 945 pixels resampled at a
    NCO-stepped fractional position; the timing error is the mean
    difference between the two halves of the horizontal sync pulse
    (left = last 17 px + first 35 px, right = px 35..87), gains
    ω=1e-6 / µ=1.0, period clamped ±1e-4 (main.cpp:49, linesync.h:63-64);
    lock = the line minimum falls inside the sync region, with the
    fast-lock jump when unlocked (linesync.h:177-202);
  * per-line level servo: offset −= blank·1e-3, gain −= (blank − sync
    + 0.428)·1e-2 (main.cpp:130-161);
  * sync classification per line: short = syncL low, syncR+blank high;
    long = all low; 8-line 2-bit history 0b0101011010010101 → odd field,
    0b0001011010100101 → even field (main.cpp:163-167,241-244);
  * visible rows 34..609 map to a 768×576 grayscale image from pixels
    155..922 (main.cpp:219-233).

Device split: AGC + amplitude demod run jitted at 14.77 MS/s; the line
loop is per-line host numpy (vectorized across the 945 pixels of each
line — line rate is only 15 625 Hz).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

import jax.numpy as jnp

from ..runtime.block import Block
from ..ops.agc import AGC
from ..ops import taps as taps_mod
from ..ops.resampler import build_polyphase_bank

LINE_SIZE = 945
SAMPLE_RATE = 625.0 * LINE_SIZE * 25.0          # main.cpp:36
SYNC_LEN = 70
SYNC_SIDE_LEN = 17
SYNC_L_START = LINE_SIZE - SYNC_SIDE_LEN
SYNC_R_START = SYNC_LEN // 2
SYNC_R_END = SYNC_R_START + SYNC_LEN // 2 + SYNC_SIDE_LEN
SYNC_HALF_LEN = SYNC_LEN // 2 + SYNC_SIDE_LEN
EQUAL_LEN = 35
HBLANK_START, HBLANK_END = SYNC_LEN, 155
HBLANK_LEN = HBLANK_END - HBLANK_START + 1
SYNC_LEVEL = -0.428
MAX_LOCK = 1000
VISIBLE_X0, VISIBLE_W = 155, 768
VISIBLE_Y0, VISIBLE_H = 34, 576
SYNC_TO_ODD = 0b0101011010010101
SYNC_TO_EVEN = 0b0001011010100101


class AmplitudeDemod(Block):
    """video = −|x| (amplitude.h:39-43)."""

    def apply(self, params, state, x):
        return (-jnp.abs(x)).astype(jnp.float32), state


class ATVFrontEnd(Block):
    """AGC → amplitude demod (jitted per-sample stage)."""

    def __init__(self, agc_rate: float = 1e-4):
        self.agc = AGC(set_point=1.0, attack=agc_rate, decay=agc_rate,
                       max_gain=10e6)
        self.dem = AmplitudeDemod()

    def init_state(self, batch_shape=()):
        return self.agc.init_state(batch_shape)

    def apply(self, params, state, x):
        y, st = self.agc.apply(None, state, x)
        v, _ = self.dem.apply(None, None, y)
        return v, st


class LineSync:
    """Float video stream → locked 945-pixel lines (linesync.h)."""

    P, K = 128, 8

    def __init__(self, omega: float = 1.0, omega_gain: float = 1e-6,
                 mu_gain: float = 1.0, omega_rel_limit: float = 1e-4):
        proto = taps_mod.windowed_sinc(self.P * self.K,
                                       2.0 * np.pi * (0.5 / self.P),
                                       norm=self.P)
        self.bank = build_polyphase_bank(self.P, proto).astype(np.float32)
        self.omega_gain = float(omega_gain)
        self.mu_gain = float(mu_gain)
        self.pmin = omega * (1.0 - omega_rel_limit)
        self.pmax = omega * (1.0 + omega_rel_limit)
        self.period = float(omega)
        self.pos = 0.0            # absolute fractional read position
        self.consumed = 0         # samples dropped from the front
        self.buf = np.zeros(0, np.float32)
        self.locked = 0
        self.fast_lock = True
        self.lines_out = 0

    def _interp_line(self, start: float) -> Optional[np.ndarray]:
        pos = start + self.period * np.arange(LINE_SIZE)
        base = np.floor(pos).astype(np.int64) - self.consumed
        if base[-1] + self.K > len(self.buf):
            return None
        frac = pos - np.floor(pos)
        ph = np.clip((frac * self.P).astype(np.int64), 0, self.P - 1)
        win = self.buf[base[:, None] + np.arange(self.K)[None, :]]
        return np.einsum("ij,ij->i", win, self.bank[ph])

    def push(self, video: np.ndarray) -> List[np.ndarray]:
        self.buf = np.concatenate([self.buf,
                                   np.asarray(video, np.float32)])
        out = []
        while True:
            line = self._interp_line(self.pos)
            if line is None:
                break
            # timing error from the split sync pulse (linesync.h:124-144)
            left = (line[SYNC_L_START:].sum() + line[:SYNC_R_START].sum()
                    ) / SYNC_HALF_LEN
            right = line[SYNC_R_START:SYNC_R_END].sum() / SYNC_HALF_LEN
            error = float(left - right)
            self.period = float(np.clip(
                self.period + error * self.omega_gain,
                self.pmin, self.pmax))
            self.pos += LINE_SIZE * self.period + error * self.mu_gain
            # lock detection (linesync.h:176-202)
            lowest_id = int(np.argmin(line))
            line_locked = (lowest_id < SYNC_R_END
                           or lowest_id >= SYNC_L_START)
            if not line_locked and self.locked:
                self.locked -= 1
            elif line_locked and self.locked < MAX_LOCK:
                self.locked += 1
            if not self.locked and self.fast_lock:
                self.pos += lowest_id - SYNC_R_START
                self.locked = MAX_LOCK // 2
            out.append(line)
            self.lines_out += 1
        # drop consumed samples, keep a K-sample guard
        keep_from = int(np.floor(self.pos)) - self.consumed - 1
        if keep_from > 0:
            self.buf = self.buf[keep_from:]
            self.consumed += keep_from
        return out


class FrameAssembler:
    """Per-line level servo + field sync + 768×576 image assembly
    (main.cpp:130-282)."""

    def __init__(self):
        self.offset = 0.0
        self.gain = 1.0
        self.sync_history = 0
        self.ypos = 0
        self.vlock = 0
        self.image = np.zeros((VISIBLE_H, VISIBLE_W), np.uint8)
        self._work = np.zeros((VISIBLE_H, VISIBLE_W), np.uint8)
        self.frames = 0

    def push_line(self, line: np.ndarray):
        data = (np.asarray(line, np.float32) + self.offset) * self.gain
        syncL = float(np.mean(data[:EQUAL_LEN]))
        syncR = float(np.mean(data[EQUAL_LEN:SYNC_LEN]))
        sync_level = 0.5 * (syncL + syncR)
        blank = float(np.mean(data[HBLANK_START:HBLANK_END + 1]))
        self.offset -= (blank / self.gain) * 0.001
        self.offset = float(np.clip(self.offset, -1.0, 1.0))
        self.gain -= (blank - sync_level + SYNC_LEVEL) * 0.01
        self.gain = float(np.clip(self.gain, 0.1, 10.0))
        half = 0.5 * SYNC_LEVEL
        short_sync = int(syncL < half and syncR > half and blank > half)
        long_sync = int(syncL < half and syncR < half and blank < half)
        self.sync_history = ((self.sync_history << 2)
                             | (long_sync << 1) | short_sync) & 0xFFFF

        if VISIBLE_Y0 <= self.ypos <= VISIBLE_Y0 + VISIBLE_H - 1:
            px = np.clip(data[VISIBLE_X0:VISIBLE_X0 + VISIBLE_W]
                         * 255.0, 0, 255).astype(np.uint8)
            self._work[self.ypos - VISIBLE_Y0] = px

        roll_odd = self.ypos == 624
        roll_even = self.ypos == 623
        sync_odd = self.sync_history == SYNC_TO_ODD
        sync_even = self.sync_history == SYNC_TO_EVEN
        if roll_odd or sync_odd:
            disagree = roll_odd ^ sync_odd
            self.vlock = max(self.vlock - 1, 0) if disagree \
                else min(self.vlock + 1, 20)
            self.ypos = 1
        elif roll_even or sync_even:
            disagree = roll_even ^ sync_even
            self.vlock = max(self.vlock - 1, 0) if disagree \
                else min(self.vlock + 1, 20)
            self.ypos = 0
            self.image = self._work.copy()
            self.frames += 1
        else:
            self.ypos += 2


# ----------------------------------------------------------------------
# Test-signal generator

def make_line(kind: str = "normal",
              video: Optional[np.ndarray] = None) -> np.ndarray:
    """One 945-sample PAL line: 'normal' (sync+blank+video), 'short'
    (equalizing pulse), 'long' (broad pulse)."""
    ln = np.zeros(LINE_SIZE, np.float32)
    if kind == "normal":
        ln[:SYNC_LEN] = SYNC_LEVEL
        if video is not None:
            ln[VISIBLE_X0:VISIBLE_X0 + VISIBLE_W] = video
    elif kind == "short":
        ln[:EQUAL_LEN] = SYNC_LEVEL
    elif kind == "long":
        ln[:HBLANK_END + 60] = SYNC_LEVEL
    return ln
