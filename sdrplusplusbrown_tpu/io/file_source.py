"""File source: WAV IQ playback in fixed-size blocks.

reference: source_modules/file_source/src/main.cpp — reads the capture in
SR/200-sample (≈5 ms) blocks on a worker thread, converts int16→float,
optionally loops.  Here the source is a host-side iterator producing
granularity-aligned numpy blocks for the jitted pipeline; real-time pacing
(the reference sleeps to simulate the antenna) is optional since the
runs faster than real time.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np

from .wav import read_wav_iq, parse_capture_filename


class FileSource:
    def __init__(self, path: str, block_len: Optional[int] = None,
                 loop: bool = False, realtime: bool = False,
                 use_native: bool = True):
        self.path = path
        self.native = None
        if use_native:
            try:
                from ..native import NativeWavReader, available
                if available():
                    self.native = NativeWavReader(path)
            except (OSError, RuntimeError):
                self.native = None
        if self.native is not None:
            self.samplerate = self.native.samplerate
            self.data = self.native.read(0, self.native.frames)
        else:
            self.data, self.samplerate = read_wav_iq(path)
        self.center_freq, self.capture_time = parse_capture_filename(path)
        # reference default block: SR/200 (main.cpp:399)
        self.block_len = int(block_len or round(self.samplerate / 200))
        self.loop = loop
        self.realtime = realtime

    def __len__(self):
        return len(self.data)

    def blocks(self) -> Iterator[np.ndarray]:
        """Yield fixed-size blocks (zero-padded at the tail)."""
        B = self.block_len
        t0 = time.monotonic()
        emitted = 0
        while True:
            for i in range(0, len(self.data), B):
                blk = self.data[i:i + B]
                if len(blk) < B:
                    blk = np.pad(blk, (0, B - len(blk)))
                if self.realtime:
                    due = t0 + emitted / self.samplerate
                    now = time.monotonic()
                    if due > now:
                        time.sleep(due - now)
                emitted += B
                yield blk
            if not self.loop:
                return
