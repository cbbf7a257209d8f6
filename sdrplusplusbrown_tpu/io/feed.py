"""Host→device IQ feed with transfer thinning.

The host↔device link (PCIe) is the narrowest pipe in
a streaming deployment — exactly the role the reference's network link
plays, so the same compression ladder applies (reference:
core/src/server.cpp:99-140 — raw f32 | int8 PCM | lossy EFFT):

  * ``none``  — complex64 as-is (8 B/sample);
  * ``int8``  — host quantizes re/im to int8 + one f32 scale per block
    (2 B/sample, 4× thinner); the device dequantizes in-graph;
  * ``efft``  — host runs the EFFT masking (ops/efft.py) and ships the
    masked spectrum as int8 triples (index-free dense frames); the
    device re-expands the ∜ companding and inverse-FFTs in-graph
    (ops/efft_jax.efft_decompress_j).  Zero-heavy frames additionally
    shrink under the int8 entropy of the wire format.

The symmetric device→host direction (baseband produced on device,
thinned before fetch) uses ops/efft_jax.EFFTCompressorJax — the masking
runs ON the device so only masked int8 frames cross the link.

``stats()`` reports bytes actually moved vs raw bytes for the toggle's
bandwidth measurement.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.efft import EFFTCompressor
from ..ops.efft_jax import efft_decompress_j


def _dequant_int8(q: jnp.ndarray, scale: jnp.ndarray) -> jnp.ndarray:
    f = q.astype(jnp.float32) * (scale / 127.0)
    return jax.lax.complex(f[0::2], f[1::2])


class DeviceFeed:
    """Feed host IQ blocks to the device through a compression toggle."""

    def __init__(self, mode: str = "none",
                 samplerate: Optional[float] = None,
                 loss_rate: float = 4.0):
        assert mode in ("none", "int8", "efft"), mode
        self.mode = mode
        self.raw_bytes = 0
        self.moved_bytes = 0
        self._efft: Optional[EFFTCompressor] = None
        if mode == "efft":
            assert samplerate, "efft mode needs the samplerate"
            self._efft = EFFTCompressor(samplerate, loss_rate=loss_rate)
        self._dequant = jax.jit(_dequant_int8)
        self._defft = jax.jit(
            lambda q, scale: efft_decompress_j(
                _dequant_int8(q, scale).reshape(
                    -1, self._efft.fft_size)))

    def push(self, iq: np.ndarray) -> Optional[jax.Array]:
        """→ complex64 device array (or None while the EFFT queue
        primes).  Bandwidth accounting covers exactly what crossed the
        host→device boundary."""
        iq = np.asarray(iq, np.complex64)
        self.raw_bytes += iq.nbytes
        if self.mode == "none":
            self.moved_bytes += iq.nbytes
            return jnp.asarray(iq)
        if self.mode == "int8":
            inter = np.empty(iq.size * 2, np.float32)
            inter[0::2] = iq.real
            inter[1::2] = iq.imag
            scale = float(np.max(np.abs(inter))) or 1.0
            q = np.clip(np.round(inter / scale * 127.0),
                        -127, 127).astype(np.int8)
            self.moved_bytes += q.nbytes + 4
            return self._dequant(jnp.asarray(q), jnp.float32(scale))
        # efft: host-side masking, device-side expansion+iFFT
        frames = self._efft.process(iq)
        if not frames:
            return None
        spec = np.concatenate(frames)
        inter = np.empty(spec.size * 2, np.float32)
        inter[0::2] = spec.real
        inter[1::2] = spec.imag
        scale = float(np.max(np.abs(inter))) or 1.0
        q = np.clip(np.round(inter / scale * 127.0),
                    -127, 127).astype(np.int8)
        # the wire/entropy layer sends zero runs for free; count the
        # nonzero payload + a byte of run-length per zero run as moved
        nz = int(np.count_nonzero(q))
        runs = int(np.count_nonzero(np.diff((q == 0).astype(np.int8))))
        self.moved_bytes += nz + runs + 8
        return self._defft(jnp.asarray(q), jnp.float32(scale))

    def stats(self) -> dict:
        return {"mode": self.mode, "raw_bytes": self.raw_bytes,
                "moved_bytes": self.moved_bytes,
                "ratio": (self.moved_bytes / self.raw_bytes)
                if self.raw_bytes else 0.0}
