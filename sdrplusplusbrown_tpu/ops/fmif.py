"""FM IF noise reduction — per-sample sliding-window spectral max gate.

reference: core/src/dsp/noise_reduction/fm_if.h:45-77: for every input sample
a Nuttall-windowed ``bins``-point FFT of the trailing window is taken, only
the strongest bin is kept, and the output is the centre tap of the
(unnormalised) inverse FFT: out[n] = X_n[k*] · (−1)^{k*}.

Naively this is T sequential FFTs; here we reformulate as one batched
matmul: all T sliding frames form a [T, bins] matrix (gather), the DFT is a
[bins, bins] matrix, and the whole op is frames·window @ DFTᵀ,
followed by an argmax-select per row.  No serial dependency at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..runtime.block import Block
from . import windows


class FMIF(Block):
    def __init__(self, bins: int = 32):
        self.bins = int(bins)
        # reference initBuffers: fftWin[i] = nuttall(i, bins-1)
        self.win = windows.fft_window("nuttall", self.bins).astype(np.float32)
        k = np.arange(self.bins)
        n = np.arange(self.bins)
        self.dft = np.exp(-2j * np.pi * np.outer(k, n) / self.bins) \
            .astype(np.complex64)
        self.sign = ((-1.0) ** k).astype(np.float32)

    def init_state(self, batch_shape=()):
        return jnp.zeros(batch_shape + (self.bins - 1,), jnp.complex64)

    def apply(self, params, state, x):
        T = x.shape[-1]
        B = self.bins
        ext = jnp.concatenate([state, x], axis=-1)            # [..., T+B-1]
        idx = jnp.arange(T)[:, None] + jnp.arange(B)[None, :]  # [T, B]
        frames = ext[..., idx]                                 # [..., T, B]
        frames = frames * jnp.asarray(self.win)
        spec = frames @ jnp.asarray(self.dft).T                # [..., T, B]
        mag = jnp.abs(spec)
        k_star = jnp.argmax(mag, axis=-1)                      # [..., T]
        sel = jnp.take_along_axis(spec, k_star[..., None], axis=-1)[..., 0]
        sign = jnp.asarray(self.sign)[k_star]
        y = sel * sign
        return y, ext[..., T:]
