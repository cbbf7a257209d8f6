"""Overlap-save block FIR filtering (and decimating FIR).

Vectorized replacement for the reference's per-sample VOLK dot-product FIRs
(reference: core/src/dsp/filter/fir.h:64-92, filter/decimating_fir.h:45-68).
The reference keeps ``taps-1`` history samples at the head of a ring buffer
and runs one SIMD dot product per output sample; we keep the same history as
explicit carried state and compute the whole block as one strided
correlation:

    y[..., i] = sum_k ext[..., i*decim + k] * taps[k]
    ext       = concat(state, x)          # state = last taps-1 inputs

which matches the reference's indexing exactly (out[i] = dot(&buffer[i*decim],
taps) with buffer[0:taps-1] = history), so impulse responses, group delay and
fractional alignment are bit-compatible in exact arithmetic.

Three lowerings of the same correlation, chosen by ``set_fir_backend``:

* ``conv``     — ``lax.conv_general_dilated``; complex data and taps become
  a 2x2 real mixing matrix in the conv feature dimension.
* ``toeplitz`` — a banded-Toeplitz matmul: windows of ``tile*stride+K-1``
  inputs times a [tile*stride+K-1, tile] tap band.
* ``fft``      — frequency-domain overlap-save over the whole block (one
  FFT of the block, one of the taps, one inverse), decimated after.

``auto`` (the default) picks ``toeplitz`` on a GPU and ``conv`` elsewhere.
On the H100 the banded matmul beat cuDNN's one- and two-channel
convolutions in every benchmark cell (PERF.md), and the CPU keeps the
conv lowering the test suite's numerics were set on.
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..runtime.block import Block

_DN = jax.lax.ConvDimensionNumbers(
    lhs_spec=(0, 1, 2),   # N C W
    rhs_spec=(0, 1, 2),   # O I W
    out_spec=(0, 1, 2))   # N C W

FIR_BACKENDS = ("auto", "conv", "toeplitz", "fft")
_FIR_BACKEND = "auto"
_TOEPLITZ_TILE = 512


def set_fir_backend(name: str):
    global _FIR_BACKEND
    if name not in FIR_BACKENDS:
        raise ValueError(f"FIR backend {name!r} not in {FIR_BACKENDS}")
    _FIR_BACKEND = name


def get_fir_backend() -> str:
    return _FIR_BACKEND


def _toeplitz_matrix(taps: np.ndarray, tile: int,
                     stride: int = 1) -> np.ndarray:
    """[tile*stride + K - 1, tile] band: column j holds the taps at rows
    j*stride .. j*stride+K-1."""
    K = len(taps)
    H = np.zeros((tile * stride + K - 1, tile), taps.dtype)
    for j in range(tile):
        H[j * stride:j * stride + K, j] = taps
    return H


def _correlate_toeplitz(x: jnp.ndarray, taps: np.ndarray,
                        stride: int = 1) -> jnp.ndarray:
    """Strided correlation as a banded-Toeplitz matmul."""
    taps = np.asarray(taps)
    lead = x.shape[:-1]
    L = x.shape[-1]
    K = int(taps.shape[-1])
    M = (L - K) // stride + 1
    tile = _TOEPLITZ_TILE
    span = tile * stride
    cplx = jnp.iscomplexobj(x)
    xf = (jnp.concatenate([jnp.real(x).reshape(-1, L),
                           jnp.imag(x).reshape(-1, L)], axis=0)
          if cplx else x.reshape(-1, L)).astype(jnp.float32)
    rows = -(-M // tile)
    need = rows * span + K - 1
    if need > L:
        xf = jnp.pad(xf, ((0, 0), (0, need - L)))
    idx = (np.arange(rows)[:, None] * span
           + np.arange(span + K - 1)[None, :])
    w = xf[:, idx]                                    # [B, rows, span+K-1]
    if np.iscomplexobj(taps):
        H = np.concatenate(
            [_toeplitz_matrix(np.real(taps).astype(np.float32), tile,
                              stride),
             _toeplitz_matrix(np.imag(taps).astype(np.float32), tile,
                              stride)], axis=1)
    else:
        H = _toeplitz_matrix(taps.astype(np.float32), tile, stride)
    y = jnp.einsum("brw,wt->brt", w, jnp.asarray(H),
                   preferred_element_type=jnp.float32)
    n = y.shape[0]
    if np.iscomplexobj(taps):
        a = y[..., :tile].reshape(n, rows * tile)[:, :M]   # x * Re h
        b = y[..., tile:].reshape(n, rows * tile)[:, :M]   # x * Im h
        if cplx:
            h = n // 2
            out = jax.lax.complex(a[:h] - b[h:], b[:h] + a[h:])
        else:
            out = jax.lax.complex(a, b)
    else:
        y = y.reshape(n, rows * tile)[:, :M]
        out = jax.lax.complex(y[:n // 2], y[n // 2:]) if cplx else y
    return out.reshape(lead + (M,))


def _conv1d(x: jnp.ndarray, kernel: jnp.ndarray, stride: int,
            groups: int = 1) -> jnp.ndarray:
    """VALID strided correlation. x: [N, C, W], kernel: [O, C//groups, K]."""
    return jax.lax.conv_general_dilated(
        x, kernel, window_strides=(stride,), padding="VALID",
        dimension_numbers=_DN, feature_group_count=groups,
        preferred_element_type=jnp.float32)


def _correlate_fft(x: jnp.ndarray, taps, stride: int = 1) -> jnp.ndarray:
    """Correlation via one full-block FFT (frequency-domain overlap-save):
    out[i] = Σ_k x[i+k]·h[k] = ifft(fft(x)·fft(rev h)), sliced at the K−1
    group delay and decimated by ``stride``."""
    taps = np.asarray(taps)
    W = x.shape[-1]
    K = int(taps.shape[-1])
    M = (W - K) // stride + 1
    N = 1 << int(np.ceil(np.log2(W + K)))
    h_rev = taps[::-1]
    x_c = x.astype(jnp.complex64)
    H = jnp.fft.fft(jnp.asarray(h_rev, jnp.complex64), n=N)
    Y = jnp.fft.ifft(jnp.fft.fft(x_c, n=N, axis=-1) * H, axis=-1)
    out = Y[..., K - 1:K - 1 + (M - 1) * stride + 1:stride]
    if not jnp.iscomplexobj(x) and not np.iscomplexobj(taps):
        return jnp.real(out).astype(jnp.float32)
    return out.astype(jnp.complex64)


def _correlate_conv(x: jnp.ndarray, taps, stride: int) -> jnp.ndarray:
    lead = x.shape[:-1]
    W = x.shape[-1]
    K = taps.shape[-1]
    taps_c = np.iscomplexobj(taps) if isinstance(taps, np.ndarray) \
        else jnp.iscomplexobj(taps)
    if not jnp.iscomplexobj(x) and not taps_c:
        xf = x.reshape((-1, 1, W)).astype(jnp.float32)
        ker = jnp.asarray(taps, jnp.float32).reshape((1, 1, K))
        y = _conv1d(xf, ker, stride)
        return y.reshape(lead + (y.shape[-1],))

    # Complex path: features = (re, im).
    if jnp.iscomplexobj(x):
        xf = jnp.stack([jnp.real(x), jnp.imag(x)], axis=-2)  # [..., 2, W]
    else:
        xf = jnp.stack([x, jnp.zeros_like(x)], axis=-2)
    xf = xf.reshape((-1, 2, W)).astype(jnp.float32)

    if taps_c:
        hr = jnp.asarray(np.real(taps) if isinstance(taps, np.ndarray)
                         else jnp.real(taps), jnp.float32)
        hi = jnp.asarray(np.imag(taps) if isinstance(taps, np.ndarray)
                         else jnp.imag(taps), jnp.float32)
        # y_re = xr*hr - xi*hi ; y_im = xr*hi + xi*hr
        ker = jnp.stack([jnp.stack([hr, -hi]), jnp.stack([hi, hr])])  # [2,2,K]
        y = _conv1d(xf, ker, stride)                                 # [N,2,M]
    else:
        ker = jnp.asarray(taps, jnp.float32).reshape((1, 1, K))
        ker = jnp.broadcast_to(ker, (2, 1, K))
        y = _conv1d(xf, ker, stride, groups=2)
    out = jax.lax.complex(y[:, 0], y[:, 1])
    return out.reshape(lead + (out.shape[-1],))


def correlate(x: jnp.ndarray, taps: jnp.ndarray, stride: int = 1) -> jnp.ndarray:
    """out[..., i] = sum_k x[..., i*stride + k] * taps[k].

    ``x`` may be real float32 or complex64; ``taps`` real or complex numpy /
    jnp 1-D array.  Batched over all leading axes.  The ``toeplitz`` and
    ``fft`` routes need host (numpy) taps; traced taps always take
    ``conv``.
    """
    backend = _FIR_BACKEND
    if backend == "auto":
        backend = "toeplitz" if jax.default_backend() == "gpu" else "conv"
    if isinstance(taps, np.ndarray):
        if backend == "toeplitz":
            return _correlate_toeplitz(x, taps, stride)
        if backend == "fft":
            return _correlate_fft(x, taps, stride)
    return _correlate_conv(x, taps, stride)


class FIR(Block):
    """Stateful streaming FIR, optionally decimating.

    Equivalent of reference filter::FIR / filter::DecimatingFIR with the
    fractional offset pinned to zero by the static-granularity rule
    (in_multiple == decim ⇒ offset is invariant across blocks; see
    reference decimating_fir.h:62 for the carried offset this removes).
    """

    def __init__(self, taps: np.ndarray, decim: int = 1):
        taps = np.asarray(taps)
        self.taps = taps
        self.K = int(taps.shape[-1])
        self.decim = int(decim)
        self.ratio = Fraction(1, self.decim)
        self.in_multiple = self.decim
        self._complex_taps = bool(np.iscomplexobj(taps))

    def state_dtype(self, x_dtype=jnp.complex64):
        return x_dtype

    def init_state(self, batch_shape=(), dtype=jnp.complex64):
        if self.K == 1:
            return jnp.zeros(batch_shape + (0,), dtype)
        return jnp.zeros(batch_shape + (self.K - 1,), dtype)

    def apply(self, params, state, x):
        if self.K == 1 and not self._complex_taps and self.decim == 1:
            scale = float(np.real(self.taps[0]))
            return x * scale, state
        state = state.astype(x.dtype) if state.dtype != x.dtype else state
        ext = jnp.concatenate([state, x], axis=-1)
        y = correlate(ext, self.taps, stride=self.decim)
        new_state = ext[..., ext.shape[-1] - (self.K - 1):] if self.K > 1 \
            else state
        return y, new_state


class RealFIR(FIR):
    """FIR for real float32 streams (audio-path filters)."""

    def init_state(self, batch_shape=(), dtype=jnp.float32):
        return super().init_state(batch_shape, dtype)
