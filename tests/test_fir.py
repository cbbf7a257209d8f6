"""FIR / decimating FIR kernels vs a numpy oracle implementing the
reference's exact indexing (reference: core/src/dsp/filter/fir.h:64-92)."""
import numpy as np
import jax.numpy as jnp

from sdrplusplusbrown_tpu.ops.fir import FIR, RealFIR, correlate


def ref_fir(x, taps, decim=1, history=None):
    """out[i] = sum_k ext[i*decim + k] * taps[k], ext = [history, x]."""
    K = len(taps)
    if history is None:
        history = np.zeros(K - 1, dtype=x.dtype)
    ext = np.concatenate([history, x])
    n_out = len(x) // decim
    out = np.array([np.dot(ext[i * decim:i * decim + K], taps)
                    for i in range(n_out)])
    return out, ext[len(ext) - (K - 1):] if K > 1 else history


def test_correlate_real(rng):
    x = rng.standard_normal(256).astype(np.float32)
    h = rng.standard_normal(31)
    got = np.asarray(correlate(jnp.asarray(x), h))
    want = np.correlate(x, h.astype(np.float32), mode="valid")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_fir_streaming_equals_oracle(rng):
    h = rng.standard_normal(33)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)) \
        .astype(np.complex64)
    blk = FIR(h)
    st = blk.init_state()
    outs = []
    hist = None
    for i in range(0, 1024, 256):
        seg = x[i:i + 256]
        y, st = blk.apply(None, st, jnp.asarray(seg))
        want, hist = ref_fir(seg, h.astype(np.complex64), 1, hist)
        np.testing.assert_allclose(np.asarray(y), want, rtol=2e-4, atol=1e-4)
        outs.append(np.asarray(y))
    # streaming == one-shot
    y_all, _ = blk.apply(None, blk.init_state(), jnp.asarray(x))
    np.testing.assert_allclose(np.concatenate(outs), np.asarray(y_all),
                               rtol=2e-4, atol=1e-4)


def test_decimating_fir(rng):
    h = rng.standard_normal(21)
    x = (rng.standard_normal(512) + 1j * rng.standard_normal(512)) \
        .astype(np.complex64)
    blk = FIR(h, decim=4)
    y, _ = blk.apply(None, blk.init_state(), jnp.asarray(x))
    want, _ = ref_fir(x, h.astype(np.complex64), 4)
    assert y.shape[-1] == 128
    np.testing.assert_allclose(np.asarray(y), want, rtol=2e-4, atol=1e-4)


def test_fir_complex_taps(rng):
    h = (rng.standard_normal(17) + 1j * rng.standard_normal(17))
    x = (rng.standard_normal(256) + 1j * rng.standard_normal(256)) \
        .astype(np.complex64)
    blk = FIR(h)
    y, _ = blk.apply(None, blk.init_state(), jnp.asarray(x))
    want, _ = ref_fir(x, h.astype(np.complex64))
    np.testing.assert_allclose(np.asarray(y), want, rtol=3e-4, atol=1e-4)


def test_fir_batched(rng):
    h = rng.standard_normal(15)
    x = (rng.standard_normal((8, 256)) + 1j * rng.standard_normal((8, 256))) \
        .astype(np.complex64)
    blk = FIR(h)
    y, st = blk.apply(None, blk.init_state((8,)), jnp.asarray(x))
    assert y.shape == (8, 256)
    assert st.shape == (8, 14)
    for c in range(8):
        want, _ = ref_fir(x[c], h.astype(np.complex64))
        np.testing.assert_allclose(np.asarray(y[c]), want, rtol=2e-4, atol=1e-4)


def test_real_fir_audio(rng):
    h = rng.standard_normal(63)
    x = rng.standard_normal(480).astype(np.float32)
    blk = RealFIR(h)
    y, _ = blk.apply(None, blk.init_state(), jnp.asarray(x))
    want, _ = ref_fir(x, h.astype(np.float32))
    np.testing.assert_allclose(np.asarray(y), want, rtol=2e-4, atol=1e-4)


def test_fir_backends_agree(rng):
    """The toeplitz (banded matmul) lowering must match the conv path
    for stride-1 real-tap filtering."""
    import jax.numpy as jnp
    from sdrplusplusbrown_tpu.ops import fir as fir_mod
    K = 129
    taps = rng.standard_normal(K).astype(np.float32)
    x = (rng.standard_normal((2, 2000 + K - 1))
         + 1j * rng.standard_normal((2, 2000 + K - 1))
         ).astype(np.complex64)
    try:
        fir_mod.set_fir_backend("conv")
        ref = np.asarray(fir_mod.correlate(jnp.asarray(x), taps))
        fir_mod.set_fir_backend("toeplitz")
        toep = np.asarray(fir_mod.correlate(jnp.asarray(x), taps))
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.max(np.abs(toep - ref)) < 2e-3 * scale
        # decimating path still takes the conv route and stays correct
        y2 = np.asarray(fir_mod.correlate(jnp.asarray(x), taps, stride=2))
        np.testing.assert_allclose(y2, ref[..., ::2], rtol=1e-4,
                                   atol=2e-3 * scale)
    finally:
        fir_mod.set_fir_backend("conv")
