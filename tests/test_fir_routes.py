"""The three FIR lowerings (ops/fir.py: conv, toeplitz, fft) against a
float64 numpy oracle of the reference's indexing, across tap length,
decimation, batch shape and real/complex data and taps; and the
backend selector's rules."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdrplusplusbrown_tpu.ops import fir as fir_mod

ROUTES = ("conv", "toeplitz", "fft")
# (x complex, taps complex): complex data through real and complex taps,
# and the real audio path
KINDS = [(True, False), (True, True), (False, False)]


def oracle(x, taps, stride):
    """out[..., i] = Σ_k x[..., i·stride + k]·taps[k] in float64."""
    K = taps.shape[-1]
    M = (x.shape[-1] - K) // stride + 1
    idx = np.arange(M)[:, None] * stride + np.arange(K)[None, :]
    return (x.astype(np.complex128)[..., idx] * taps).sum(-1)


@pytest.fixture
def route():
    prev = fir_mod.get_fir_backend()
    yield fir_mod.set_fir_backend
    fir_mod.set_fir_backend(prev)


def _case(rng, lead, K, stride, x_c, h_c, M=512):
    W = M * stride + K - 1
    x = rng.standard_normal(lead + (W,))
    if x_c:
        x = x + 1j * rng.standard_normal(lead + (W,))
    h = np.hanning(K + 2)[1:-1] * np.cos(0.07 * np.arange(K))
    if h_c:
        h = h * np.exp(1j * 0.3 * np.arange(K))
    return (x.astype(np.complex64 if x_c else np.float32),
            h.astype(np.complex64 if h_c else np.float32))


@pytest.mark.parametrize("x_c,h_c", KINDS)
@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("K", [17, 129, 633])
@pytest.mark.parametrize("name", ROUTES)
def test_route_matches_float64_oracle(rng, route, name, K, stride, x_c,
                                      h_c):
    x, h = _case(rng, (3,), K, stride, x_c, h_c)
    route(name)
    got = np.asarray(fir_mod.correlate(jnp.asarray(x), h, stride=stride))
    want = oracle(x, h.astype(np.complex128), stride)
    if not (x_c or h_c):
        want = want.real
        assert got.dtype == np.float32
    else:
        assert got.dtype == np.complex64
    assert got.shape == want.shape
    # float32 accumulation over K taps of unit-variance data
    tol = 2e-5 * np.sqrt(K) * np.abs(want).max()
    assert np.abs(got - want).max() < tol


@pytest.mark.parametrize("lead", [(), (2, 3)])
@pytest.mark.parametrize("name", ROUTES)
def test_route_batch_shapes(rng, route, name, lead):
    x, h = _case(rng, lead, 31, 2, True, False, M=300)
    route(name)
    got = np.asarray(fir_mod.correlate(jnp.asarray(x), h, stride=2))
    want = oracle(x, h.astype(np.complex128), 2)
    assert got.shape == lead + (300,)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_auto_is_conv_on_cpu(rng, route):
    x, h = _case(rng, (2,), 65, 2, True, False)
    route("conv")
    conv = np.asarray(fir_mod.correlate(jnp.asarray(x), h, stride=2))
    route("auto")
    auto = np.asarray(fir_mod.correlate(jnp.asarray(x), h, stride=2))
    np.testing.assert_array_equal(auto, conv)


def test_auto_is_toeplitz_on_gpu(rng, route, monkeypatch):
    """The rule measured on the H100: ``auto`` takes the banded matmul
    when the default backend is a GPU (checked here by faking the
    backend's name; the arithmetic itself runs on the CPU)."""
    x, h = _case(rng, (2,), 65, 1, True, False)
    want = np.asarray(fir_mod._correlate_toeplitz(jnp.asarray(x), h))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    route("auto")
    got = np.asarray(fir_mod.correlate(jnp.asarray(x), h))
    np.testing.assert_array_equal(got, want)


def test_traced_taps_take_conv(route):
    """Taps that are traced values cannot build a host tap band or a
    host FFT, so every route falls back to the conv lowering."""
    route("toeplitz")
    x = jnp.ones((4, 100), jnp.float32)
    f = jax.jit(lambda x, h: fir_mod.correlate(x, h))
    y = f(x, jnp.ones((5,), jnp.float32))
    np.testing.assert_allclose(np.asarray(y), 5.0, rtol=1e-6)


def test_unknown_backend_rejected(route):
    with pytest.raises(ValueError):
        route("pallas")
    assert fir_mod.get_fir_backend() in fir_mod.FIR_BACKENDS


def test_toeplitz_band_structure():
    H = fir_mod._toeplitz_matrix(np.array([1.0, 2.0, 3.0], np.float32),
                                 tile=4, stride=2)
    assert H.shape == (4 * 2 + 2, 4)
    np.testing.assert_array_equal(H[:, 1], [0, 0, 1, 2, 3, 0, 0, 0, 0, 0])
