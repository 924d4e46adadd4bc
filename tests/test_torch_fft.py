"""The port's complex FFT tier (ops/fft.py) on the CPU: the golden vector
of tests/test_fft.py, and a seeded 64-point signal against the JAX
package's dft / fft / fft_recursive.  Tolerance atol=1e-3: complex64
butterflies and sums round in another order than the JAX package's."""

import numpy as np
import pytest
import torch

from zk_stark_tpu.ops import fft as JFFT
from zk_stark_tpu_torch.ops import fft as FFT

SIGNAL = [1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0]
CORRECT = [(4.000, 0.000), (1.000, -2.414), (0.000, 0.000), (1.000, -0.414),
           (0.000, 0.000), (1.000, 0.414), (0.000, 0.000), (1.000, 2.414)]


def _fns():
    return {
        "dft": lambda x: FFT.dft(np.real(x), device="cpu"),
        "fft": lambda x: FFT.fft(x, device="cpu"),
        "fft_recursive": FFT.fft_recursive,
    }


@pytest.mark.parametrize("name", ["dft", "fft", "fft_recursive"])
def test_golden_vector(name):
    freqs = _fns()[name]([complex(v) for v in SIGNAL])
    assert freqs.dtype == np.complex64
    # round(x, 3) + 0.0 normalises negative zero, as tests/test_fft.py does
    got = [(round(float(f.real), 3) + 0.0, round(float(f.imag), 3) + 0.0) for f in freqs]
    assert got == CORRECT


@pytest.mark.parametrize("name", ["dft", "fft", "fft_recursive"])
def test_random_signal_matches_jax(name):
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    got = _fns()[name](x.astype(np.complex64))
    want = getattr(JFFT, name)(x if name == "dft" else x.astype(np.complex64))
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got, np.fft.fft(x), atol=1e-3)


def test_fft_pads_to_a_power_of_two():
    x = np.arange(5, dtype=np.complex64)
    np.testing.assert_allclose(FFT.fft(x, device="cpu"), np.fft.fft(np.pad(x, (0, 3))), atol=1e-3)
    assert FFT.fft([3.0], device="cpu").tolist() == [3.0]


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FFT.fft(SIGNAL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FFT.dft(SIGNAL)
