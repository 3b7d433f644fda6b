"""span_gain: the port's plain PyTorch version (what the wrapper runs on CPU
tensors) against the JAX package's numpy oracle and its Pallas kernel in
interpret mode, on the same seeded uint64 words.  Integer popcounts, so
every comparison is exact."""

import numpy as np
import pytest
import torch

from repro.kernels.span_gain.ops import span_gains as ref_span_gains
from repro_torch.kernels.span_gain.ops import span_gains, span_gains_plain

jax = pytest.importorskip("jax")

ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _words(A, N, W, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**64, size=(A, N, W), dtype=np.uint64)
    rem = rng.integers(0, 2**64, size=(A, W), dtype=np.uint64)
    # all-ones words exercise the sign bit of the int64 view
    codes[0, 0, :] = ALL_ONES
    codes[-1, -1, -1] = ALL_ONES
    rem[0, :] = ALL_ONES
    return codes, rem


def _port(codes, rem):
    c = torch.from_numpy(codes.view(np.int64))
    r = torch.from_numpy(rem.view(np.int64))
    got = span_gains(c, r)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), span_gains_plain(c, r).numpy())
    return got.numpy().astype(np.int64)


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("N", [12, 35, 64, 256])
@pytest.mark.parametrize("A", [1, 7, 33])
def test_plain_matches_reference(A, N, W):
    codes, rem = _words(A, N, W, seed=A * 1000 + N * 10 + W)
    got = _port(codes, rem)
    np.testing.assert_array_equal(got, ref_span_gains(codes, rem,
                                                      force="numpy"))
    np.testing.assert_array_equal(got, ref_span_gains(codes, rem,
                                                      force="interpret"))


def test_zero_rem_and_full_words():
    codes = np.full((4, 3, 2), ALL_ONES, dtype=np.uint64)
    rem = np.zeros((4, 2), dtype=np.uint64)
    assert (_port(codes, rem) == 0).all()
    rem[:] = ALL_ONES
    assert (_port(codes, rem) == 128).all()


def test_cpu_tensors_never_launch_the_kernel():
    before = span_gains.launches
    codes, rem = _words(5, 7, 2, seed=1)
    _port(codes, rem)
    assert span_gains.launches == before


def test_wrapper_rejects_bad_inputs():
    c = torch.zeros((2, 3, 1), dtype=torch.int64)
    with pytest.raises(TypeError):
        span_gains(c.int(), torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        span_gains(c, torch.zeros((2, 2), dtype=torch.int64))

