"""Port PQMF vs rave_tpu.ops.pqmf: identical filter design, analysis and
synthesis offline and streamed.  Tolerance atol 1e-5 (float32 sums in
another order; the round trip itself is ~60 dB SNR by construction)."""
import jax
import numpy as np
import pytest
import torch

import rave_tpu.ops.pqmf as jp
import rave_tpu_torch.ops.pqmf as tp
from rave_tpu.ops.conv import StreamSetup as JSS
from rave_tpu_torch.ops.conv import StreamSetup as TSS

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_filter_arrays_equal():
    for att, M in [(100.0, 16), (100.0, 8)]:
        a, b = jp._pqmf_kernels(att, M), tp._pqmf_kernels(att, M)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[2], b[2])
        assert a[1] == b[1] and a[3] == b[3]
    np.testing.assert_array_equal(jp.get_prototype(100.0, 16),
                                  tp.get_prototype(100.0, 16))


@pytest.mark.parametrize("parity", [0, 1])
def test_reverse_half(parity):
    y = np.random.default_rng(0).standard_normal((2, 9, 16)).astype(np.float32)
    want = np.asarray(jp.reverse_half(y, parity))
    got = tp.reverse_half(torch.from_numpy(y.transpose(0, 2, 1).copy()),
                          parity).numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(got, want)


def test_analysis_synthesis_offline():
    x = (np.random.default_rng(1).standard_normal((2, 4096, 1)) * 0.3
         ).astype(np.float32)
    jm = jp.PQMF(n_band=16)
    v = jm.init(jax.random.PRNGKey(0), x)
    bands = np.asarray(jm.apply(v, x))
    back = np.asarray(jm.apply(v, bands, method=jp.PQMF.inverse))
    tm = tp.PQMF(n_band=16)
    with torch.no_grad():
        tb = tm(torch.from_numpy(x))
        tback = tm.inverse(torch.from_numpy(bands.transpose(0, 2, 1).copy()))
    np.testing.assert_allclose(tb.numpy().transpose(0, 2, 1), bands, atol=ATOL)
    np.testing.assert_allclose(tback.numpy(), back, atol=ATOL)
    assert tm.delay_frames == jm.delay_frames
    assert tm.inverse_delay_frames == jm.inverse_delay_frames


@pytest.mark.parametrize("parity", [0, 1])
def test_streaming_chunks(parity):
    M, chunk = 16, 512
    x = (np.random.default_rng(2).standard_normal((1, 4096, 1)) * 0.3
         ).astype(np.float32)
    jm = jp.PQMF(n_band=M, inverse_parity=parity, ss=JSS(streaming=True))
    tm = tp.PQMF(n_band=M, inverse_parity=parity, ss=TSS(streaming=True))
    v = jm.init(jax.random.PRNGKey(0), x[:, :chunk])
    cache_f = jax.tree.map(np.zeros_like, v["cache"])  # init ran a chunk
    vi = jm.init(jax.random.PRNGKey(0), np.zeros((1, chunk // M, M),
                                                 np.float32),
                 method=jp.PQMF.inverse)
    cache_i = jax.tree.map(np.zeros_like, vi["cache"])
    with torch.no_grad():
        for i in range(0, x.shape[1], chunk):
            xc = x[:, i:i + chunk]
            b, upd = jm.apply({"cache": cache_f}, xc, mutable=["cache"])
            cache_f = upd["cache"]
            y, upd = jm.apply({"cache": cache_i}, b, method=jp.PQMF.inverse,
                              mutable=["cache"])
            cache_i = upd["cache"]
            tb = tm(torch.from_numpy(xc))
            ty = tm.inverse(tb)
            np.testing.assert_allclose(tb.numpy().transpose(0, 2, 1),
                                       np.asarray(b), atol=ATOL)
            np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=ATOL)
