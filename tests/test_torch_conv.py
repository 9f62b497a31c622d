"""Port conv engine vs rave_tpu.ops.conv, offline and streamed chunk by
chunk with carried caches.  Tolerance atol 1e-5 (float32 sums in another
order)."""
import jax
import numpy as np
import pytest
import torch

import rave_tpu.ops.conv as jc
import rave_tpu_torch.ops.conv as tc
from rave_tpu_torch.convert import load_conv_params

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32))


def _t(a):  # (B, T, C) numpy -> (B, C, T) torch
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


def _n(t):  # (B, C, T) torch -> (B, T, C) numpy
    return t.detach().numpy().transpose(0, 2, 1)


def _params(jmod, x):
    v = jmod.init(jax.random.PRNGKey(0), x)
    return jax.tree.map(np.asarray, v["params"])


@pytest.mark.parametrize("k,s,d,mode,wn,groups", [
    (3, 1, 1, "centered", True, 1),
    (3, 1, 9, "centered", True, 1),
    (7, 1, 1, "causal", True, 1),
    (8, 4, 1, "centered", True, 1),
    (4, 2, 1, "causal", False, 1),
    (1, 1, 1, "centered", True, 1),
    (3, 1, 3, "centered", False, 2),
])
def test_conv1d_offline(k, s, d, mode, wn, groups):
    ci, co = 6, 8
    x = _x((2, 64, ci))
    ss = jc.StreamSetup(mode=mode)
    jm = jc.Conv1d(features=co, kernel_size=k, stride=s, dilation=d,
                   groups=groups, weight_norm=wn, ss=ss)
    p = _params(jm, x)
    want = np.asarray(jm.apply({"params": p}, x))
    tm = tc.Conv1d(ci, co, k, stride=s, dilation=d, groups=groups,
                   weight_norm=wn, ss=tc.StreamSetup(mode=mode))
    assert len(load_conv_params(tm, p)) == len(list(tm.parameters()))
    got = _n(tm(_t(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("ratio,wn", [(2, True), (4, True), (4, False)])
def test_conv_transpose_offline(ratio, wn):
    ci, co = 8, 4
    x = _x((2, 16, ci), 1)
    jm = jc.ConvTranspose1d(features=co, kernel_size=2 * ratio, stride=ratio,
                            weight_norm=wn)
    p = _params(jm, x)
    want = np.asarray(jm.apply({"params": p}, x))
    tm = tc.ConvTranspose1d(ci, co, 2 * ratio, ratio, weight_norm=wn)
    load_conv_params(tm, p)
    got = _n(tm(_t(x)))
    assert got.shape == want.shape == (2, 16 * ratio, co)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _stream_both(jm, tm, x, chunk):
    """Run both modules chunk by chunk with carried caches; return the
    per-chunk outputs of each."""
    v = jm.init(jax.random.PRNGKey(0), x[:, :chunk])
    p = jax.tree.map(np.asarray, v.get("params", {}))
    if p:
        load_conv_params(tm, p)
    # init ran one chunk: start both from zero caches
    cache = jax.tree.map(np.zeros_like, v.get("cache", {}))
    outs_j, outs_t = [], []
    for i in range(0, x.shape[1], chunk):
        xc = x[:, i:i + chunk]
        y, upd = jm.apply({"params": p, "cache": cache}, xc,
                          mutable=["cache"])
        cache = upd["cache"]
        outs_j.append(np.asarray(y))
        outs_t.append(_n(tm(_t(xc))))
    return outs_j, outs_t


@pytest.mark.parametrize("k,s,d,mode,in_delay", [
    (3, 1, 1, "centered", 0),
    (3, 1, 9, "centered", 0),
    (8, 4, 1, "centered", 5),
    (4, 2, 1, "causal", 3),
    (7, 1, 1, "causal", 0),
])
def test_conv1d_streaming_chunks(k, s, d, mode, in_delay):
    ci, co, chunk = 4, 6, 16
    x = _x((2, 96, ci), 2)
    ss = jc.StreamSetup(mode=mode, streaming=True)
    jm = jc.Conv1d(features=co, kernel_size=k, stride=s, dilation=d,
                   weight_norm=True, in_delay=in_delay, ss=ss)
    tm = tc.Conv1d(ci, co, k, stride=s, dilation=d, weight_norm=True,
                   in_delay=in_delay,
                   ss=tc.StreamSetup(mode=mode, streaming=True))
    assert tm.plan.__dict__ == jm.plan.__dict__
    with torch.no_grad():
        outs_j, outs_t = _stream_both(jm, tm, x, chunk)
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_allclose(b, a, atol=ATOL)
    assert tm.cache.shape == (2, ci, tm.plan.cache_len)


@pytest.mark.parametrize("ratio", [2, 4])
def test_conv_transpose_streaming_chunks(ratio):
    ci, co, chunk = 6, 4, 8
    x = _x((1, 48, ci), 3)
    jm = jc.ConvTranspose1d(features=co, kernel_size=2 * ratio, stride=ratio,
                            weight_norm=True,
                            ss=jc.StreamSetup(streaming=True))
    tm = tc.ConvTranspose1d(ci, co, 2 * ratio, ratio, weight_norm=True,
                            ss=tc.StreamSetup(streaming=True))
    with torch.no_grad():
        outs_j, outs_t = _stream_both(jm, tm, x, chunk)
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_allclose(b, a, atol=ATOL)


@pytest.mark.parametrize("frames,streaming", [(0, True), (3, True),
                                              (20, True), (5, False)])
def test_delay(frames, streaming):
    x = _x((2, 40, 3), 4)
    jm = jc.Delay(frames=frames, ss=jc.StreamSetup(streaming=streaming))
    tm = tc.Delay(frames, tc.StreamSetup(streaming=streaming))
    outs_j, outs_t = _stream_both(jm, tm, x, 8)
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_array_equal(b, a)


def test_reset_cache_restarts_stream():
    tm = tc.Conv1d(2, 2, 3, dilation=3, ss=tc.StreamSetup(streaming=True))
    x = torch.randn(1, 2, 12)
    with torch.no_grad():
        a = tm(x)
        tm(x)
        tm.reset_cache()
        b = tm(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
