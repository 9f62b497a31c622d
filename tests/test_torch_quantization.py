"""The port's residual VQ (``rave_tpu_torch/models/quantization.py``)
against ``rave_tpu.models.quantization`` on the same inputs and state.

The random rows of k-means' seeds and of dead-code expiry come from
``jax.random`` on one side and a ``torch.Generator`` on the other.  For
parity both get the same deterministic rule (:func:`_rows`, a numpy
draw seeded by the number of samples and of rows): the JAX package's
``_sample_vectors`` is monkeypatched in this process, the port takes it
as its ``sampler`` argument.

Tolerances: values 1e-5 (float32, the same expressions; matrix products
in another order).  Indices are equal wherever the two frameworks'
nearest-code distance gaps exceed 1e-5 of the distance (:func:`_same_codes`);
at a smaller gap the two codes must be equally near within that margin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rave_tpu.models.quantization as jq
from rave_tpu_torch.models import quantization as tq

D, K = 8, 32


def _rows_idx(n: int, num: int) -> np.ndarray:
    return np.random.RandomState(1000 * n + num).randint(0, n, num)


def _jax_rows(rng, samples, num):
    return samples[jnp.asarray(_rows_idx(samples.shape[0], num))]


def _rows(samples: torch.Tensor, num: int) -> torch.Tensor:
    return samples[torch.from_numpy(_rows_idx(samples.shape[0], num))]


@pytest.fixture(autouse=True)
def _same_draws(monkeypatch):
    monkeypatch.setattr(jq, "_sample_vectors", _jax_rows)


def _x(n, seed=0, d=D):
    return (np.random.default_rng(seed).standard_normal((n, d))
            ).astype(np.float32)


def _state(seed=1, inited=1.0, k=K, d=D):
    r = np.random.default_rng(seed)
    return {"embed": r.standard_normal((k, d)).astype(np.float32),
            "embed_avg": r.standard_normal((k, d)).astype(np.float32),
            "cluster_size": r.uniform(0, 4, k).astype(np.float32),
            "inited": np.float32(inited)}


def _port_book(state, k=K, d=D):
    book = tq.EuclideanCodebook(d, k)
    with torch.no_grad():
        for name, v in state.items():
            getattr(book, name).copy_(torch.as_tensor(v))
    book._inited_host = None
    return book


def _jax_book(x, state, train, k=K, d=D):
    out, upd = jq.EuclideanCodebook(dim=d, codebook_size=k).apply(
        {"quantizer": state}, jnp.asarray(x), train=train,
        rngs={"quantizer": jax.random.PRNGKey(0)}, mutable=["quantizer"])
    return [np.asarray(a) for a in out], jax.tree.map(np.asarray,
                                                      upd["quantizer"])


def _same_codes(x, embed, got, want):
    """``got`` and ``want`` pick codes equally near within 1e-5."""
    dist = ((x[:, None, :] - embed[None]) ** 2).sum(-1).astype(np.float64)
    n = np.arange(len(x))
    gap = np.abs(dist[n, got] - dist[n, want])
    assert np.all((got == want) | (gap <= 1e-5 * (dist[n, want] + 1e-6))), (
        np.flatnonzero(got != want))


def test_sample_vectors_draws_rows():
    x = torch.from_numpy(_x(10))
    g = torch.Generator().manual_seed(0)
    rows = tq.sample_vectors(x, 25, g)
    assert rows.shape == (25, D)
    assert all(any(torch.equal(r, s) for s in x) for r in rows)


@pytest.mark.parametrize("n", [64, 8])
def test_kmeans_matches(n):
    """50 iterations; with 8 samples for 32 clusters most stay empty and
    keep their (duplicated) seeds."""
    x = _x(n, seed=n)
    means_j, bins_j = jax.jit(lambda s: jq._kmeans(None, s, K, 50))(
        jnp.asarray(x))
    means_t, bins_t = tq.kmeans(torch.from_numpy(x), K, 50, _rows)
    np.testing.assert_allclose(means_t.numpy(), np.asarray(means_j),
                               atol=1e-5)
    np.testing.assert_array_equal(bins_t.numpy(), np.asarray(bins_j))
    assert float(bins_t.sum()) == n


@pytest.mark.parametrize("n", [64, 256])
def test_codebook_search_matches(n):
    x, st = _x(n, seed=2), _state()
    (q_j, i_j), _ = _jax_book(x, st, train=False)
    q_t, i_t = _port_book(st)(torch.from_numpy(x))
    assert i_t.dtype == torch.int64
    _same_codes(x, st["embed"], i_t.numpy(), i_j)
    np.testing.assert_allclose(q_t.numpy(), st["embed"][i_t.numpy()])
    np.testing.assert_allclose(q_t.numpy()[i_t.numpy() == i_j],
                               q_j[i_t.numpy() == i_j], atol=1e-5)


def _check_state(book, want):
    for name, v in want.items():
        np.testing.assert_allclose(getattr(book, name).numpy(), v,
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n", [64, 8])
def test_train_pass_from_fresh_codebook(n):
    """k-means init, the search, expiry (every code under 2 uses at
    n = 8) and the EMA, from an all-zero codebook."""
    x = _x(n, seed=3)
    st = {k: np.zeros_like(v) for k, v in _state().items()}
    (q_j, i_j), upd = _jax_book(x, st, train=True)
    book = _port_book(st)
    q_t, i_t = book(torch.from_numpy(x), train=True, sampler=_rows)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    np.testing.assert_allclose(q_t.numpy(), q_j, atol=1e-5)
    _check_state(book, upd)
    assert float(book.inited) == 1.0 and book.is_inited()


def test_train_pass_inited_expiry_and_ema():
    """A pass over an inited codebook: no init; codes with
    ``cluster_size < 2`` are replaced and then overwritten by the EMA,
    as in the JAX package."""
    x, st = _x(48, seed=4), _state(seed=5)
    (q_j, i_j), upd = _jax_book(x, st, train=True)
    book = _port_book(st)
    q_t, i_t = book(torch.from_numpy(x), train=True, sampler=_rows)
    _same_codes(x, st["embed"], i_t.numpy(), i_j)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    _check_state(book, upd)
    with pytest.raises(ValueError, match="sampler"):
        book(torch.from_numpy(x), train=True)


def test_inited_mirror_follows_load_state_dict():
    book = _port_book(_state(inited=0.0))
    assert not book.is_inited()
    book.load_state_dict({k: torch.as_tensor(v)
                          for k, v in _state(inited=1.0).items()})
    assert book.is_inited()


def test_straight_through_and_commitment_loss():
    """Train pass of one VQ stage: the output equals the codes, the
    gradient passes straight through, the loss is the mean squared
    distance to the detached codes."""
    x = _x(3 * 5, seed=6).reshape(3, 5, D)
    st = _state(seed=7)
    w = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    vq_j = jq.VectorQuantization(dim=D, codebook_size=K)

    def jf(xx):
        (q, idx, loss), _ = vq_j.apply(
            {"quantizer": {"codebook": st}}, xx, train=True,
            rngs={"quantizer": jax.random.PRNGKey(0)}, mutable=["quantizer"])
        return jnp.sum(q * w) + 3.0 * loss, (q, loss)

    (_, (q_j, loss_j)), g_j = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(x))
    vq = tq.VectorQuantization(D, K)
    vq.codebook = _port_book(st)
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_()
    q, idx, loss = vq(xt, train=True, sampler=_rows)
    (torch.sum(q * torch.from_numpy(w.transpose(0, 2, 1).copy()))
     + 3.0 * loss).backward()
    assert idx.shape == (3, 5)
    np.testing.assert_allclose(q.detach().numpy().transpose(0, 2, 1),
                               np.asarray(q_j), atol=1e-5)
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 1),
                               np.asarray(g_j), atol=1e-5)


def _rvq_pair(st, n_q=2):
    jr = jq.ResidualVectorQuantization(num_quantizers=n_q, dim=D,
                                       codebook_size=K)
    tr = tq.ResidualVectorQuantization(n_q, D, K)
    for i, layer in enumerate(tr.layers):
        layer.codebook = _port_book(st[f"vq{i}"]["codebook"])
    return jr, tr


@pytest.mark.parametrize("train", [False, True])
def test_rvq_forward_matches(train):
    st = {f"vq{i}": {"codebook": _state(seed=10 + i)} for i in range(2)}
    x = _x(2 * 6, seed=9).reshape(2, 6, D)
    jr, tr = _rvq_pair(st)
    (q_j, loss_j, idx_j), upd = jr.apply(
        {"quantizer": st}, jnp.asarray(x), train=train,
        rngs={"quantizer": jax.random.PRNGKey(0)}, mutable=["quantizer"])
    q_t, loss_t, idx_t = tr(torch.from_numpy(x.transpose(0, 2, 1).copy()),
                            train, _rows)
    assert idx_t.shape == (2, 2, 6)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(q_t.numpy().transpose(0, 2, 1),
                               np.asarray(q_j), atol=1e-5)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5, abs=1e-7)
    assert (float(loss_t) > 0) == train
    for i, layer in enumerate(tr.layers):
        _check_state(layer.codebook,
                     jax.tree.map(np.asarray, upd["quantizer"][f"vq{i}"]
                                  ["codebook"]))


def test_rvq_encode_decode_match():
    st = {f"vq{i}": {"codebook": _state(seed=20 + i)} for i in range(3)}
    x = _x(2 * 7, seed=11).reshape(2, 7, D)
    jr, tr = _rvq_pair(st, 3)
    v = {"quantizer": st}
    idx_j = np.asarray(jr.apply(v, jnp.asarray(x),
                                method=jq.ResidualVectorQuantization.encode))
    dec_j = np.asarray(jr.apply(v, jnp.asarray(idx_j),
                                method=jq.ResidualVectorQuantization.decode))
    idx_t = tr.encode(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    dec_t = tr.decode(idx_t)
    np.testing.assert_allclose(dec_t.numpy().transpose(0, 2, 1), dec_j,
                               atol=1e-5)
    # decoding the codes equals the inference forward's quantized latent
    q, _, _ = tr(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    np.testing.assert_allclose(dec_t.numpy(), q.numpy(), atol=1e-6)
