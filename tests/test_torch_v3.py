"""Snake, AdaIN and the ``v3`` / ``discrete_v3`` presets in the port
against ``rave_tpu``: the activation, AdaIN's identity in training and
its serving update rule, the offline forwards, the streamed AdaIN
controls workflow, its CUDA-graph-free scan path, and ``serialize`` with
the AdaIN state in the carried caches.

Tolerances: the activation and AdaIN alone 1e-6 (elementwise float32;
``std`` with ``ddof=1`` reduced in another order: 2e-6); whole models
1e-4 (float32 through ~30 convs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.models import blocks as jblocks
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import adain_states, load_flax_params
from rave_tpu_torch.export.streaming import StreamingRAVE
from rave_tpu_torch.models.blocks import Activation, AdaIN
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.ops.conv import StreamSetup

TINY = ["capacity=4", "latent_size=8", "num_quantizers=2",
        "codebook_size=32", "n_signal=4096", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cf(a):
    """``(B, T, C)`` numpy -> ``(B, C, T)`` tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


def test_snake_matches():
    x = np.random.default_rng(0).standard_normal((2, 50, 6)).astype(
        np.float32) * 3
    alpha = np.random.default_rng(1).uniform(0.2, 2.0, 6).astype(np.float32)
    want = jblocks.Activation(kind="snake").apply(
        {"params": {"alpha": alpha}}, jnp.asarray(x))
    act = Activation("snake", 6)
    with torch.no_grad():
        act.alpha.copy_(torch.from_numpy(alpha))
        got = act(_cf(x)).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert torch.equal(Activation("snake", 3).alpha, torch.ones(3))
    with pytest.raises(ValueError, match="unknown activation"):
        Activation("gelu")


def _jax_adain_state(B, C, seed, n_x, n_y, learn_x, learn_y):
    r = np.random.default_rng(seed)
    return {"mean_x": r.standard_normal((B, 1, C)).astype(np.float32),
            "std_x": r.uniform(0.5, 2, (B, 1, C)).astype(np.float32),
            "mean_y": r.standard_normal((B, 1, C)).astype(np.float32),
            "std_y": r.uniform(0.5, 2, (B, 1, C)).astype(np.float32),
            "num_update_x": np.float32(n_x), "num_update_y": np.float32(n_y),
            "learn_x": np.float32(learn_x), "learn_y": np.float32(learn_y)}


def _packed(st):
    B, _, C = st["mean_x"].shape
    return torch.from_numpy(np.stack(
        [np.broadcast_to(np.asarray(st[k]).reshape((B, C) if np.ndim(st[k])
                                                   else ()), (B, C))
         for k in AdaIN.SLOTS], -1).astype(np.float32))


def test_adain_is_identity_in_training():
    x = torch.randn(2, 5, 30)
    m = AdaIN(5, StreamSetup(streaming=True))
    m.cache = _packed(_jax_adain_state(2, 5, 0, 2, 3, 0, 0))
    assert torch.equal(m(x), x)
    m.train_mode = False
    assert not torch.equal(m(x), x)


@pytest.mark.parametrize("flags", [(0, 0, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1),
                                   (0, 0, 1, 1), (3, 2, 0, 0), (3, 2, 1, 0),
                                   (3, 2, 0, 1), (0, 2, 1, 0)],
                         ids=lambda f: "nx{}ny{}lx{}ly{}".format(*f))
def test_adain_serving_update_matches(flags):
    """One streamed pass from a given state against the JAX package's
    mutable ``adain`` apply: output and new state.  Target learning wins
    over source learning."""
    B, C, T = 2, 5, 40
    st = _jax_adain_state(B, C, 1, *flags)
    x = np.random.default_rng(2).standard_normal((B, T, C)).astype(
        np.float32) * 2 + 0.5
    y_j, upd = jblocks.AdaIN(dim=C, train_mode=False).apply(
        {"adain": st}, jnp.asarray(x), mutable=["adain"])
    m = AdaIN(C, StreamSetup(streaming=True))
    m.train_mode = False
    m.cache = _packed(st)
    y_t = m(_cf(x))
    np.testing.assert_allclose(y_t.numpy().transpose(0, 2, 1),
                               np.asarray(y_j), atol=2e-6)
    np.testing.assert_allclose(m.cache.numpy(), _packed(_np(upd["adain"]))
                               .numpy(), atol=2e-6)
    # offline: the frozen transfer of the state it holds, no update
    off = AdaIN(C)
    off.train_mode = False
    off.cache = _packed(st)
    y_f = jblocks.AdaIN(dim=C, train_mode=False).apply(
        {"adain": st}, jnp.asarray(x))
    np.testing.assert_allclose(off(_cf(x)).numpy().transpose(0, 2, 1),
                               np.asarray(y_f), atol=2e-6)
    assert torch.equal(off.cache, _packed(st))


def _jax_vars(stack, T=4096, B=1):
    cfg = jbuild(stack, TINY)
    m = JRAVE(cfg=cfg, train_mode=False)
    x = (np.random.default_rng(3).standard_normal((B, T, 1)) * 0.3
         ).astype(np.float32)
    v = _np(jax.jit(lambda r, a: m.init(r, a, method=JRAVE.warmup))(
        {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2), "quantizer": jax.random.PRNGKey(3)},
        jnp.asarray(x)))
    return cfg, m, v, x


@pytest.mark.parametrize("stack", [["v3"], ["discrete_v3"],
                                   ["discrete", "snake", "adain"]],
                         ids=lambda s: "+".join(s))
def test_offline_forward_matches(stack):
    """With a trained AdaIN state (statistics on both sides, learning
    off) in the offline model, and random codebooks for the discrete
    head."""
    cfg, m, v, x = _jax_vars(stack, B=2)
    v = {k: dict(val) for k, val in v.items()}
    r = np.random.default_rng(4)
    if "quantizer" in v:
        v["quantizer"] = jax.tree.map(
            lambda a: (r.standard_normal(a.shape) * 0.5).astype(np.float32)
            if a.ndim else np.float32(1.0), v["quantizer"])
    has_adain = "adain" in v
    if has_adain:
        v["adain"] = jax.tree.map(
            lambda a: (r.uniform(0.8, 1.2, a.shape) if a.ndim else
                       np.float32(1.0)).astype(np.float32), v["adain"])
        for part in v["adain"].values():
            for st in part.values():
                st["learn_x"] = st["learn_y"] = np.float32(0.0)
    y_j = np.asarray(jax.jit(lambda v, a: m.apply(v, a))(v, jnp.asarray(x)))
    port = RAVE(build_config(stack, TINY), device="cpu", train_mode=False)
    load_flax_params(port, v["params"],
                     model_state={k: v[k] for k in v if k != "params"})
    assert all(s is not None for s in adain_states(port))
    assert bool(adain_states(port)) == has_adain
    with torch.no_grad():
        y_t = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=1e-4)
    if not has_adain:
        return
    # without the state the offline model's AdaIN is the identity
    plain = RAVE(build_config(stack, TINY), device="cpu", train_mode=False)
    load_flax_params(plain, v["params"], model_state={
        k: v[k] for k in v if k not in ("params", "adain")})
    with torch.no_grad():
        assert not np.allclose(plain(torch.from_numpy(x)).numpy(), y_t,
                               atol=1e-4)


class _JaxStream:
    """The JAX package's streaming model driven as its ``StreamingRAVE``
    drives it (``forward`` with the ``cache`` and ``adain`` collections
    mutable; the controls set ``learn_x``/``learn_y`` in every AdaIN's
    ``adain`` leaves), jitted: that class initialises its model eagerly,
    tens of seconds on a CPU."""

    def __init__(self, cfg, params, chunk):
        model = JRAVE(cfg=cfg, streaming=True, train_mode=False)
        v = jax.jit(model.init)({"params": jax.random.PRNGKey(0)},
                                jnp.zeros((1, chunk, 1)))
        self.init_cache = jax.tree.map(jnp.zeros_like, v["cache"])
        self.init_adain = v["adain"]
        self.params = params
        self._fwd = jax.jit(lambda p, c, a, x: model.apply(
            {"params": p, "cache": c, "adain": a}, x,
            mutable=["cache", "adain"]))
        self.reset()

    def reset(self):
        self.cache, self.adain = self.init_cache, self.init_adain

    def forward(self, x):
        y, upd = self._fwd(self.params, self.cache, self.adain,
                           jnp.asarray(x))
        self.cache, self.adain = upd["cache"], upd["adain"]
        return np.asarray(y)

    def _flag(self, key, on):
        self.adain = {part: {name: {**leaves, key: jnp.float32(on)}
                             for name, leaves in mods.items()}
                      for part, mods in self.adain.items()}

    def set_learn_target(self, on):
        self._flag("learn_y", on)

    def set_learn_source(self, on):
        self._flag("learn_x", on)


@pytest.fixture(scope="module")
def streams():
    """The tiny ``v3`` in both streaming drivers, 2048-sample chunks."""
    cfg, _, v, x = _jax_vars(["v3"], T=16384)
    js = _JaxStream(cfg, v["params"], 2048)
    port = RAVE(build_config(["v3"], TINY), device="cpu")
    load_flax_params(port, v["params"])
    ts = StreamingRAVE(build_config(["v3"], TINY), port.state_dict(),
                       chunk_size=2048, device="cpu")
    return js, ts, x


def _workflow(s, x, reset_caches):
    """The JAX package's AdaIN controls workflow
    (``tests/test_streaming.py``): a plain chunk, target statistics from a
    louder stream, source statistics, then the transfer from fresh conv
    caches."""
    c = x[:, :2048]
    outs = [s.forward(c)]
    s.reset()
    s.set_learn_target(True)
    outs.append(s.forward(x[:, 2048:4096] * 3.0))
    s.set_learn_target(False)
    s.set_learn_source(True)
    outs.append(s.forward(c))
    s.set_learn_source(False)
    reset_caches(s)
    outs.append(s.forward(c))
    return [np.asarray(o) for o in outs]


def test_adain_controls_workflow_matches(streams):
    js, ts, x = streams

    def jreset(s):
        s.cache = s.init_cache

    def treset(s):
        # the conv caches only; the AdaIN states are the carry's tail
        k = len(s.caches) - s.n_adain
        s.caches[:k] = [c.clone() for c in s.init_caches[:k]]

    want = _workflow(js, x, jreset)
    got = _workflow(ts, x, treset)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4)
    assert not np.allclose(got[3], got[0], atol=1e-5)
    # the live state: target counters 1, source counters 1, flags off
    for st in ts.adain:
        assert torch.all(st[..., AdaIN.N_Y] == 1)
        assert torch.all(st[..., AdaIN.N_X] == 1)
        assert torch.all(st[..., AdaIN.LEARN_X:] == 0)
    ts.reset_target()
    assert all(torch.all(st[..., AdaIN.N_Y] == 0) for st in ts.adain)
    assert all(torch.all(st[..., AdaIN.STD_Y] == 1) for st in ts.adain)
    ts.reset_source()
    assert all(torch.all(st[..., AdaIN.N_X] == 0) for st in ts.adain)
    ts.reset()
    assert all(torch.equal(a, b) for a, b in
               zip(ts.adain, ts.init_caches[-ts.n_adain:]))


def test_stream_from_converted_adain_state(streams):
    """A stream started from converted AdaIN statistics
    (``StreamingRAVE(adain_state=...)`` of ``load_flax_params``'
    ``model_state``, the JAX package's ``model_state={"adain": ...}``)
    equals the JAX stream from them, and ``reset`` returns to them."""
    js, _, x = streams
    r = np.random.default_rng(6)
    adain = jax.tree.map(
        lambda a: (r.uniform(0.8, 1.2, a.shape) if a.ndim else
                   np.float32(1.0)).astype(np.float32), _np(js.init_adain))
    for part in adain.values():
        for st in part.values():
            st["learn_x"] = st["learn_y"] = np.float32(0.0)
    cfg = build_config(["v3"], TINY)
    port = RAVE(cfg, device="cpu")
    load_flax_params(port, js.params, model_state={"adain": adain})
    ts = StreamingRAVE(cfg, port.state_dict(), chunk_size=2048,
                       device="cpu", adain_state=adain_states(port))
    before = js.init_adain
    js.init_adain = jax.tree.map(jnp.asarray, adain)
    try:
        js.reset()
        for i in range(2):
            c = x[:, 2048 * i:2048 * (i + 1)]
            np.testing.assert_allclose(ts.forward(c).numpy(), js.forward(c),
                                       atol=1e-4)
    finally:
        js.init_adain = before
        js.reset()
    ts.reset()
    for got, want in zip(ts.adain, adain_states(port)):
        assert torch.equal(got, want)


def test_scan_reads_live_controls(streams):
    """``process_file_scan`` carries the controls set so far and leaves
    the last chunk's AdaIN state live; after ``reset`` it starts from the
    initial state, as in the JAX package."""
    _, ts, x = streams
    ts.reset()
    sig = x[0, :8192, 0]
    eager = []
    ts.set_learn_target(True)
    for i in range(4):
        eager.append(ts.forward(sig[2048 * i:2048 * (i + 1)]
                                .reshape(1, -1, 1) * 3.0))
    want_state = [a.clone() for a in ts.adain]
    ts.reset()
    plain = ts.process_file_scan(sig * 3.0)
    ts.set_learn_target(True)
    got = ts.process_file_scan(sig * 3.0)
    np.testing.assert_allclose(got, torch.cat(eager, 1).reshape(-1).numpy(),
                               atol=1e-6)
    for a, b in zip(ts.adain, want_state):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        plain, ts.process_file(sig * 3.0), atol=1e-6)


def test_serialize_carries_adain_state(streams, tmp_path):
    """The exported steps take the AdaIN states after the caches; with
    target learning switched on in the carried flags, each reloaded
    program equals the live step."""
    _, ts, x = streams
    out = ts.serialize(str(tmp_path))
    import json
    assert json.loads((out / "meta.json").read_text())["adain"]
    init = np.load(out / "cache_init.npz")
    n = len(ts.init_caches)
    assert sorted(init.files, key=lambda k: int(k[1:])) == [
        f"c{i}" for i in range(n)]
    for i in range(n - ts.n_adain, n):
        np.testing.assert_array_equal(init[f"c{i}"],
                                      ts.init_caches[i].numpy())
    ts.reset()
    ts.set_learn_target(True)
    carry = [c.clone() for c in ts.caches]
    c = torch.from_numpy(x[:, :2048])
    z = ts.encode(c)
    for name, arg in (("forward", c), ("encode", c), ("decode", z)):
        prog = torch.export.load(str(out / f"{name}.pt2")).module()
        step = {"forward": ts._forward, "encode": ts._encode,
                "decode": ts._decode}[name]
        with torch.no_grad():
            want, want_carry = step(list(carry), arg)
            got, got_carry = prog(list(carry), arg)
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   atol=1e-6, err_msg=name)
        for a, b in zip(got_carry[n - ts.n_adain:], want_carry[n - ts.n_adain:]):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                       atol=1e-6, err_msg=name)
    # the flag reached the exported forward: target statistics moved
    assert any(float(a[..., AdaIN.N_Y].max()) == 1
               for a in got_carry[n - ts.n_adain:])


def test_stereo_with_adain_raises():
    cfg = build_config(["v3"], TINY)
    state = RAVE(cfg, device="cpu").state_dict()
    with pytest.raises(ValueError, match="stereo"):
        StreamingRAVE(cfg, state, stereo=True, device="cpu")
    with pytest.raises(ValueError, match="AdaIN states"):
        StreamingRAVE(cfg, state, device="cpu", adain_state=[])
