"""``compute_dtype=bfloat16`` in the port against rave_tpu's bf16 run of
the same converted parameters: the offline forward of ``v2`` (the fused
units at widths 128, kernel B1's plain bf16 twin on the CPU, and the
unfused ones), ``discrete`` (its indices too), ``v3``, ``hybrid`` (its
mel front end; without its GRU layers, which the JAX package cannot run
in bf16, so both packages refuse them), ``v1`` and ``v2_fork``'s offline
``convert``; the dtype every conv, transposed conv, PQMF analysis,
latent head and speaker encoder reads, against the JAX package's, from
flax's method interceptor under ``jax.eval_shape``; ``v2`` + ``noise``
+ ``wasserstein`` (the JAX draws handed to the port), ``v2`` +
``spherical``, ``onnx``, ``raspberry`` and ``discrete_v3``; the bf16
train state and step building, ``float16`` refused; the generator
convs' bf16 bias gradients summed in float32.

Tolerances: the relative L2 distance of the audio (or of the latent for
``encode``), stated per case, set between the bf16 port's distance from
the JAX bf16 run and the float32 port's.  Each case checks both: the
bf16 port within, the float32 port (same parameters, same input)
beyond.  What keeps the bf16 port off the JAX run: XLA on the CPU skips
a bf16 rounding where the next op casts the value back to float32 (the
trunk's last op before ``astype(float32)``, AdaIN's promotion), and
sums in another order, which flips a rounding now and then; from width
128 on those flips spread through the layers (ROADMAP C).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from rave_tpu.config import build_config as jbuild
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import load_flax_params
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.ops.conv import Conv1d, ConvTranspose1d
from rave_tpu_torch.train import loop

TINY = ["capacity=4", "ratios=[2,2]", "dilations=[[1,3],[1,3]]"]
V1_TINY = ["capacity=4", "ratios=[2,2]", "latent_size=8"]
W128 = ["capacity=128", "ratios=[2]", "dilations=[[1,3]]"]
MEL = ["mel_n_fft=512", "mel_hop=16", "encoder_ratios=[2,2]",
       "encoder_dilations=[[1],[1]]", "decoder_gru_layers=0"]
# name: (stack, overrides, tolerance on the audio's relative L2 distance)
CASES = {
    "v2": (["v2"], TINY, 2.5e-3),
    "v2_fused": (["v2"], W128 + ["fused_kernels=true"], 4.5e-3),
    "v2_unfused": (["v2"], W128 + ["fused_kernels=false"], 4.5e-3),
    "discrete": (["discrete"], TINY + ["latent_size=8", "num_quantizers=2",
                                       "codebook_size=32"], 2.5e-3),
    "v3": (["v3"], TINY + ["latent_size=8"], 3e-4),
    "hybrid": (["hybrid"], TINY + MEL, 2.5e-3),
    "v1": (["v1"], V1_TINY, 5e-3),
    "v2_noise_wasserstein": (["v2", "noise", "wasserstein"],
                             TINY + ["noise_augmentation=8"], 2.5e-3),
    "v2_spherical": (["v2", "spherical"], TINY, 4.2e-3),
    # at their own capacities (32, 16)
    "onnx": (["onnx"], V1_TINY[1:], 7e-3),
    "raspberry": (["raspberry"], V1_TINY[1:], 6e-3),
    "discrete_v3": (["discrete_v3"], TINY + ["latent_size=8",
                                             "num_quantizers=2",
                                             "codebook_size=32"], 3e-3),
}
T = 8192


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_model(stack, over, B=2, seed=3):
    """The JAX bf16 model, its variables (trained-looking codebooks and
    AdaIN statistics where the preset has them) and the input."""
    cfg = jbuild(stack, over + ["compute_dtype=bfloat16"])
    m = JRAVE(cfg=cfg, train_mode=False)
    x = (np.random.default_rng(seed).standard_normal((B, T, 1)) * 0.3
         ).astype(np.float32)
    v = jax.jit(lambda r, a: m.init(r, a, method=JRAVE.warmup))(
        {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2), "quantizer": jax.random.PRNGKey(3)},
        jnp.asarray(x))
    v = {k: dict(jax.tree.map(np.asarray, val)) for k, val in v.items()}
    r = np.random.default_rng(4)
    if "quantizer" in v:
        v["quantizer"] = jax.tree.map(
            lambda a: (r.standard_normal(a.shape) * 0.5).astype(np.float32)
            if a.ndim else np.float32(1.0), v["quantizer"])
    if "adain" in v:
        v["adain"] = jax.tree.map(
            lambda a: (r.uniform(0.8, 1.2, a.shape) if a.ndim else
                       np.float32(1.0)).astype(np.float32), v["adain"])
        for part in v["adain"].values():
            for st in part.values():
                st["learn_x"] = st["learn_y"] = np.float32(0.0)
    return cfg, m, v, x


def _port(stack, over, v, dtype):
    model = RAVE(build_config(stack, over + [f"compute_dtype={dtype}"]),
                 device="cpu", train_mode=False)
    if "batch_stats" in v and "adain" not in v:
        load_flax_params(model, v["params"], v["batch_stats"])
    else:
        load_flax_params(model, v["params"], model_state={
            k: v[k] for k in v if k != "params"})
    return model


def _v1_noise(cfg, B, key):
    """The v1 noise branch's uniform draw of ``key`` (tests/test_torch_v1)."""
    return torch.from_numpy(np.array(jax.random.uniform(
        key, (B, T // cfg.n_band // 64, cfg.n_band, 64), jnp.float32,
        -1.0, 1.0)))


def _draws(case, cfg, key, B=2) -> dict:
    """The JAX forward's random draws of ``key`` for the port: v1's noise
    branch; the augmentation channels and the noise branch (one key for
    both) of ``v2`` + ``noise`` + ``wasserstein``."""
    if case == "v1":
        return {"noise": _v1_noise(cfg, B, key)}
    if case != "v2_noise_wasserstein":
        return {}
    n = math.prod(cfg.noise_ratios)
    aug = np.array(jax.random.normal(
        key, (B, T // cfg.total_ratio(), cfg.noise_augmentation)))
    noise = np.array(jax.random.uniform(
        key, (B, T // cfg.n_band // n, cfg.n_band, n), jnp.float32, -1.0,
        1.0))
    return {"aug": torch.from_numpy(aug.transpose(0, 2, 1).copy()),
            "noise": torch.from_numpy(noise)}


def _within_and_control(name, got_bf16, got_f32, want, tol):
    err, ctrl = _rel(got_bf16, want), _rel(got_f32, want)
    assert err <= tol, f"{name}: bf16 port {err:.3g} > {tol:.3g}"
    assert ctrl > tol, (f"{name}: the float32 port ({ctrl:.3g}) passes "
                        f"the bf16 tolerance {tol:.3g}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax_bf16(case):
    stack, over, tol = CASES[case]
    cfg, m, v, x = _jax_model(stack, over)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jax.jit(lambda v, a, k: m.apply(v, a, k))(
        v, jnp.asarray(x), key))
    draws = _draws(case, cfg, key)
    got = {}
    for dtype in ("bfloat16", "float32"):
        port = _port(stack, over, v, dtype)
        with torch.no_grad():
            got[dtype] = port(torch.from_numpy(x), **draws).numpy()
        if case == "discrete":
            with torch.no_grad():
                idx = port.encode_indices(torch.from_numpy(x)).numpy()
            want_idx = np.asarray(jax.jit(lambda v, a: m.apply(
                v, a, method=JRAVE.encode_indices))(v, jnp.asarray(x)))
            if dtype == "bfloat16":
                np.testing.assert_array_equal(idx, want_idx)
    assert got["bfloat16"].shape == want.shape == x.shape
    _within_and_control(case, got["bfloat16"], got["float32"], want, tol)


def test_fork_convert_matches_jax_bf16():
    """``v2_fork``'s offline conversion: the speaker encoder in float32,
    the trunk in bf16 (tolerance 2.5e-3)."""
    stack, over = ["v2_fork"], TINY + ["n_signal=8192"]
    cfg, m, v, x = _jax_model(stack, over)
    target = (np.random.default_rng(9).standard_normal((2, T, 1)) * 0.3
              ).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a, b: m.apply(
        v, a, b, method=JRAVE.convert))(v, jnp.asarray(x),
                                         jnp.asarray(target)))
    got = {}
    for dtype in ("bfloat16", "float32"):
        port = _port(stack, over, v, dtype)
        with torch.no_grad():
            got[dtype] = port.convert(torch.from_numpy(x),
                                      torch.from_numpy(target)).numpy()
    _within_and_control("v2_fork convert", got["bfloat16"], got["float32"],
                        want, 2.5e-3)


# ---- the dtype each module reads ---------------------------------------

# the port's module classes and the JAX package's, by kind
KINDS = {"Conv1d": "conv", "ConvTranspose1d": "conv_t", "PQMF": "pqmf",
         "VariationalHead": "latent", "DiscreteHead": "latent",
         "SpeakerRAVE": "speaker", "GRULayer": "gru"}


def _jax_reads(m, v, x, key):
    """``(kind, dtype)`` of every call of a module of ``KINDS`` in the JAX
    forward, in call order; nothing inside the PQMF, the speaker encoder
    or a latent head."""
    seen = []

    def record(next_fun, args, kwargs, ctx):
        mod = ctx.module
        kind = KINDS.get(type(mod).__name__)
        path = mod.path
        inner = any(p in ("pqmf", "speaker_encoder", "latent")
                    for p in path[:-1])
        if (kind and ctx.method_name == "__call__" and not inner
                and not kwargs.get("return_weights")):
            seen.append((kind, str(args[0].dtype)))
        return next_fun(*args, **kwargs)

    def run(v, a):
        with fnn.intercept_methods(record):
            return m.apply(v, a, key)

    jax.eval_shape(run, v, jnp.asarray(x))
    return seen


def _port_reads(model, x, noise=None):
    seen, handles = [], []
    parts = [model.encoder, model.decoder]

    def hook(kind):
        def pre(mod, args):
            seen.append((kind, str(args[0].dtype).removeprefix("torch.")))
        return pre

    for part in parts:
        for mod in part.modules():
            kind = KINDS.get(type(mod).__name__)
            if kind:
                handles.append(mod.register_forward_pre_hook(hook(kind)))
    for mod in (model.pqmf, model.latent, model.speaker_encoder):
        if mod is not None:
            kind = KINDS.get(type(mod).__name__)
            handles.append(mod.register_forward_pre_hook(hook(kind)))
    with torch.no_grad():
        model(torch.from_numpy(x), noise=noise)
    for h in handles:
        h.remove()
    return seen


@pytest.mark.parametrize("case", ["v2", "discrete", "v3", "hybrid", "v1",
                                  "v2_fork"])
def test_dtype_flow_matches_jax(case):
    """bf16 from the encoder's input to its output and from the decoder's
    input on, float32 where the JAX package promotes (after AdaIN in
    ``v3``, after EncoderV1's BatchNorm, the float32 noise branch added
    to the wave), float32 in the PQMF, the latent heads and the speaker
    encoder."""
    stack, over = ((["v2_fork"], TINY + ["n_signal=8192"])
                   if case == "v2_fork" else CASES[case][:2])
    cfg = jbuild(stack, over + ["compute_dtype=bfloat16"])
    m = JRAVE(cfg=cfg, train_mode=False)
    x = np.zeros((1, T, 1), np.float32)
    rngs = {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1),
            "noise": jax.random.PRNGKey(2), "quantizer": jax.random.PRNGKey(3)}
    shapes = jax.eval_shape(lambda r, a: m.init(r, a, method=JRAVE.warmup),
                            rngs, jnp.asarray(x))
    v = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    v = {k: dict(val) for k, val in v.items()}
    key = jax.random.PRNGKey(6)
    want = _jax_reads(m, v, x, key)
    port = _port(stack, over, v, "bfloat16")
    noise = None
    if case == "v1":
        noise = torch.zeros(1, T // cfg.n_band // 64, cfg.n_band, 64)
    got = _port_reads(port, x, noise)
    if case == "hybrid":
        # the JAX package analyses bands that a mel encoder without a
        # speaker encoder never reads; the port skips that analysis
        want = [w for w in want if w[0] != "pqmf"]
    assert got == want
    assert ("conv", "bfloat16") in got


def test_bf16_with_gru_layers_is_refused_in_both_packages():
    """flax's GRU cell promotes a bf16 input to float32 and its scan then
    refuses the carry: the JAX package cannot run ``hybrid`` in bf16, so
    the port refuses to build it."""
    over = TINY + MEL[:-1] + ["compute_dtype=bfloat16"]
    m = JRAVE(cfg=jbuild(["hybrid"], over), train_mode=False)
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(lambda r, a: m.init(r, a),
                       {"params": jax.random.PRNGKey(0),
                        "latent": jax.random.PRNGKey(1),
                        "noise": jax.random.PRNGKey(2)},
                       jnp.zeros((1, 4096, 1)))
    with pytest.raises(NotImplementedError, match="GRU"):
        RAVE(build_config(["hybrid"], over), device="cpu")


def test_bf16_train_state_builds_and_float16_is_refused():
    """A bf16 ``TrainState`` keeps float32 parameters and a bf16 step
    runs (``tests/test_torch_bf16_train.py`` holds it against the JAX
    package's); ``compute_dtype=float16`` is refused by the state, the
    step and the model."""
    cfg = build_config(["v2"], TINY + ["compute_dtype=bfloat16"])
    state = loop.TrainState(cfg, device="cpu")
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    assert {p.dtype for p in state.disc.parameters()} == {torch.float32}
    assert callable(loop.make_train_step(cfg))
    f16 = build_config(["v2"], TINY + ["compute_dtype=float16"])
    with pytest.raises(ValueError, match="compute_dtype"):
        loop.make_train_step(f16)
    with pytest.raises(ValueError, match="compute_dtype"):
        loop.TrainState(f16, device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        RAVE(f16, device="cpu")


def test_bf16_conv_bias_gradients_sum_in_float32():
    """The bias gradient of a bf16 Conv1d and ConvTranspose1d (the
    generator's convs) is the float32 sum of the bf16 cotangent over
    batch and time, rounded once to bf16 (the JAX VJP of the bias add
    with its sum in float32; XLA on the CPU sums it in bf16, ROADMAP C):
    within one bf16 rounding of a numpy float64 sum."""
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    for conv in (Conv1d(8, 8, 3, weight_norm=True),
                 ConvTranspose1d(8, 4, 4, 2, bias=True)):
        xb = torch.randn(2, 8, 400).to(torch.bfloat16)
        y = conv(xb)
        assert y.dtype == torch.bfloat16
        c = torch.from_numpy(rng.standard_normal(y.shape).astype(
            np.float32)).to(torch.bfloat16)
        y.backward(c)
        want = c.double().sum((0, 2)).numpy()
        got = conv.bias.grad.double().numpy()
        assert conv.bias.grad.dtype == torch.float32
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
        # a bf16 running sum, as XLA's, misses it
        run = torch.zeros(c.shape[1], dtype=torch.bfloat16)
        for t in c.permute(0, 2, 1).reshape(-1, c.shape[1]):
            run = run + t
        assert np.abs(run.double().numpy() - want).max() > 2 ** -8 * (
            np.abs(want).max())


def test_conv_rounds_twice_in_bf16():
    """A bf16 Conv1d rounds the conv, then adds the bias in bf16 (the JAX
    package's two roundings), not the bias inside the conv; a float32
    one is unchanged."""
    torch.manual_seed(0)
    conv = Conv1d(8, 8, 3, weight_norm=True)
    convt = ConvTranspose1d(8, 4, 4, 2, bias=True)
    x = torch.randn(2, 8, 40)
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        w = conv.kernel().to(torch.bfloat16)
        two = (torch.nn.functional.conv1d(xb, w, padding=1)
               + conv.bias.to(torch.bfloat16)[:, None])
        assert torch.equal(conv(xb), two)
        assert conv(x).dtype == torch.float32
        assert convt(xb).dtype == torch.bfloat16
