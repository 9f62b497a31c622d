"""Every discriminator member in bf16 against rave_tpu's bf16
``disc.apply``, and the bf16 STFT under it.

Each member of ``combine`` (``univnet``: its MRDs and MPDs;
``melgan_stack``, whose head conv passes the ci=1 gate at 8192 samples;
``periods``, ``scales``, ``spectral`` and ``spectral_1d``; ``descript``)
runs alone on the same converted parameters and the same bf16 audio in
both packages: every feature map, the gradient with respect to the
audio and to the parameters of a fixed random weighting of all of them
(a float32 sum, ``jax.grad`` on the JAX side), and the dtype every conv
reads, from flax's method interceptor.  A float32 port of the same
parameters on the same audio (widened) is the negative control: each
tolerance sits between the bf16 port's relative L2 distance from the JAX
bf16 run and the float32 port's.  The JAX references are compiled with
XLA's excess precision off, so that they round where their bf16 program
says.  The biases are left out of the parameter gradient, because XLA on
the CPU sums a bf16 bias gradient in bf16 (``tests/test_torch_bf16_train.
py``, ROADMAP C), and held on their own instead: each conv's bias
gradient against the float32 sum, over every axis but the channels, of
the JAX bf16 cotangent at that conv's output, rounded once to bf16 (the
JAX VJP of the bias add with its sum in float32).  The cotangents are
read as the gradients of zero bf16 tensors added to every ``WNConv``
output by flax's method interceptor, on the members' unpacked
formulation (the packed-resident chains of the spectral, UnivNet MRD and
Descript MRD members add their biases inside one function; the unpacked
ones have the same parameters and compute the same maps).

The STFT: the port's ``stft`` of a bf16 signal against the JAX
package's (the frames windowed in bf16, the FFT in float32, the
``normalized`` divisor), its values and its VJP, beside the float32
STFT of the same samples.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.models import discriminators as jdisc
from rave_tpu.ops import stft as jstft
from rave_tpu_torch.convert import load_discriminator_params
from rave_tpu_torch.models import discriminators as tdisc
from rave_tpu_torch.ops import stft as tstft

T = 8192
SCALES = (1024, 512, 256)
# relative L2 distances from the JAX bf16 run, the bf16 port within and
# the float32 port beyond: the first map of each sub-discriminator (the
# largest), every map together, then per member the gradient with
# respect to the audio, to the parameters but the biases, and to the
# biases (measured: bf16 port / float32 port)
FIRST_TOL = 5e-4         # 0 - 1.2e-4 / 2.5e-3 - 4.1e-3
FEATURES_TOL = 1.5e-3    # 2.1e-5 - 3.2e-4 / 2.6e-3 - 4.3e-3
MEMBERS = {
    # 4.6e-3 / 7.7e-2, 3.5e-3 / 4.4e-2, 6.5e-3 / 6.5e-2
    "descript": (2e-2, 1.2e-2, 2e-2),
    # 1.5e-3 / 1.2e-2, 8.9e-4 / 1.5e-2, 8.5e-4 / 1.3e-2
    "melgan_stack": (4e-3, 2.5e-3, 4e-3),
    # 3.6e-4 / 8.3e-3, 3.1e-4 / 1.1e-2, 1.5e-4 / 8.2e-3
    "periods": (2e-3, 2.2e-3, 2e-3),
    # 4.4e-4 / 7.3e-3, 4.2e-4 / 8.3e-3, 1.2e-4 / 8.3e-3
    "scales": (2e-3, 2e-3, 2e-3),
    # 3.8e-3 / 3.0e-2, 3.6e-3 / 3.7e-2, 2.5e-3 / 3.4e-2
    "spectral": (1e-2, 1.3e-2, 1e-2),
    # 1.3e-3 / 2.1e-2, 6.1e-4 / 1.9e-2, 6.8e-4 / 1.6e-2
    "spectral_1d": (5e-3, 3e-3, 5e-3),
    # 4.1e-3 / 5.3e-2, 3.4e-3 / 3.0e-2, 6.9e-3 / 4.5e-2
    "univnet": (1.3e-2, 1.3e-2, 2e-2),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_disc(member):
    return jdisc.CombineDiscriminators(members=(member,), capacity=16,
                                       spectral_scales=SCALES)


def _port_disc(member, params):
    disc = tdisc.CombineDiscriminators((member,), 16, SCALES)
    load_discriminator_params(disc, params)
    return disc


def _native(f, swap: bool = False):
    """A JAX feature map in the port's layout (channels second; a
    Descript MRD band map, frequency-major in the JAX package's packed
    chain, with its time and frequency axes swapped), float32."""
    if isinstance(f, jdisc.PackedFeature):
        f = f.unpack()
    f = jnp.moveaxis(f.astype(jnp.float32), -1, 1)
    return jnp.swapaxes(f, 2, 3) if swap else f


def _swaps(member, feats) -> list:
    """Which maps :func:`_native` swaps: the band maps of the Descript
    MRDs (every map of an MRD chain but its score)."""
    mrds = range(5, 8) if member == "descript" else ()
    return [i in mrds and j < len(chain) - 1
            for i, chain in enumerate(feats) for j in range(len(chain))]


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    x = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 900, (2, 1)) * t)
         + 0.05 * rng.standard_normal((2, T)))
    return np.asarray(jnp.asarray(x[..., None], jnp.bfloat16)
                      .astype(jnp.float32))


def _params(shapes, rng):
    """Parameters of the shapes ``jax.eval_shape`` gives ``disc.init``,
    drawn as flax's ``WNConv`` draws them (``v`` and ``bias`` uniform
    in +-1/sqrt(fan_in), ``g`` the norm of ``v``), without compiling the
    init."""
    if "v" in shapes:
        v_shape = shapes["v"].shape
        bound = 1.0 / np.sqrt(np.prod(v_shape[:-1]))
        v = rng.uniform(-bound, bound, v_shape).astype(np.float32)
        g = np.sqrt((v.astype(np.float64) ** 2).sum(
            axis=tuple(range(v.ndim - 1)), keepdims=True)).astype(np.float32)
        return {"v": v, "g": g, "bias": rng.uniform(
            -bound, bound, shapes["bias"].shape).astype(np.float32)}
    return {k: _params(v, rng) for k, v in shapes.items()}


def _weights(shapes, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _exact_jit(fn, *args):
    """``fn`` compiled for ``args`` with XLA's excess precision off: on
    the CPU, XLA otherwise drops a bf16 rounding where a value is widened
    again (the float32 STFT cast to bf16 and read by a conv), and the
    bf16 program is not what it says (ROADMAP C)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _is_conv(ctx) -> bool:
    return (type(ctx.module).__name__ == "WNConv"
            and ctx.method_name == "__call__")


# the members whose packed-resident chains add their biases inside one
# function, run unpacked for the bias reference
UNPACKED = ("MultiScaleSpectralDiscriminator", "UnivNetDiscriminator",
            "DescriptMRD")


def _bias_reference(member, params, xb, ws, shapes) -> dict:
    """``params`` with every bias replaced by the float32 sum of the JAX
    bf16 cotangent at its conv's output, rounded once to bf16 (see the
    module docstring); ``shapes`` are the port-layout maps ``ws``
    weighs."""
    saved = {n: getattr(jdisc, n) for n in UNPACKED}
    for n in UNPACKED:
        setattr(jdisc, n, functools.partial(saved[n], packed=False))
    try:
        disc = _jax_disc(member)
        convs = []

        def record(next_fun, args, kwargs, ctx):
            y = next_fun(*args, **kwargs)
            if _is_conv(ctx):
                convs.append((ctx.module.path, y.shape, y.dtype))
            return y

        def run(p, a):
            with fnn.intercept_methods(record):
                return disc.apply(p, a)

        jax.eval_shape(run, params, xb)

        def loss(deltas, p, a):
            added = iter(deltas)

            def add(next_fun, args, kwargs, ctx):
                y = next_fun(*args, **kwargs)
                return y + next(added) if _is_conv(ctx) else y

            with fnn.intercept_methods(add):
                feats = disc.apply(p, a)
            flat = [_native(f) for chain in feats for f in chain]
            flat = [f if f.shape == s else jnp.swapaxes(f, 2, 3)
                    for f, s in zip(flat, shapes)]
            assert [f.shape for f in flat] == list(shapes)
            return sum(jnp.sum(f * w) for f, w in zip(flat, ws))

        deltas = [jnp.zeros(shape, dtype) for _, shape, dtype in convs]
        cots = _exact_jit(jax.grad(loss), deltas, params, xb)(
            deltas, params, xb)
    finally:
        for n, cls in saved.items():
            setattr(jdisc, n, cls)
    tree = jax.tree.map(np.array, params["params"])
    for (path, _, _), c in zip(convs, cots):
        node = tree
        for k in path:
            node = node[k]
        node["bias"] = np.asarray(jnp.sum(
            c.astype(jnp.float32), axis=tuple(range(c.ndim - 1))).astype(
                jnp.bfloat16).astype(jnp.float32))
    n_bias = sum(1 for k in jax.tree_util.tree_leaves_with_path(tree)
                 if k[0][-1].key == "bias")
    assert n_bias == len(convs), (member, n_bias, len(convs))
    return tree


def _native_shape(f, swap: bool) -> tuple:
    """The shape :func:`_native` gives the abstract feature map ``f``."""
    if isinstance(f, jdisc.PackedFeature):
        B, _, T, pc = f.data.shape
        shape = (B, f.valid_rows, T, pc // f.pout)
    else:
        shape = f.shape
    shape = (shape[0], shape[-1], *shape[1:-1])
    return (*shape[:2], shape[3], shape[2]) if swap else shape


@pytest.fixture(scope="module")
def jax_runs():
    """Per member: the JAX bf16 features (port layout), the gradients of
    their weighted sum, the conv input dtypes and the parameters.  One
    abstract trace gives the maps' shapes and the dtype each conv reads."""
    x = _audio()
    out = {}
    for member in MEMBERS:
        disc = _jax_disc(member)
        xb = jnp.asarray(x, jnp.bfloat16)
        params = _params(jax.eval_shape(disc.init, jax.random.PRNGKey(0),
                                        xb), np.random.default_rng(0))
        reads = []

        def record(next_fun, args, kwargs, ctx):
            if (type(ctx.module).__name__ == "WNConv"
                    and ctx.method_name == "__call__"):
                reads.append(str(args[0].dtype))
            return next_fun(*args, **kwargs)

        def run(p, a):
            with fnn.intercept_methods(record):
                return disc.apply(p, a)

        shapes = jax.eval_shape(run, params, xb)
        swaps = _swaps(member, shapes)

        def maps(p, a, swaps=swaps):
            return [_native(f, sw) for f, sw in zip(
                (f for chain in disc.apply(p, a) for f in chain), swaps)]

        ws = _weights([_native_shape(f, sw) for f, sw in zip(
            (f for chain in shapes for f in chain), swaps)])

        def loss(p, a, ws=ws):
            fs = maps(p, a)
            return sum(jnp.sum(f * w) for f, w in zip(fs, ws)), fs

        grad = jax.grad(loss, argnums=(0, 1), has_aux=True)
        (gp, gx), flat = _exact_jit(grad, params, xb)(params, xb)
        assert [f.shape for f in flat] == [w.shape for w in ws]
        first = np.cumsum([0] + [len(chain) for chain in shapes])[:-1]
        bias_ref = _bias_reference(member, params, xb, ws,
                                   [f.shape for f in flat])
        out[member] = {"params": params["params"], "bias_ref": bias_ref,
                       "grad_params": jax.tree.map(np.asarray, gp["params"]),
                       "feats": [np.asarray(f) for f in flat], "weights": ws,
                       "first": list(first),
                       "grad_x": np.asarray(gx.astype(jnp.float32))[..., 0],
                       "reads": reads}
    return x, out


def _port_run(member, ref, x, dtype):
    disc = _port_disc(member, ref["params"])
    reads = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: reads.append(str(args[0].dtype).removeprefix(
            "torch."))) for m in disc.modules() if isinstance(m, tdisc.WNConv)]
    xt = torch.from_numpy(x[..., 0][:, None]).to(dtype).requires_grad_(True)
    feats = [f for chain in disc(xt) for f in chain]
    for h in hooks:
        h.remove()
    loss = sum((f.float() * torch.from_numpy(w)).sum()
               for f, w in zip(feats, ref["weights"]))
    loss.backward()
    def flat(module, bias: bool, grad: bool = False):
        return np.concatenate([
            (p.grad if grad else p).detach().double().numpy().ravel()
            for n, p in module.named_parameters()
            if n.endswith("bias") == bias])

    want = _port_disc(member, ref["grad_params"])
    want_bias = _port_disc(member, ref["bias_ref"])
    return {"feats": [f.detach().float().numpy() for f in feats],
            "grad_x": xt.grad.float().numpy()[:, 0],
            "grad_params": flat(disc, False, grad=True),
            "want_grad_params": flat(want, False),
            "grad_bias": flat(disc, True, grad=True),
            "want_grad_bias": flat(want_bias, True), "reads": reads}


def _distances(port, ref) -> tuple:
    assert [f.shape for f in port["feats"]] == [f.shape for f in ref["feats"]]
    first = max(_rel(port["feats"][i], ref["feats"][i]) for i in ref["first"])
    every = _rel(np.concatenate([f.ravel() for f in port["feats"]]),
                 np.concatenate([f.ravel() for f in ref["feats"]]))
    return (first, every, _rel(port["grad_x"], ref["grad_x"]),
            _rel(port["grad_params"], port["want_grad_params"]),
            _rel(port["grad_bias"], port["want_grad_bias"]))


@pytest.mark.parametrize("member", sorted(MEMBERS))
def test_member_matches_jax_bf16(jax_runs, member):
    x, runs = jax_runs
    ref = runs[member]
    bf = _port_run(member, ref, x, torch.bfloat16)
    f32 = _port_run(member, ref, x, torch.float32)
    assert bf["reads"] == ref["reads"]
    assert set(bf["reads"]) == {"bfloat16"}
    assert all(f.dtype == np.float32 for f in bf["feats"])
    got, ctrl = _distances(bf, ref), _distances(f32, ref)
    print(member, "bf16 port", got, "float32 port", ctrl)
    tols = (FIRST_TOL, FEATURES_TOL, *MEMBERS[member])
    whats = ("first_maps", "features", "grad_x", "grad_params", "grad_bias")
    assert len(got) == len(ctrl) == len(tols) == len(whats)
    for what, g, c, tol in zip(whats, got, ctrl, tols):
        assert g <= tol, (member, what, g, tol)
        assert c > tol, (member, what, f"the float32 port ({c:.3g}) "
                         f"passes the bf16 tolerance {tol:.3g}")


@pytest.mark.parametrize("n_fft,hop,win,center,normalized", [
    (1024, 256, None, False, True), (2048, 512, None, True, False),
    (1024, 220, 551, False, False)])
def test_bf16_stft_matches_jax(n_fft, hop, win, center, normalized):
    """Values and VJP of the bf16 STFT against the JAX package's, the
    float32 STFT of the same samples as the control."""
    x = _audio(2)[..., 0]
    kw = dict(win_length=win, center=center, normalized=normalized)
    rng = np.random.default_rng(3)

    def jloss(a, c):
        s = jstft.stft(a, n_fft, hop, **kw)
        return jnp.sum(s.real * c[0] + s.imag * c[1]), s

    s_j = jstft.stft(jnp.asarray(x, jnp.bfloat16), n_fft, hop, **kw)
    c = rng.standard_normal((2, *s_j.shape)).astype(np.float32)
    (_, s_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(c))
    s_j, g_j = np.asarray(s_j), np.asarray(g_j.astype(jnp.float32))
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
        s = tstft.stft(xt, n_fft, hop, **kw)
        assert s.dtype == torch.complex64
        (s.real * torch.from_numpy(c[0])
         + s.imag * torch.from_numpy(c[1])).sum().backward()
        got[dtype] = (s.detach().numpy(), xt.grad.float().numpy())
    (s_b, g_b), (s_f, g_f) = got[torch.bfloat16], got[torch.float32]
    # the FFTs differ in float32 rounding only: 1.8e-7 and 2.1e-3 (the
    # float32 STFT) on the values; a rounding of the gradient flips to
    # its next bf16 value now and then, 5.6e-5 and 3.1e-3 on the VJP
    assert _rel(s_b, s_j) <= 1e-5 < _rel(s_f, s_j)
    assert _rel(g_b, g_j) <= 1e-3 < _rel(g_f, g_j)
