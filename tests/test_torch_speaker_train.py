"""The port's from-scratch speaker training against rave_tpu's train step.

One D, G, G, G sequence from ``phase_1_duration`` of the tiny fork with
``train_speaker_encoder=true speaker_classes=4 latent_adversary_weight=0.5``
(cohort norm by ``auto``; the BatchNorm copy is
``tests/test_torch_speaker_train_bn.py``, a file of its own so that the
two JAX compiles land on different workers), at B = 4 with four distinct
speaker ids: at B = 2 the cohort norm maps every input to +-1 and its
gradient vanishes, so the check would prove nothing.  Then port-only
checks: the gradient reversal, a frozen encoder beside a trained head,
and the SPK Adam group.

Tolerances as ``tests/test_torch_train.py``: metrics rel 1e-4 each step;
each tensor's update within 3 lr per step taken of the JAX update, and
within 10 % of its 2-norm.  Running statistics of the BatchNorm copy
rtol 1e-4 after every step.

Adam's first step moves every element by lr times the sign of its
gradient, so an element whose gradient is below the float32 rounding of
the sums moves by lr either way.  Exempt from the 10 % check for that
reason (measured on the port: its float32 and float64 gradients of the
same step differ in sign there, while their 2-norms agree to 1.3e-5):
the tensors no loss reaches, the encoder's last bias (the CE projection's
LayerNorm over time removes it) and the speaker encoder's ``attn_bn`` and
``attn2`` biases (per-channel constants before a softmax over time), and
the attention pooling's first layer ``attn1`` (6 % of its weight's and
24 % of its bias's elements).  The speaker group therefore runs at
``speaker_learning_rate=1e-6`` here: at 1e-4 the first G step's random
moves of those elements, across the whole cohort-whitened encoder, take
the AAM CE from 8.2 to 0.013, where its value on the next step depends
on them (0.4 % between the frameworks, while the port's forward on the
JAX package's parameters of that step is within 1e-5 of its loss).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.train import loop as jloop
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import (load_discriminator_params,
                                    load_flax_params)
from rave_tpu_torch.train import loop, schedules

TINY = ["capacity=4", "n_signal=8192", "batch_size=4", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]"]
SPK = ["train_speaker_encoder=true", "speaker_classes=4",
       "latent_adversary_weight=0.5"]
B = 4
# the parity runs' speaker learning rate (see the module docstring)
SLOW_SPK = "speaker_learning_rate=1e-6"


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one CPU thread: beside the suite's other workers,
    several threads per process oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(cfg, jstate, step):
    state = loop.TrainState(cfg, device="cpu", step=step)
    stats = jstate.model_state.get("batch_stats")
    load_flax_params(state.model, _np(jstate.gen_params),
                     None if stats is None else _np(stats))
    load_discriminator_params(state.disc, _np(jstate.dis_params))
    return state


def _named(state):
    return {**{"gen/" + k: v.clone()
               for k, v in state.model.state_dict().items()},
            **{"dis/" + k: v.clone()
               for k, v in state.disc.state_dict().items()}}


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((B, cfg.n_signal, 1))).astype(np.float32)
    # a seeded gain and echo variant stands in for the perturbed view
    xp = (0.8 * x + 0.1 * np.roll(x, 7, axis=1)).astype(np.float32)
    units = rng.integers(0, 100, (B, 148))
    speaker = np.arange(B)
    return ({"x": jnp.asarray(x), "x_perturbed": jnp.asarray(xp),
             "units": jnp.asarray(units),
             "speaker": jnp.asarray(speaker, jnp.int32)},
            {"x": torch.from_numpy(x), "x_perturbed": torch.from_numpy(xp),
             "units": torch.from_numpy(units),
             "speaker": torch.from_numpy(speaker)})


def _bn_stats(state):
    spk = state.model.speaker_encoder
    return {f"{n}/{leaf}": getattr(getattr(spk, n), f"running_{leaf}")
            .numpy().copy() for n in ("attn_bn", "bn5")
            for leaf in ("mean", "var")}


def _jax_bn_stats(jstate):
    st = _np(jstate.model_state["batch_stats"]["speaker_encoder"])
    return {f"{n}/{leaf}": st[n][leaf] for n in ("attn_bn", "bn5")
            for leaf in ("mean", "var")}


def run_speaker_parity(extra):
    """D, G, G, G of both packages from one converted state; returns the
    port's state and the parameters before and after."""
    over = TINY + SPK + [SLOW_SPK] + extra
    jcfg, cfg = jbuild(["v2_fork"], over), build_config(["v2_fork"], over)
    batch_norm = "speaker_norm=batch" in extra
    start = cfg.phase_1_duration
    jstate = jloop.init_state(jcfg, jax.random.PRNGKey(0))
    jstate = jstate.replace(step=jnp.asarray(start, jnp.int32))
    if batch_norm:
        # stored statistics away from the 0 / 1 of a fresh BatchNorm
        rng = np.random.default_rng(5)
        bs = _np(jstate.model_state["batch_stats"])
        for s in bs["speaker_encoder"].values():
            s["mean"] = (0.1 * rng.standard_normal(s["mean"].shape)
                         ).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(
                np.float32)
        jstate = jstate.replace(model_state={**jstate.model_state,
                                             "batch_stats": bs})
    else:
        assert "batch_stats" not in jstate.model_state
    state = _port_state(cfg, jstate, start)
    assert state.model.speaker_encoder.train_bn == batch_norm
    before = _named(state)

    jb, tb = _batch(cfg)
    jstep = jax.jit(jloop.make_train_step(jcfg))
    step = loop.make_train_step(cfg)
    kinds = []
    for i in range(4):
        kinds.append("D" if schedules.is_discriminator_step(state.step, cfg)
                     else "G")
        jstate, mj = jstep(jstate, jb, jax.random.PRNGKey(1))
        mt = step(state, tb)
        mj = {k: float(v) for k, v in mj.items()}
        assert sorted(mt) == sorted(mj)
        for k in mj:
            assert float(mt[k]) == pytest.approx(mj[k], rel=1e-4, abs=1e-7), (
                i, k, float(mt[k]), mj[k])
        if kinds[-1] == "G":
            assert mj["loss_speaker_ce"] > 0 and mj["loss_latent_adversary"] > 0
        if batch_norm:
            got, want = _bn_stats(state), _jax_bn_stats(jstate)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-8, err_msg=f"{i} {k}")
    assert kinds == ["D", "G", "G", "G"] and state.step == start + 4
    return cfg, state, before, _named(_port_state(cfg, jstate, start))


def check_updates(cfg, state, before, want):
    got = _named(state)
    lrs = {"gen/speaker_": cfg.speaker_learning_rate or cfg.learning_rate,
           "gen/latent_adversary": cfg.speaker_learning_rate
           or cfg.learning_rate}
    last = len(state.model.encoder.layers) - 1
    noise = {f"gen/encoder.layers.{last}.1.bias"} | {
        f"gen/speaker_encoder.{n}" for n in (
            "attn1.weight", "attn1.bias", "attn_bn.bias", "attn2.bias")}
    worst, bad = [], []
    for k in got:
        if not got[k].is_floating_point() or ".running_" in k:
            continue
        lr = next((v for p, v in lrs.items() if k.startswith(p)),
                  cfg.learning_rate)
        steps = 1 if k.startswith("dis/") else 3
        d_got, d_want = got[k] - before[k], want[k] - before[k]
        err = float((d_got - d_want).abs().max())
        assert err <= 3 * lr * steps, (k, err / lr)
        scale = float(d_want.norm())
        if scale == 0:
            assert float(d_got.norm()) == 0, k
            continue
        rel = float((d_got - d_want).norm()) / scale
        worst.append((rel, err / lr, k))
        if k not in noise and rel > 0.1:
            bad.append((k, rel, err / lr))
    assert not bad, bad
    worst.sort(reverse=True)
    print("largest update differences (relative 2-norm, max / lr, tensor):",
          worst[:4])
    moved = lambda pre: any(not torch.equal(got[k], before[k])  # noqa: E731
                            for k in got if k.startswith(pre))
    for pre in ("gen/encoder.", "gen/decoder.", "gen/ce_projection.",
                "gen/speaker_encoder.", "gen/speaker_classifier.",
                "gen/latent_adversary.", "dis/"):
        assert moved(pre), pre


def test_cohort_speaker_train_steps_match():
    cfg, state, before, want = run_speaker_parity([])
    check_updates(cfg, state, before, want)


def _tiny_state(extra, step_offset=1):
    cfg = build_config(["v2_fork"], TINY + extra)
    torch.manual_seed(0)
    return cfg, loop.TrainState(cfg, device="cpu",
                                step=cfg.phase_1_duration + step_offset)


def test_gradient_reversal_scales_the_encoder_gradient():
    """Adversary CE through the reversal: the encoder's gradient is -lambda
    times that of the same CE on the plain latent, the head's is equal
    (each tensor to rel 1e-5 in 2-norm, in float64)."""
    cfg, state = _tiny_state(SPK + ["hubert_units=0"])
    # float64, so that the comparison sees the reversal, not rounding
    model, lam = state.model.double(), cfg.latent_adversary_weight
    _, tb = _batch(cfg)
    tb["x"] = tb["x"].double()
    z = model.encode_input(model.pqmf_forward(tb["x"]))
    enc = list(model.encoder.parameters())
    head = list(model.latent_adversary.parameters())
    emb = model.speaker_embedding(model.pqmf_forward(tb["x"]))
    rev = loop.speaker_terms(cfg, model, z, emb, tb["speaker"])["adv_ce"]
    plain = loop._class_ce(model.adversary_logits(z), tb["speaker"],
                           cfg.speaker_classes)
    assert float(rev) == pytest.approx(float(plain), rel=1e-6)
    g_rev = torch.autograd.grad(rev, enc + head, retain_graph=True)
    g_plain = torch.autograd.grad(plain, enc + head)
    for i, (a, b) in enumerate(zip(g_rev, g_plain)):
        want = -lam * b if i < len(enc) else b
        scale = float(want.norm())
        assert scale > 0
        assert float((a - want).norm()) <= 1e-5 * scale, i


def test_frozen_speaker_encoder_with_a_trained_head():
    """``train_speaker_encoder=false speaker_classes=4``: a G step moves the
    AAM head, never the (BatchNorm, stored-statistics) speaker encoder."""
    cfg, state = _tiny_state(["speaker_classes=4"])
    assert loop.spk_group(cfg) == ("speaker_classifier",)
    spk = state.model.speaker_encoder
    assert not spk.train_bn
    assert not any(p.requires_grad for p in spk.parameters())
    enc_before = {k: v.clone() for k, v in spk.state_dict().items()}
    head_before = state.model.speaker_classifier.weight.detach().clone()
    metrics = loop.make_train_step(cfg)(state, _batch(cfg)[1])
    assert float(metrics["loss_speaker_ce"]) > 0
    assert all(torch.equal(v, enc_before[k])
               for k, v in spk.state_dict().items())
    assert not torch.equal(state.model.speaker_classifier.weight, head_before)


def test_speaker_group_without_speaker_ids_gets_zero_gradients():
    """No ``speaker`` in the batch: the SPK group's loss terms are absent,
    its gradients zero, so Adam leaves the head where it was (optax's
    update of a zero gradient is zero)."""
    cfg, state = _tiny_state(SPK)
    head = state.model.speaker_classifier.weight
    before = head.detach().clone()
    batch = {k: v for k, v in _batch(cfg)[1].items() if k != "speaker"}
    metrics = loop.make_train_step(cfg)(state, batch)
    assert float(metrics["loss_speaker_ce"]) == 0.0
    assert float(head.grad.abs().max()) == 0.0
    assert torch.equal(head, before)
    assert state.spk_opt.state[head]["step"] == 1
