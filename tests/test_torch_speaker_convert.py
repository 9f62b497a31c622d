"""The reference's torch speaker checkpoint, converted by the port onto its
SpeakerRAVE and by rave_tpu onto the JAX one: the same embedding.

The reference checkout is absent, so the checkpoint is built here with
numpy in the reference's layout: keys under ``__S__.``, a bundled
``pqmf.*`` entry, the BatchNorms' ``num_batches_tracked``, and the
weight-normed convs either plain or as ``weight_g``/``weight_v`` pairs.
Tolerance: embeddings atol 1e-4 times their largest magnitude (as
``tests/test_torch_speaker.py``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.models import speaker_convert as jconv
from rave_tpu.models.speaker import SpeakerRAVE as JSpeaker
from rave_tpu_torch.config import build_config
from rave_tpu_torch.models import speaker_convert as tconv
from rave_tpu_torch.models.rave import RAVE

TINY = ["capacity=4", "n_signal=8192", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reference_checkpoint(weight_norm: bool, seed: int = 0) -> dict:
    """A reference-layout speaker state dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, out, inp, k, wn=weight_norm):
        w = rng.standard_normal((out, inp, k)) / np.sqrt(inp * k)
        if wn:
            sd[f"{name}.weight_v"] = w * rng.uniform(0.5, 2.0)
            sd[f"{name}.weight_g"] = rng.uniform(0.5, 1.5, (out, 1, 1))
        else:
            sd[f"{name}.weight"] = w
        sd[f"{name}.bias"] = 0.1 * rng.standard_normal(out)

    def batch_norm(name, n):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, n)
        sd[f"{name}.bias"] = 0.1 * rng.standard_normal(n)
        sd[f"{name}.running_mean"] = 0.1 * rng.standard_normal(n)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, n)
        sd[f"{name}.num_batches_tracked"] = np.array(1000)

    conv("in_layer", 128, 16, 7)
    for name, dim, out, ratio in (("layer2", 128, 256, 4),
                                  ("layer3", 256, 256, 4),
                                  ("layer4", 256, 256, 2)):
        conv(f"{name}.0.aligned.branches.0.net.1", dim, dim, 3)
        conv(f"{name}.0.aligned.branches.0.net.3", dim, dim, 1)
        conv(f"{name}.2", out, dim, 2 * ratio)
    conv("cat_layer", 256, 256, 1)
    conv("out_layer", 768, 768, 3)
    conv("attention.0", 128, 3 * 768, 1, wn=False)
    batch_norm("attention.2", 128)
    conv("attention.3", 768, 128, 1, wn=False)
    batch_norm("bn5", 1536)
    sd["fc6.weight"] = rng.standard_normal((256, 1536)) / np.sqrt(1536)
    sd["fc6.bias"] = 0.1 * rng.standard_normal(256)
    out = {f"__S__.{k}": np.asarray(v, np.float32 if np.ndim(v) else np.int64)
           for k, v in sd.items()}
    out["__S__.pqmf.hk"] = np.zeros(3, np.float32)
    return out


def _bands(seed=1):
    return (0.3 * np.random.default_rng(seed).standard_normal((2, 512, 16))
            ).astype(np.float32)


@pytest.mark.parametrize("weight_norm", [False, True],
                         ids=["plain", "weight_norm"])
def test_converted_embeddings_match_jax(weight_norm):
    sd = reference_checkpoint(weight_norm)
    bands = _bands()
    speaker_j, pqmf_j = jconv.strip_speaker_statedict(sd)
    params, stats = jconv.convert_speaker_state(speaker_j)
    want = np.asarray(JSpeaker().apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(bands)))

    speaker_t, pqmf_t = tconv.strip_speaker_statedict(sd)
    assert sorted(pqmf_t) == sorted(pqmf_j) == ["hk"]
    model = RAVE(build_config(["v2_fork"], TINY), device="cpu")
    tconv.install_speaker_weights(model,
                                  tconv.convert_speaker_state(speaker_t))
    got = model.speaker_embedding(torch.from_numpy(
        bands.transpose(0, 2, 1).copy())).numpy()
    assert got.shape == want.shape == (2, 256)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("wrapped", [False, True], ids=["flat", "state_dict"])
def test_checkpoint_round_trip(tmp_path, wrapped):
    """``torch.save`` of the reference dict (flat, or under
    ``state_dict``) read back by both packages' ``load_speaker_checkpoint``
    gives the direct conversion."""
    sd = reference_checkpoint(True, seed=2)
    blob = {k: torch.from_numpy(v) for k, v in sd.items()}
    path = tmp_path / "speaker.ckpt"
    torch.save({"state_dict": blob} if wrapped else blob, path)
    want = tconv.convert_speaker_state(tconv.strip_speaker_statedict(sd)[0])
    got = tconv.load_speaker_checkpoint(str(path))
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    params, stats = jconv.load_speaker_checkpoint(str(path))
    assert params["fc6"]["kernel"].shape == (1536, 256)
    np.testing.assert_array_equal(params["fc6"]["kernel"].T,
                                  got["fc6.weight"].numpy())
    np.testing.assert_array_equal(stats["bn5"]["var"],
                                  got["bn5.running_var"].numpy())


def _jax_state():
    """A stand-in for rave_tpu's TrainState, holding the speaker subtree
    of a fresh JAX SpeakerRAVE (all ``install_speaker_weights`` reads)."""
    v = JSpeaker().init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 16)))
    return types.SimpleNamespace(
        gen_params={"speaker_encoder": v["params"]},
        model_state={"batch_stats": {"speaker_encoder": v["batch_stats"]}})


@pytest.mark.parametrize("fault", ["transposed", "missing", "cohort_model"])
def test_layout_faults_raise_in_both(fault):
    """A transposed leaf (the right size, another shape) is refused, not
    reshaped; a missing key raises; a BatchNorm checkpoint does not
    install into a cohort-norm encoder, which has no stored statistics."""
    sd = reference_checkpoint(False, seed=3)
    cfg_over = TINY
    state_j = _jax_state()
    if fault == "transposed":
        sd["__S__.fc6.weight"] = sd["__S__.fc6.weight"].T.copy()
    elif fault == "missing":
        del sd["__S__.bn5.running_var"]
    else:
        cfg_over = TINY + ["speaker_norm=cohort"]
        state_j.model_state = {"batch_stats": {}}
    speaker = jconv.strip_speaker_statedict(sd)[0]
    model = RAVE(build_config(["v2_fork"], cfg_over), device="cpu")
    if fault == "missing":
        with pytest.raises(KeyError):
            jconv.convert_speaker_state(speaker)
        with pytest.raises(KeyError):
            tconv.convert_speaker_state(speaker)
        return
    params, stats = jconv.convert_speaker_state(speaker)
    with pytest.raises(ValueError):
        jconv.install_speaker_weights(state_j, params, stats)
    with pytest.raises(ValueError):
        tconv.install_speaker_weights(model,
                                      tconv.convert_speaker_state(speaker))
