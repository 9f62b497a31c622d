"""Port StreamingRAVE vs rave_tpu's StreamingRAVE on tiny v2, chunk by
chunk, and the port's streamed output vs its own offline output after
delay compensation (the idiom of tests/test_streaming.py).

Tolerance for chunk equality: atol 2e-5 (float32 through the streamed
graph, sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.export.streaming import StreamingRAVE as JStreamingRAVE
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu.models.rave import band_frame_delay as jband
from rave_tpu.ops.conv import StreamSetup as JSS
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import load_flax_params
from rave_tpu_torch.export.streaming import StreamingRAVE
from rave_tpu_torch.models.rave import RAVE

TINY = ["capacity=4", "n_signal=16384", "batch_size=1",
        "ratios=[2,2]", "dilations=[[1,3],[1,3]]"]
CHUNK = 2048
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """``get(stack, seed)``: the JAX config and parameters of ``stack``
    (initialised once per stack for the module), the port's offline model
    on them and a seeded input."""
    inits = {}

    def get(stack, seed=7):
        key = tuple(stack)
        if key not in inits:
            cfg = jbuild(stack, TINY)
            v = jax.jit(JRAVE(cfg=cfg, train_mode=False).init)(
                {"params": jax.random.PRNGKey(0),
                 "latent": jax.random.PRNGKey(1),
                 "noise": jax.random.PRNGKey(2)},
                jnp.zeros((1, 16384, 1), jnp.float32))
            inits[key] = (cfg, v["params"])
        cfg, params = inits[key]
        x = (np.random.default_rng(seed).standard_normal((1, 16384, 1))
             * 0.3).astype(np.float32)
        offline = RAVE(build_config(stack, TINY), device="cpu")
        load_flax_params(offline, jax.tree.map(np.asarray, params))
        return cfg, params, offline, x

    return get


@pytest.mark.parametrize("stack", [["v2"], ["v2", "causal"]],
                         ids=["v2", "v2+causal"])
def test_chunks_equal_jax_streaming(stack, setup):
    cfg, params, offline, x = setup(stack)
    js = JStreamingRAVE(cfg, params, chunk_size=CHUNK)
    ts = StreamingRAVE(build_config(stack, TINY), offline.state_dict(),
                       chunk_size=CHUNK, device="cpu")
    assert ts.total_delay_samples() == js.total_delay_samples()
    mode = "causal" if cfg.causal else "centered"
    assert ts.model.band_delay == jband(cfg, JSS(mode=mode, streaming=True))
    for i in range(0, x.shape[1], CHUNK):
        xc = x[:, i:i + CHUNK]
        np.testing.assert_allclose(ts.forward(xc).numpy(), js.forward(xc),
                                   atol=ATOL)
    # the split encode / decode surface carries the same caches
    js.reset()
    ts.reset()
    for i in range(0, 4 * CHUNK, CHUNK):
        xc = x[:, i:i + CHUNK]
        z_j, z_t = js.encode(xc), ts.encode(xc).numpy()
        assert z_t.shape == z_j.shape == (1, CHUNK // cfg.total_ratio(),
                                          cfg.latent_size)
        np.testing.assert_allclose(z_t, z_j, atol=ATOL)
        np.testing.assert_allclose(ts.decode(z_j).numpy(), js.decode(z_j),
                                   atol=ATOL)


def test_stream_equals_own_offline_after_delay(setup):
    _, _, offline, x = setup(["v2"], seed=3)
    with torch.no_grad():
        y_off = offline(torch.from_numpy(x)).numpy()[0, :, 0]
    ts = StreamingRAVE(build_config(["v2"], TINY), offline.state_dict(),
                       chunk_size=CHUNK, device="cpu")
    y_str = ts.process_file(x[0, :, 0])
    d = ts.total_delay_samples()
    n = len(y_off)
    assert 0 < d < n // 2
    m = 2 * d + 256
    a, b = y_off[m - d: n - d - 256], y_str[m: n - 256]
    rel = np.median(np.abs(a - b)) / (np.abs(a).mean() + 1e-9)
    assert rel < 0.02, rel
    # process_file resets: a second pass is identical
    np.testing.assert_array_equal(ts.process_file(x[0, :, 0]), y_str)


def test_unported_streaming_options_raise():
    cfg = build_config(["v2"], TINY)
    state = RAVE(cfg, device="cpu").state_dict()
    # stereo and the host-rate resampler are ported
    # (tests/test_torch_resampler.py), AdaIN's controls too
    # (tests/test_torch_v3.py), which refuse stereo, the spherical head
    # (tests/test_torch_latent_heads.py) and the mel front end
    # (tests/test_torch_hybrid.py), which refuses a chunk off its hop
    with pytest.raises(ValueError, match="stereo"):
        StreamingRAVE(build_config(["v2", "adain"], TINY), state,
                      stereo=True, device="cpu")
    with pytest.raises(ValueError, match="multiple of mel_hop 128"):
        StreamingRAVE(build_config(["hybrid"], TINY), state,
                      chunk_size=3 * 64, device="cpu")
    with pytest.raises(ValueError, match="integer multiple"):
        StreamingRAVE(cfg, state, target_sr=3 * cfg.sampling_rate // 2,
                      device="cpu")
    with pytest.raises(ValueError):
        StreamingRAVE(cfg, state, chunk_size=100, device="cpu")
