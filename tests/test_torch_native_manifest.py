"""The call convention of the port's exported steps, as a host without
Python reads it, against the programs themselves and against rave_tpu.

A host (``csrc/aoti_host.cpp``, ``native/pjrt_host.cpp``) passes the flat
inputs of a step in the order of its manifest's ``in`` lines and feeds
every output after ``y`` back in as the next block's caches, in the order
of the ``out`` lines.  So for ``forward.pt2``, ``convert.pt2`` and
``convert_pg.pt2`` the flat input and output shapes of the reloaded
program equal the manifest's, line by line, and the caches go in and come
out in the same order.  The JAX package's manifests of the same configs
(tiny ``v2`` of ``tests/test_torch_export.py``, tiny ``v2_fork`` +
``pitch`` of ``tests/test_torch_pitch_model.py``) have the same lines:
the chunk, the embedding, the f0 tail and ``y`` in the same places, and
the same caches.  The JAX package keeps each cache channels-last and
orders them by the keys of its cache tree, the port channels-first in
module order, so the caches are compared as a set of (bytes, shape)
with the port's ``(B, C, T)`` read as ``(B, T, C)``.  Shapes only: the
weights are random.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.export.streaming import StreamingRAVE as JStreamingRAVE
from rave_tpu.export.voice_conversion import VoiceConverter as JVoiceConverter
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu_torch.config import build_config
from rave_tpu_torch.export.native import flat_io_shapes
from rave_tpu_torch.export.streaming import StreamingRAVE
from rave_tpu_torch.export.voice_conversion import VoiceConverter
from rave_tpu_torch.models.rave import RAVE

TINY = {"v2": (["v2"], ["capacity=4", "n_signal=16384", "batch_size=1",
                        "ratios=[2,2]", "dilations=[[1,3],[1,3]]"]),
        "pitch": (["v2_fork", "pitch"],
                  ["capacity=4", "n_signal=8192", "ratios=[2,2]",
                   "dilations=[[1,3],[1,3]]"])}
CHUNK = 2048
MANIFEST = {"forward": "io_manifest.txt", "convert": "convert_manifest.txt",
            "convert_pg": "convert_pg_manifest.txt"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Per config, the directories the port's and the JAX package's
    ``serialize`` write: the stream's of ``v2``, the converter's of the
    pitch fork."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        stack, over = TINY[name]
        torch.manual_seed(0)
        cfg = build_config(stack, over)
        state = RAVE(cfg, device="cpu").state_dict()
        port = tmp_path_factory.mktemp(f"port_{name}")
        # the JAX side needs shapes only: zero parameters of the shapes
        # its init gives, without compiling the init
        jcfg = jbuild(stack, over)
        m = JRAVE(cfg=jcfg, train_mode=False)
        v = jax.eval_shape(
            lambda r, a: m.init(r, a, method=JRAVE.warmup),
            {"params": jax.random.PRNGKey(0),
             "latent": jax.random.PRNGKey(1),
             "noise": jax.random.PRNGKey(2)}, jnp.zeros((1, 8192, 1)))
        v = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), v)
        params = v["params"]
        model_state = ({"batch_stats": v["batch_stats"]}
                       if "batch_stats" in v else None)
        ref = tmp_path_factory.mktemp(f"jax_{name}")
        if cfg.speaker_embedding_size:
            VoiceConverter(cfg, state, chunk_size=CHUNK,
                           device="cpu").serialize(port)
            JVoiceConverter(jcfg, params, chunk_size=CHUNK,
                            model_state=model_state).serialize(str(ref))
        else:
            StreamingRAVE(cfg, state, chunk_size=CHUNK,
                          device="cpu").serialize(port)
            JStreamingRAVE(jcfg, params, chunk_size=CHUNK,
                           model_state=model_state).serialize(str(ref))
        cache[name] = (port, ref)
        return cache[name]

    return get


def _manifest(path):
    """(in lines, out lines) of a manifest, one ``(bytes, dims)`` each."""
    ins, outs = [], []
    for line in path.read_text().splitlines()[1:]:
        kind, dtype, nbytes, rank, *dims = line.split()
        assert dtype == "float32" and int(rank) == len(dims)
        (ins if kind == "in" else outs).append(
            (int(nbytes), tuple(int(d) for d in dims)))
    return ins, outs


@pytest.mark.parametrize("name,prefix", [
    ("v2", "forward"), ("pitch", "convert"), ("pitch", "convert_pg")])
def test_program_flattens_to_its_manifest(exported, name, prefix):
    port, _ = exported(name)
    ins, outs = flat_io_shapes(torch.export.load(port / f"{prefix}.pt2"))
    mins, mouts = _manifest(port / MANIFEST[prefix])
    assert ins == [d for _, d in mins]
    assert outs == [d for _, d in mouts]
    # every output after y is the next block's input of the same place
    n = len(mouts) - 1
    assert mins[:n] == mouts[1:]
    assert all(nb == 4 * int(np.prod(d)) for nb, d in mins + mouts)


def _as_jax(line):
    """A port cache line with its ``(B, C, T)`` read as ``(B, T, C)``."""
    nbytes, dims = line
    return nbytes, (dims[0], dims[2], dims[1]) if len(dims) == 3 else dims


@pytest.mark.parametrize("name,prefix", [
    ("v2", "forward"), ("pitch", "convert"), ("pitch", "convert_pg")])
def test_manifest_matches_jax(exported, name, prefix):
    port, ref = exported(name)
    tin, tout = _manifest(port / MANIFEST[prefix])
    jin, jout = _manifest(ref / MANIFEST[prefix])
    assert (len(tin), len(tout)) == (len(jin), len(jout))
    n = len(tout) - 1
    # the chunk and the other inputs, and y, in the same places
    assert tin[n:] == jin[n:] and tout[0] == jout[0]
    assert jin[:n] == jout[1:]
    caches = tin[:n]
    if prefix == "convert_pg":
        # the f0 tail is the carry's last leaf in both packages
        assert tin[n - 1] == jin[n - 1] == tout[-1] == jout[-1] == \
            (4096, (1, 1024))
        caches, jin = caches[:-1], jin[:n - 1]
    assert sorted(map(_as_jax, caches)) == sorted(jin[:len(caches)])
    assert ((port / MANIFEST[prefix]).read_text().splitlines()[0]
            == (ref / MANIFEST[prefix]).read_text().splitlines()[0])


def test_v3_forward_carries_adain_states_after_caches(tmp_path):
    """The ``v3`` stream's ``forward.pt2`` (the program a ``v3`` package is
    compiled from): its flat inputs and outputs are the manifest's, line
    by line, with one AdaIN state ``(1, C, 8)`` per AdaIN module after
    the conv caches, and ``cache_init.bin`` ends with their initial
    values.  ``torch.export`` only; the AOTInductor compile runs on the
    card (``chip_smoke.py``)."""
    stack = ["v3"]
    over = ["capacity=4", "n_signal=16384", "ratios=[2,2]",
            "dilations=[[1,3],[1,3]]"]
    torch.manual_seed(0)
    cfg = build_config(stack, over)
    sr = StreamingRAVE(cfg, RAVE(cfg, device="cpu").state_dict(),
                       chunk_size=CHUNK, device="cpu")
    out = sr.serialize(tmp_path)
    ins, outs = flat_io_shapes(torch.export.load(out / "forward.pt2"))
    mins, mouts = _manifest(out / "io_manifest.txt")
    assert ins == [d for _, d in mins] and outs == [d for _, d in mouts]
    n, k = len(sr.init_caches), sr.n_adain
    assert mins[:n] == mouts[1:] and mins[n] == (4 * CHUNK, (1, CHUNK, 1))
    # the encoder's and the decoder's AdaIN modules: one per residual unit
    assert k == 8
    widths = sorted(d[1] for _, d in mins[n - k:n])
    assert all(d[0] == 1 and d[2] == 8 for _, d in mins[n - k:n])
    assert widths == [4, 4, 4, 4, 8, 8, 8, 8]
    raw = np.fromfile(out / "cache_init.bin", "<f4")
    tail = np.concatenate([c.numpy().reshape(-1)
                           for c in sr.init_caches[n - k:]])
    np.testing.assert_array_equal(raw[raw.size - tail.size:], tail)
    assert raw.size == sum(nb for nb, _ in mins[:n]) // 4
