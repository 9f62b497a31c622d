"""The C++ host ``csrc/aoti_host.cpp`` serving AOTInductor packages of the
port's exported steps with no Python, on the CPU, against the port's
``.pt2`` programs and against rave_tpu.

Tiny ``v2`` (``tests/test_torch_export.py``'s) and tiny ``v2_fork`` +
``pitch`` (``tests/test_torch_pitch_model.py``'s) on converted
parameters, chunk 2048.  ``forward`` and ``convert_pg`` are compiled for
the CPU (``export/native.py``); the host, built from the checkout's
source, streams 4 seeded blocks through each (``x_in``) and writes every
block of its blocking loop (``y_out``) and its last caches
(``carry_out``).  Each block and the caches equal the reloaded program
over the same blocks from the initial caches (atol 1e-5: the compiled
kernels sum in another order; the f0 tail exactly), and each block the
JAX package's ``StreamingRAVE.forward`` / exported ``convert_pg`` (atol
2e-5, the export tests' tolerance).  A manifest whose ``out`` lines are permuted
makes the host exit 1 (the check that catches a program whose outputs
are not in its manifest's order), and a missing package raises in
``run_host``.
"""
import os
import shutil
import types
from concurrent.futures import ThreadPoolExecutor

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
from rave_tpu_torch.convert import load_flax_params
from rave_tpu_torch.export import native
from rave_tpu_torch.export.streaming import StreamingRAVE
from rave_tpu_torch.export.voice_conversion import VoiceConverter
from rave_tpu_torch.models.rave import RAVE

TINY_V2 = ["capacity=4", "n_signal=16384", "batch_size=1", "ratios=[2,2]",
           "dilations=[[1,3],[1,3]]"]
TINY_FORK = ["capacity=4", "n_signal=8192", "ratios=[2,2]",
             "dilations=[[1,3],[1,3]]"]
CHUNK, BLOCKS = 2048, 4
PROGRAM_ATOL = 1e-5
ATOL = 2e-5
KEYS = {"blocks", "pipelined_blocks_per_s", "pipelined_rtf", "blocking_rtf",
        "checksum", "block_ms_p50", "block_ms_p80", "loaded_s"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch and one OpenMP thread here and in the host: beside the
    suite's other workers, more oversubscribe the cores."""
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = omp


@pytest.fixture(scope="module")
def host():
    """The host binary, built in a thread while the packages compile."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(native.build_host, "cpu")


def _converted(stack, over):
    jcfg = jbuild(stack, over)
    m = JRAVE(cfg=jcfg, train_mode=False)
    v = jax.jit(lambda r, a: m.init(r, a, method=JRAVE.warmup))(
        {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2)}, jnp.zeros((1, 8192, 1)))
    params = jax.tree.map(np.asarray, v["params"])
    stats = (jax.tree.map(np.asarray, v["batch_stats"])
             if "batch_stats" in v else None)
    cfg = build_config(stack, over)
    model = RAVE(cfg, device="cpu")
    load_flax_params(model, params, stats)
    return jcfg, params, ({"batch_stats": stats} if stats else None), cfg, \
        model.state_dict()


def _blocks(seed):
    """``BLOCKS`` chunks of a gliding tone with noise, so that YIN is
    voiced and every block differs."""
    t = np.arange(BLOCKS * CHUNK) / 44100
    x = 0.3 * np.sin(2 * np.pi * (140 * t + 150 * t * t))
    x += 0.03 * np.random.default_rng(seed).standard_normal(len(t))
    return x.astype(np.float32).reshape(BLOCKS, 1, CHUNK, 1)


@pytest.fixture(scope="module")
def forward_pkg(host, tmp_path_factory):
    """Tiny ``v2``: its exported stream, ``forward.aoti.pt2``, the JAX
    stream of the same parameters."""
    jcfg, params, model_state, cfg, state = _converted(["v2"], TINY_V2)
    out = tmp_path_factory.mktemp("native_v2")
    ts = StreamingRAVE(cfg, state, chunk_size=CHUNK, device="cpu")
    ts.serialize(out)
    package, seconds = native.compile_package(out, "forward", "cpu")
    js = JStreamingRAVE(jcfg, params, chunk_size=CHUNK,
                        model_state=model_state)
    return types.SimpleNamespace(out=out, package=package, ts=ts, js=js)


@pytest.fixture(scope="module")
def convert_pg_pkg(host, tmp_path_factory):
    """Tiny ``v2_fork`` + ``pitch``: its exported converter,
    ``convert_pg.aoti.pt2``, the JAX package's exported ``convert_pg``."""
    jcfg, params, model_state, cfg, state = _converted(
        ["v2_fork", "pitch"], TINY_FORK)
    out = tmp_path_factory.mktemp("native_pg")
    vc = VoiceConverter(cfg, state, chunk_size=CHUNK, device="cpu")
    vc.serialize(out)
    package, seconds = native.compile_package(out, "convert_pg", "cpu")
    jout = tmp_path_factory.mktemp("native_pg_jax")
    jvc = JVoiceConverter(jcfg, params, chunk_size=CHUNK,
                          model_state=model_state)
    jvc.serialize(str(jout))
    from jax import export as jexport
    jprog = jexport.deserialize((jout / "convert_pg.stablehlo").read_bytes())
    return types.SimpleNamespace(out=out, package=package, vc=vc, jvc=jvc,
                                 jprog=jprog)


def _serve(host, out, prefix, x, tmp_path):
    """The host over the blocks ``x``: its blocking loop's outputs and
    its last caches, flat."""
    x.tofile(tmp_path / "x.bin")
    res = native.run_host(out, BLOCKS, prefix, "cpu",
                          x_in=str(tmp_path / "x.bin"),
                          y_out=str(tmp_path / "y.bin"),
                          carry_out=str(tmp_path / "carry.bin"),
                          host=host.result())
    assert KEYS <= set(res) and res["blocks"] == BLOCKS
    assert res["device"] == "cpu" and not res["cuda_graph"]
    y = np.fromfile(tmp_path / "y.bin", np.float32).reshape(x.shape)
    assert np.isfinite(y).all() and np.abs(y).max() > 0
    assert res["checksum"] == pytest.approx(float(y[-1].sum()), abs=1e-3)
    return y, np.fromfile(tmp_path / "carry.bin", np.float32)


def _flat(tensors):
    return np.concatenate([t.numpy().reshape(-1) for t in tensors])


def test_host_serves_forward(host, forward_pkg, tmp_path):
    p = forward_pkg
    x = _blocks(seed=1)
    y, carry = _serve(host, p.out, "forward", x, tmp_path)
    prog = torch.export.load(p.out / "forward.pt2").module()
    caches = [torch.zeros_like(c) for c in p.ts.init_caches]
    p.js.reset()
    with torch.no_grad():
        for b in range(BLOCKS):
            want, caches = prog(caches, torch.from_numpy(x[b]))
            np.testing.assert_allclose(y[b], want.numpy(), atol=PROGRAM_ATOL)
            np.testing.assert_allclose(y[b], np.asarray(p.js.forward(x[b])),
                                       atol=ATOL)
    np.testing.assert_allclose(carry, _flat(caches), atol=PROGRAM_ATOL)


def test_host_serves_convert_pg(host, convert_pg_pkg, tmp_path):
    p = convert_pg_pkg
    x = _blocks(seed=2)
    y, host_carry = _serve(host, p.out, "convert_pg", x, tmp_path)
    prog = torch.export.load(p.out / "convert_pg.pt2").module()
    carry = [*(torch.zeros_like(c) for c in p.vc.stream.init_caches),
             torch.zeros(1, 1024)]
    # the host's inputs other than the chunk are zeros: the embedding too
    emb = np.zeros(256, np.float32)
    jcarry = {"cache": jax.tree.map(jnp.zeros_like, p.jvc.init_cache),
              "f0_tail": jnp.zeros((1, 1024), jnp.float32)}
    with torch.no_grad():
        for b in range(BLOCKS):
            want, carry = prog(carry, torch.from_numpy(x[b]),
                               torch.from_numpy(emb))
            np.testing.assert_allclose(y[b], want.numpy(), atol=PROGRAM_ATOL)
            jy, jcarry = p.jprog.call(jcarry, jnp.asarray(x[b]),
                                      jnp.asarray(emb))
            np.testing.assert_allclose(y[b], np.asarray(jy), atol=ATOL)
    # the caches, and the f0 tail (the end of the last block) exactly
    np.testing.assert_allclose(host_carry, _flat(carry), atol=PROGRAM_ATOL)
    np.testing.assert_array_equal(host_carry[-1024:], x[-1, 0, -1024:, 0])
    np.testing.assert_array_equal(carry[-1].numpy()[0], x[-1, 0, -1024:, 0])


def _copy_export(src, dst, prefix):
    """The files a host reads for ``prefix``, the package linked."""
    dst.mkdir()
    for p in src.iterdir():
        if p.suffix in (".txt", ".bin"):
            shutil.copy(p, dst / p.name)
    (dst / f"{prefix}.aoti.pt2").symlink_to(src / f"{prefix}.aoti.pt2")


@pytest.mark.parametrize("prefix", ["forward", "convert_pg"])
def test_permuted_manifest_exits_1(host, forward_pkg, convert_pg_pkg, prefix,
                                   tmp_path):
    """The ``out`` lines rotated by one (the first output last): the
    host names the first output whose shape is not the package's."""
    src = (forward_pkg if prefix == "forward" else convert_pg_pkg).out
    d = tmp_path / "permuted"
    _copy_export(src, d, prefix)
    name = "io_manifest.txt" if prefix == "forward" else \
        f"{prefix}_manifest.txt"
    lines = (d / name).read_text().splitlines()
    outs = [ln for ln in lines if ln.startswith("out ")]
    (d / name).write_text("\n".join(
        [ln for ln in lines if not ln.startswith("out ")]
        + outs[1:] + outs[:1]) + "\n")
    with pytest.raises(RuntimeError, match=r"(?s)exited 1: .*output 0 has "
                       r"shape \(1, 2048, 1\), the manifest"):
        native.run_host(d, BLOCKS, prefix, "cpu", host=host.result())


def test_missing_package_raises(host, forward_pkg, tmp_path):
    d = tmp_path / "no_package"
    _copy_export(forward_pkg.out, d, "forward")
    (d / "forward.aoti.pt2").unlink()
    with pytest.raises(RuntimeError, match=r"(?s)exited 1: .*cannot open "
                       r".*forward\.aoti\.pt2"):
        native.run_host(d, BLOCKS, "forward", "cpu", host=host.result())


def test_the_card_is_the_default(host, forward_pkg):
    """Without ``device``, each entry point asks for the card: on a
    machine without CUDA the compile and the build raise, and the CPU's
    host refuses ``device=cuda``; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        native.compile_package(forward_pkg.out, "forward")
    with pytest.raises(RuntimeError, match="built without CUDA"):
        native.build_host()
    with pytest.raises(RuntimeError, match="(?s)exited 1: .*this host was "
                       "built without CUDA"):
        native.run_host(forward_pkg.out, BLOCKS, "forward", "cuda",
                        host=host.result())
