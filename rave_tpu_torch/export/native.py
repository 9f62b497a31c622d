"""Serving exported steps without Python: AOTInductor packages and the
C++ host ``csrc/aoti_host.cpp``.

Port of what ``native/pjrt_host.cpp`` compiles when it starts (its
``<prefix>.mlir`` and ``compile_options.pb``) and of ``native/Makefile``:

* :func:`compile_package` turns an exported step ``<prefix>.pt2`` (from
  ``StreamingRAVE.serialize`` or ``VoiceConverter.serialize``) into an
  AOTInductor package ``<prefix>.aoti.pt2`` beside it, compiled for the
  device the program was exported on, with the weights inside and the
  step's flat input and output shapes in its metadata (the host holds
  them against the manifest);
* :func:`build_host` compiles ``csrc/aoti_host.cpp`` with ``g++`` against
  the installed libtorch (with CUDA where torch has it);
* :func:`run_host` runs the host and returns its JSON line.

A package is compiled explicitly, once, before a host serves it:

    python -m rave_tpu_torch.export.native <export_dir> \\
        [--prefix forward convert convert_pg] [--device cuda]

compiles the packages of the given prefixes (by default every one whose
``.pt2`` is in the directory) and builds the host.  A failed compile or
build raises; nothing falls back to running the program in Python.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
import zipfile
from pathlib import Path
from typing import Optional

import torch

from .. import resolve_device
from ..ops.kernels.build import build_host_program

# the steps the JAX package writes host artifacts for
PREFIXES = ("forward", "convert", "convert_pg")
HOST_TIMEOUT = 900       # s, one run of the host


def flat_io_shapes(ep) -> tuple[list, list]:
    """The shapes of an exported program's flat user inputs and outputs,
    in the order a host passes and receives them."""
    from torch.export.graph_signature import OutputKind
    nodes = {n.name: n for n in ep.graph.nodes}
    ins = [tuple(nodes[name].meta["val"].shape)
           for name in ep.graph_signature.user_inputs]
    out = next(n for n in ep.graph.nodes if n.op == "output")
    outs = [tuple(a.meta["val"].shape)
            for a, spec in zip(out.args[0], ep.graph_signature.output_specs)
            if spec.kind == OutputKind.USER_OUTPUT]
    return ins, outs


def _shapes_text(shapes) -> str:
    return ";".join(",".join(str(d) for d in s) for s in shapes)


def program_device(ep) -> torch.device:
    """The device of an exported program's weights."""
    for t in (*ep.state_dict.values(), *ep.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError("the exported program holds no tensor")


def proxy_ops(package: Path) -> list:
    """The operators an AOTInductor package runs through the proxy
    executor (those without a C shim), from the extern-kernel nodes the
    package carries."""
    ops = set()
    with zipfile.ZipFile(package) as z:
        for name in z.namelist():
            if name.endswith(".json") and not name.endswith("metadata.json"):
                nodes = json.loads(z.read(name)).get("nodes", [])
                ops.update(n["node"]["target"] for n in nodes)
    return sorted(ops)


def _links_openmp(cxx: str) -> bool:
    r = subprocess.run([cxx, "-print-file-name=libgomp.spec"],
                       capture_output=True, text=True)
    return r.returncode == 0 and os.path.isabs(r.stdout.strip())


def inductor_cxx() -> str:
    """The C++ compiler AOTInductor builds a package with: ``$CXX`` (its
    own default) where that compiler can link OpenMP, which Inductor
    always asks for on Linux, else ``g++`` on ``PATH``.  (A toolchain
    whose ``g++`` lacks ``libgomp.spec`` compiles a package's objects and
    fails at its link.)  Raises if neither can."""
    for cxx in (os.environ.get("CXX"), shutil.which("g++")):
        if cxx and _links_openmp(cxx):
            return cxx
    raise RuntimeError("no C++ compiler that links OpenMP for AOTInductor: "
                       f"$CXX={os.environ.get('CXX')!r} and g++ on PATH "
                       "lack libgomp.spec")


def compile_package(export_dir, prefix: str = "forward",
                    device="cuda") -> tuple[Path, float]:
    """``<export_dir>/<prefix>.pt2`` AOTInductor-compiled and packaged to
    ``<prefix>.aoti.pt2`` beside it, for ``device``, which must be the
    device the program was exported on; returns the package's path and
    the seconds the compile took.  Raises if the program is missing, was
    exported on another device or does not compile."""
    if prefix not in PREFIXES:
        raise ValueError(f"prefix must be one of {PREFIXES}, got {prefix!r}")
    device = resolve_device(device)
    src = Path(export_dir) / f"{prefix}.pt2"
    ep = torch.export.load(src)
    if program_device(ep).type != device.type:
        raise ValueError(f"{src} was exported on {program_device(ep)}; "
                         f"export it on {device} to compile it for {device}")
    ins, outs = flat_io_shapes(ep)
    out = src.with_name(f"{prefix}.aoti.pt2")
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    with torch._inductor.config.patch({"cpp.cxx": (None, inductor_cxx())}):
        torch._inductor.aoti_compile_and_package(
            ep, package_path=str(out),
            inductor_configs={"aot_inductor.metadata": {
                "rave_in_shapes": _shapes_text(ins),
                "rave_out_shapes": _shapes_text(outs)}})
    return out, time.perf_counter() - t0


def host_flags(cuda: bool) -> list:
    """The ``g++`` flags that build a program against the installed
    libtorch (and its CUDA libraries with ``cuda``)."""
    from torch.utils import cpp_extension as ext
    kind = "cuda" if cuda else "cpu"
    libs = ext.library_paths(device_type=kind)
    flags = ["-O2", "-std=c++17",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             *(f"-I{p}" for p in ext.include_paths(device_type=kind)),
             *(f"-L{p}" for p in libs),
             *(f"-Wl,-rpath,{p}" for p in libs),
             "-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", "-lc10"]
    if cuda:
        flags = ["-DAOTI_HOST_CUDA", *flags, "-ltorch_cuda", "-lc10_cuda",
                 "-lcudart"]
    return flags


def build_host(device="cuda") -> Path:
    """``csrc/aoti_host.cpp`` compiled by ``g++`` into ``_build/`` (once
    per source and flags): with CUDA for ``device="cuda"``, which needs
    a torch built with CUDA, else for the CPU alone."""
    cuda = torch.device(device).type == "cuda"
    if cuda and torch.version.cuda is None:
        raise RuntimeError("build_host: device='cuda' but this torch was "
                           "built without CUDA (pass device='cpu')")
    return build_host_program("aoti_host.cpp", host_flags(cuda),
                              "aoti_host-cuda" if cuda else "aoti_host-cpu")


def run_host(export_dir, n_blocks: int, prefix: str = "forward",
             device="cuda", x_in: Optional[str] = None,
             y_out: Optional[str] = None, carry_out: Optional[str] = None,
             host: Optional[Path] = None) -> dict:
    """Run the host (``host``, else :func:`build_host`) over
    ``n_blocks`` blocks of ``<export_dir>/<prefix>.aoti.pt2`` (the chunk
    input from the raw float32 file ``x_in``, the blocking loop's outputs
    to ``y_out``, its last caches to ``carry_out``) and return its JSON
    line; raises with its exit code and error output if it exits
    non-zero."""
    device = torch.device(device).type
    host = host or build_host(device)
    cmd = [str(host), str(export_dir), str(n_blocks), f"prefix={prefix}",
           f"device={device}"]
    for key, val in (("x_in", x_in), ("y_out", y_out),
                     ("carry_out", carry_out)):
        if val is not None:
            cmd.append(f"{key}={val}")
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=HOST_TIMEOUT)
    if r.returncode != 0:
        raise RuntimeError(f"aoti_host exited {r.returncode}: "
                           f"{r.stderr.strip()[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m rave_tpu_torch.export.native",
        description="Compile exported steps into AOTInductor packages and "
                    "build the C++ host that serves them.")
    p.add_argument("export_dir")
    p.add_argument("--prefix", nargs="+", choices=PREFIXES,
                   help="steps to compile (default: every one exported)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    prefixes = args.prefix or [s for s in PREFIXES
                               if (Path(args.export_dir) / f"{s}.pt2").exists()]
    if not prefixes:
        raise SystemExit(f"no {'/'.join(PREFIXES)}.pt2 in {args.export_dir}")
    for prefix in prefixes:
        path, seconds = compile_package(args.export_dir, prefix, args.device)
        print(f"compiled {path} in {seconds:.1f} s "
              f"(proxy executor: {', '.join(proxy_ops(path)) or 'none'})")
    print(f"host: {build_host(args.device)}")


if __name__ == "__main__":
    main()
