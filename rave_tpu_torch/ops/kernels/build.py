"""Build the port's CUDA sources and bind them with ``ctypes``.

Each source under ``rave_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``rave_tpu_torch/_build/`` (listed in ``.gitignore``).  A source
that includes no PyTorch header builds in seconds; ``build_all`` starts
one ``nvcc`` per source at once and waits for them all.  The library file
name carries a hash of the source and flags, so an edited source is
rebuilt.  Nothing here runs at import time.

Every exported launcher returns the ``cudaError_t`` of its launch;
:meth:`CudaKernel.launch` raises on anything but success and counts the
launches that went through.

Host C++ sources build the same way with ``g++``: a library with a plain
C interface (:func:`build_host_library`), or a program against the
installed libtorch (:func:`build_host_program`, the flags from
``export/native.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra")


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else the toolkit PyTorch finds."""
    from torch.utils.cpp_extension import CUDA_HOME
    for root in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "rave_tpu_torch need the CUDA toolkit to build")
    return found


class CudaKernel:
    """One kernel launcher ``symbol`` exported by ``csrc/<source>``.

    ``launches`` counts calls of :meth:`launch` that launched the kernel
    without error; the caller may reset it to 0.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None
        self._error_string = None

    @property
    def library_path(self) -> Path:
        h = hashlib.sha1(self.source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}-{h}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source unless its library exists."""
        out = self.library_path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        try:
            return subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        rc = proc.wait()
        out = self.library_path
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        log = out.with_suffix(".log").read_text()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {rc}):\n{log}")
        os.replace(tmp, out)

    def _bind(self):
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.source.stem}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn, self._error_string = lib, fn, err
        return self._fn

    def query(self, symbol: str, *args) -> None:
        """Call another ``int`` function of the same library (one that
        launches nothing, e.g. a launch-configuration query); raise if it
        does not return 0."""
        self._bind()
        fn = getattr(self._lib, symbol)
        fn.restype = ctypes.c_int
        code = fn(*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(f"{self.name}: {symbol} failed: {msg} "
                               f"(cudaError {code})")

    def launch(self, *args) -> None:
        """Call the launcher; raise if the launch was refused."""
        code = self._bind()(*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed: {msg} "
                               f"(cudaError {code})")
        self.launches += 1


def build_all(kernels: Sequence[CudaKernel]) -> float:
    """Build every kernel's library in parallel, bind them; seconds taken.

    Kernels that share a source share its library: each distinct source
    is compiled once (two ``nvcc`` runs of one source would write the
    same temporary file)."""
    t0 = time.perf_counter()
    procs = {}
    for k in kernels:
        if k.library_path not in procs:
            procs[k.library_path] = (k, k.start_build())
    for k, p in procs.values():
        k.finish_build(p)
    for k in kernels:
        k._bind()
    return time.perf_counter() - t0


def build_host_library(source: str) -> Path:
    """The path of ``csrc/<source>`` compiled by ``g++`` into a shared
    library under ``_build/`` (see :func:`build_host_program`)."""
    src = CSRC_DIR / source
    return build_host_program(source, GXX_FLAGS, f"lib{src.stem}", ".so")


def build_host_program(source: str, flags: Sequence[str], name: str,
                       suffix: str = "") -> Path:
    """The path of ``csrc/<source>`` compiled by ``g++`` with ``flags``
    (placed after the source, so that they may name libraries) into
    ``_build/<name>-<hash><suffix>``, the hash of the source and flags,
    written under a temporary name, then renamed, so that two builds at
    once do not collide.  Raises with the compiler's output if the build
    fails."""
    src = CSRC_DIR / source
    h = hashlib.sha1(src.read_bytes()
                     + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"{name}-{h}{suffix}"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.name}.{os.getpid()}.tmp"
    r = subprocess.run([os.environ.get("CXX", "g++"), str(src), *flags,
                        "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {source} (exit {r.returncode}):"
                           f"\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out
