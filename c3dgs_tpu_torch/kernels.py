"""Build and bind the port's hand-written CUDA kernels (csrc/*.cu).

Each source has a plain C interface and is compiled by `nvcc` for sm_90a
into a shared library under <repo>/build/c3dgs_tpu_torch/ at first use,
then loaded with ctypes (no PyTorch headers, so a build takes seconds).
Library names carry a hash of the source, the csrc/ headers it includes
and the flags, so an edited source or header is rebuilt and a concurrent
build never reads a half-written file. A source that includes
tiles_common.cuh (K1-K4) is built for the tile shape of render/types.py
(-DC3DGS_TILE_X/Y), and its library name carries that shape too
(libtiles_fwd-16x16-<hash>.so), so the shapes never share a file.

Each kernel is one `Kernel` record: its source, its C entry point, the TPU
kernel it replaces, and a plain integer launch count that its `launch`
bumps once per launched kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

from .render.types import TILE_X, TILE_Y

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "c3dgs_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction: the kernels then round each product like the
    # plain PyTorch versions they are held against
    "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    the one on PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(source: str) -> Dict[str, bytes]:
    """The source and every csrc/ header it includes with quotes,
    recursively, each once, in include order."""
    order, todo = {}, [source]
    while todo:
        name = todo.pop(0)
        if name in order:
            continue
        order[name] = (CSRC / name).read_bytes()
        todo.extend(m.decode() for m in _LOCAL_INCLUDE.findall(order[name]))
    return order


def shape_flags(source: str) -> Tuple[str, ...]:
    """The tile-shape defines of a source that includes tiles_common.cuh,
    none for any other."""
    if "tiles_common.cuh" not in _sources(source):
        return ()
    return (f"-DC3DGS_TILE_X={TILE_X}", f"-DC3DGS_TILE_Y={TILE_Y}")


def library_path(source: str) -> Path:
    """build/c3dgs_tpu_torch/lib<stem>[-<X>x<Y>]-<hash>.so: the hash covers
    the source, its headers and every flag (an edited header changes the
    name of every source that includes it)."""
    shaped = shape_flags(source)
    digest = hashlib.sha256(b"".join(_sources(source).values()) + " ".join((*NVCC_FLAGS, *shaped)).encode())
    shape = f"-{TILE_X}x{TILE_Y}" if shaped else ""
    return BUILD_DIR / f"lib{Path(source).stem}{shape}-{digest.hexdigest()[:12]}.so"


@dataclasses.dataclass
class BuildResult:
    source: str
    seconds: float  # nvcc wall time (0.0 when the library already existed)
    log: str  # nvcc's stderr: ptxas registers / shared memory / spills


def build(sources: Iterable[str]) -> Dict[str, BuildResult]:
    """Compile every source that has no library yet, one nvcc per source,
    all started together. Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    results = {}
    for src in sorted(set(sources)):
        lib = library_path(src)
        if lib.exists():
            results[src] = BuildResult(src, 0.0, "")
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *shape_flags(src), "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp, time.perf_counter())
    failed = []
    for src, (proc, tmp, t0) in procs.items():
        out, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src}: nvcc exited {proc.returncode}\n{out}{err}")
            continue
        os.replace(tmp, library_path(src))
        results[src] = BuildResult(src, seconds, out + err)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


_LIBS: Dict[str, ctypes.CDLL] = {}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    if source not in _LIBS:
        build([source])
        lib = ctypes.CDLL(str(library_path(source)))
        lib.c3dgs_error_string.argtypes = [ctypes.c_int]
        lib.c3dgs_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return _LIBS[source]


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel and its launch count."""

    name: str
    source: str  # file under csrc/
    symbol: str  # extern "C" entry point; returns cudaGetLastError()
    argtypes: Tuple
    replaces: str  # the TPU kernel it ports, file:line in c3dgs_tpu
    launches: int = 0
    _fn: Optional[ctypes._CFuncPtr] = dataclasses.field(default=None, repr=False)

    def launch(self, *args) -> None:
        """Launch the kernel once (on the stream passed in args) and raise
        if CUDA refused the launch."""
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = load(self.source).c3dgs_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed ({err}: {msg})")
        self.launches += 1


REGISTRY: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    REGISTRY[kernel.name] = kernel
    return kernel


def reset_counts() -> None:
    for k in REGISTRY.values():
        k.launches = 0
