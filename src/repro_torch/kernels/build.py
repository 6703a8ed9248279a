"""Build the hand-written CUDA kernels with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/kernels/<name>-<hash>.so`` under the repository root (a
directory ``.gitignore`` lists); the hash is taken over the source and
every shared ``csrc/*.cuh`` header, so an edited kernel never loads a
stale library.  Nothing is built at import:
the first launch builds, or ``build_all()`` builds every source at once,
one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def refuse_abstract(t, kernel: str, instead: str) -> None:
    """Raise when ``t`` is a fake or ``meta`` tensor (a dry run's trace):
    it has no data for the kernel, or for its plain version, to read, and
    a wrapper never swaps in another path unasked.  ``instead`` names the
    path that traces.  A DTensor is refused too: a kernel takes the
    rank's own block (``to_local()``), never the global tensor."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        raise TypeError(f"{kernel}: a DTensor, not the rank's block: hand "
                        "the kernel its to_local()")
    fake = is_fake(t)
    if t.device.type == "meta" or fake:
        raise ValueError(
            f"{kernel}: tensors on {t.device}{' (fake)' if fake else ''}, "
            f"not CUDA/CPU tensors with data to read: trace {instead} "
            "instead")


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``PATH``, then the toolkit
    directory PyTorch itself found; raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cands.append(Path(CUDA_HOME) / "bin" / "nvcc")
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str, nvcc: str):
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or nothing
    return log


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no current library, in
    parallel; returns each build's ``nvcc`` output (register and shared
    memory use from ``-Xptxas -v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not _lib_path(n).is_file()]
    logs = {n: "(cached)" for n in names if n not in todo}
    if todo:
        nvcc = find_nvcc()
        started = [(n, *_start(n, nvcc)) for n in todo]
        for n, proc, tmp, out in started:
            logs[n] = _finish(n, proc, tmp, out)
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _finish(name, *_start(name, find_nvcc()))
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib


def c_args(kinds: str) -> List[type]:
    """ctypes argtypes from short codes: p pointer, i int, l 64-bit int,
    f float."""
    table = {"p": ctypes.c_void_p, "i": ctypes.c_int,
             "l": ctypes.c_longlong, "f": ctypes.c_float}
    return [table[k] for k in kinds]
