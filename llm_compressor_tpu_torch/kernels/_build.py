"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

The output lands in ``llm_compressor_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source rebuilds. ``-Xptxas -v`` output (registers, shared memory, spills)
is kept beside the library as ``<lib>.log``. A missing ``nvcc`` or a failed
build raises. :func:`c_launcher` gives the wrappers each C function typed
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("w4a8_matmul", "decode_attention", "dequant_matmul", "hadamard")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str, defines: Sequence[str] = ()) -> Path:
    """The library of ``csrc/<name>.cu`` built with ``-D`` ``defines``,
    named by a hash of the source, the shared headers and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = FLAGS + [f"-D{d}" for d in defines]
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    variant = "".join(f"_{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{variant}-{tag}.so"


def build(names=SOURCES, defines: Sequence[str] = ()) -> Dict[str, Path]:
    """Compile every source in ``names`` that has no up-to-date library,
    all ``nvcc`` processes at once, with ``-D`` each of ``defines``.
    Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: lib_path(n, defines) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs: List[tuple] = []
    try:
        for n in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
                   str(CSRC / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for n, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{n}.cu (exit {p.returncode}):\n{log}")
                continue
            os.replace(tmp, out[n])
            Path(str(out[n]) + ".log").write_text(log)
    finally:
        for _, tmp, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of a built library (register and shared
    memory use per kernel)."""
    log = Path(str(lib_path(name)) + ".log")
    if not log.exists():
        return ""
    return "\n".join(line for line in log.read_text().splitlines()
                     if "registers" in line or "Compiling entry" in line
                     or "spill" in line)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _LOADED[name] = lib
    return lib


def c_launcher(name: str, fn_name: str, argtypes: Sequence) -> Callable[..., None]:
    """A callable for the C function ``fn_name`` of ``csrc/<name>.cu``,
    typed once: it passes its arguments and the current CUDA stream, and
    raises if the function returns a non-zero ``cudaError_t``. The library
    is built and loaded on the first call, not here."""
    cfn = None

    def launch(*args) -> None:
        nonlocal cfn
        if cfn is None:
            cfn = getattr(load(name), fn_name)
            cfn.restype = ctypes.c_int
            cfn.argtypes = [*argtypes, ctypes.c_void_p]
        err = cfn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")

    return launch
