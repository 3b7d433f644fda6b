"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use each
is compiled by its own ``nvcc`` process for ``sm_90a`` (all started
together), the objects are linked into one shared library under
``_build/`` (git-ignored), and the library is loaded with ``ctypes``.  The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  A failed build
raises; nothing falls back to a kernel's plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["build", "lib", "check", "BUILD_INFO"]

SOURCES = ("span_gain.cu", "cover_rounds.cu", "lockstep_peel.cu")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# filled by build(): library path, seconds spent compiling (0.0 when the
# library was already built), and the ptxas resource report
BUILD_INFO: dict = {}

_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # name: (argtypes, restype)
    "span_gain_launch": ([_P, _P, _P, _LL, _I, _I, _I, _P], _I),
    "cover_rounds_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "lockstep_peel_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _P], _I),
    "lockstep_peel_state_bytes": ([_I, _I], _LL),
    "lockstep_peel_smem_cap": ([], _I),
    "repro_torch_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(nvcc: str) -> str:
    h = hashlib.sha1()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(repr((nvcc, NVCC_FLAGS)).encode())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Path:
    """Compile the kernels (unless an identical build exists and ``force``
    is off) and return the shared library's path."""
    nvcc = _nvcc()
    so = BUILD_DIR / f"librepro_torch-{_digest(nvcc)}.so"
    if so.exists() and not force:
        BUILD_INFO.update(path=str(so), seconds=0.0, ptxas="")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        reports = []
        failed = []
        for name, _, proc in procs:
            out, err = proc.communicate()
            reports.append(f"== {name}\n{out}{err}")
            if proc.returncode:
                failed.append(f"nvcc failed on {name} (rc {proc.returncode}):"
                              f"\n{out}{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_so, so)
    BUILD_INFO.update(path=str(so), seconds=time.perf_counter() - t0,
                      ptxas="\n".join(reports))
    return so


def lib():
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = res
        _LIB = handle
    return _LIB


def check(err: int, kernel: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if err:
        msg = lib().repro_torch_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
