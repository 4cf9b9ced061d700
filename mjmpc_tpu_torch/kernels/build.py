"""Build and load the package's CUDA kernels.

Each kernel source in csrc/ is compiled by nvcc for Hopper (sm_90a) into a
shared library with a plain C interface and loaded with ctypes. Generated
headers (model constants) are written beside the build. The build
directory is keyed by a content hash of the source, the headers and the
flags, so a changed model or source builds anew and an unchanged one is
reused. Builds happen at first use, never at import.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    ptxas: str             # ptxas -v report: registers, spills per kernel
    build_seconds: float   # 0.0 when an existing build was reused


_LOADED: Dict[str, KernelLibrary] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def _digest(source: bytes, headers: Dict[str, str], flags: Tuple[str, ...]) -> str:
    h = hashlib.sha256(source)
    for path in sorted(CSRC.glob("*.cuh")):    # the sources' shared headers
        h.update(path.read_bytes())
    for name in sorted(headers):
        h.update(name.encode())
        h.update(headers[name].encode())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    return h.hexdigest()[:16]


def _compile(source: Path, headers: Dict[str, str], flags: Tuple[str, ...], lib_name: str,
             out_dir: Path) -> None:
    """Compile into a fresh directory, then move it into place, so that a
    concurrent or interrupted build never leaves a half-written library."""
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=out_dir.name + ".", dir=BUILD_ROOT))
    try:
        for name, text in headers.items():
            (tmp / name).write_text(text)
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-I", str(tmp), "-I", str(CSRC),
               "-o", str(tmp / lib_name), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{source.name}:\n{proc.stderr}{proc.stdout}")
        (tmp / "ptxas.txt").write_text(proc.stderr + proc.stdout)
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not (out_dir / lib_name).exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def load(name: str, source: str, headers: Dict[str, str],
         flags: Tuple[str, ...] = ()) -> KernelLibrary:
    """Build (if needed) and load csrc/<source> with the generated
    `headers` ({file name: text}) as lib<name>.so, with nvcc `flags` added
    to NVCC_FLAGS. Raises with nvcc's stderr when the build fails."""
    src = CSRC / source
    flags = tuple(flags)
    key = f"{name}-{_digest(src.read_bytes(), headers, flags)}"
    if key in _LOADED:
        return _LOADED[key]
    out_dir = BUILD_ROOT / key
    lib_name = f"lib{name}.so"
    seconds = 0.0
    if not (out_dir / lib_name).exists():
        start = time.perf_counter()
        _compile(src, headers, flags, lib_name, out_dir)
        seconds = time.perf_counter() - start
    lib = ctypes.CDLL(str(out_dir / lib_name))
    loaded = KernelLibrary(lib=lib, path=out_dir / lib_name,
                           ptxas=(out_dir / "ptxas.txt").read_text(),
                           build_seconds=seconds)
    _LOADED[key] = loaded
    return loaded
