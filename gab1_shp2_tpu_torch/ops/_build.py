"""Build the package's CUDA sources at first use and load them with ctypes.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
object with a plain C interface (no PyTorch headers, so a build takes
seconds), cached under ``gab1_shp2_tpu_torch/_build/`` by a hash of its
sources, the shared headers under ``csrc/``, its generated headers and
flags, and loaded with ``ctypes``.  The caller declares
``argtypes``/``restype`` on the returned library.
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
from typing import Dict, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what each build printed (ptxas registers/spills) and how long it took,
# by library name; read by chip_smoke.py
BUILD_LOG: Dict[str, dict] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit at $CUDA_HOME (default
    /usr/local/cuda, the toolkit's standard install location)."""
    path = shutil.which("nvcc")
    home_nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "nvcc")
    if path is None and os.path.exists(home_nvcc):
        path = home_nvcc
    if path is None:
        raise RuntimeError("nvcc was not found; the CUDA kernels of "
                           "gab1_shp2_tpu_torch are built with nvcc at "
                           "first use")
    return path


def load_library(name: str, sources: Sequence[str],
                 generated: Dict[str, str]) -> ctypes.CDLL:
    """Build (once per content hash) and load ``csrc/<sources>`` with the
    ``generated`` headers (file name -> text) on the include path."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device, and "
                           "torch.cuda.is_available() is False")
    h = hashlib.sha256()
    # the sources and every shared header under csrc/ they may include
    for src in [*sources, *sorted(p.name for p in CSRC_DIR.glob("*.cuh"))]:
        h.update(src.encode())
        h.update((CSRC_DIR / src).read_bytes())
    for fname in sorted(generated):
        h.update(fname.encode())
        h.update(generated[fname].encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = f"{name}_{h.hexdigest()[:16]}"
    if key in _LOADED:
        return _LOADED[key]

    out_dir = BUILD_DIR / key
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        for fname, text in generated.items():
            (out_dir / fname).write_text(text)
        # compile to a private name, then rename: concurrent first uses
        # (several test workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{out_dir}", f"-I{CSRC_DIR}",
               "-o", tmp, *[str(CSRC_DIR / s) for s in sources]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
        BUILD_LOG[name] = dict(seconds=seconds, log=proc.stderr,
                               cmd=" ".join(cmd))
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[key] = lib
    return lib
