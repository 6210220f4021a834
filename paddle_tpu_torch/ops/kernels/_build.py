"""Build and load the hand-written CUDA kernels.

Each kernel is one source, `csrc/<name>.cu`, with a plain C interface.
`nvcc` compiles it for Hopper (sm_90a) into a shared library under
`_build/` (listed in .gitignore), named by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one is reused. The
library is loaded with ctypes; no PyTorch headers are compiled, which
keeps a build to seconds.

Nothing is built at import. `load(name)` builds on first use;
`build(names)` starts one nvcc per source, all at once, and waits for
them (the smoke script builds every kernel this way).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["build", "load", "library_path", "KERNELS"]

KERNEL_DIR = Path(__file__).resolve().parent
CSRC = KERNEL_DIR / "csrc"
BUILD_DIR = KERNEL_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# every kernel source in csrc/, by name
KERNELS = ("ragged_paged_attention", "flash_attention", "fused_conv")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build from source on the machine with the GPU")


def library_path(name: str) -> Path:
    """Where `name`'s library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named kernel (default: all) not yet built for the
    current sources, one nvcc process per source, all started together.
    Returns {name: compiler report} (ptxas -v: registers, shared memory,
    spills); raises RuntimeError with nvcc's output when one fails."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        Path(f"{out}.log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return {name: _read_log(name) for name in names}


def _read_log(name: str) -> str:
    log = Path(f"{library_path(name)}.log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
