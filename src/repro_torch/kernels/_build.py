"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so``, a shared
library with a plain C interface loaded through ctypes.  The hash covers
the source and the flags, so an edited source is rebuilt and a built one
is reused.  Builds happen at first use, never at import; :func:`build`
starts one ``nvcc`` per source, all at once.  A missing ``nvcc`` or a
failed build raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels cannot be built")
    return path


def library_path(name: str, src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def build(*names: str, src: Optional[Path] = None) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, in parallel.

    Returns each name's library path.  The compiler's report (registers,
    shared memory, spills from ``-Xptxas -v``) lands in
    ``build/<name>.log``.  ``src`` builds one name from another file
    than ``csrc/<name>.cu`` (an earlier design, to time beside this one).
    """
    BUILD.mkdir(parents=True, exist_ok=True)
    srcs = {n: Path(src) if src is not None else CSRC / f"{n}.cu"
            for n in names}
    paths = {n: library_path(n, srcs[n]) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (BUILD / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[n])     # atomic: no half-written library
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str, src: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``src``), built if
    needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name, src=src)[name]))
    return _loaded[name]
