"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into a shared library of its own
with a plain C interface (no PyTorch headers, so a build takes seconds) and
is loaded with ctypes. Libraries are built at first use into `build/kernels/`
beside the package (`NDP_TORCH_BUILD_DIR` overrides it), named by a hash of
the sources and flags so that an edited source is rebuilt. A failed build
raises with the compiler's output; nothing falls back. Threads of one
process (the runtime daemons) build and load under one lock, and every
build writes a temp file of its own process and thread before it is renamed
into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = (
    "step_whole", "linearize", "ipm_whole", "riccati_iter", "riccati_sweep", "riccati_packed",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> {"seconds": wall seconds of its nvcc (0 when found built),
#          "cached": bool, "log": nvcc/ptxas output}
build_info: dict = {}
_libs: dict = {}
lock = threading.RLock()


def build_dir() -> Path:
    env = os.environ.get("NDP_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    cands = ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str, defines=()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, defines=()) -> None:
    """Compile every named source not built yet: one nvcc per source, all
    started together. `defines` (e.g. "NDP_TEAM=8") build a variant of its
    own, logged under "<name>[defines]"."""
    todo = {}
    for name in names:
        out = _lib_path(name, defines)
        key = f"{name}[{','.join(defines)}]" if defines else name
        if out.exists():
            if key not in build_info:
                log = out.with_suffix(".log")
                build_info[key] = dict(
                    seconds=0.0, cached=True,
                    log=log.read_text() if log.exists() else "",
                )
        else:
            todo[name] = (out, key)
    if not todo:
        return
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (out, key) in todo.items():
        tmp = out.parent / f"{out.stem}.tmp{os.getpid()}-{threading.get_ident()}.so"
        cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[name] = (proc, tmp, out, key, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, key, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        build_info[key] = dict(seconds=seconds, cached=False, log=log)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (built with `defines`), built
    first if needed."""
    key = (name, tuple(defines))
    with lock:
        if key not in _libs:
            build((name,), defines)
            _libs[key] = ctypes.CDLL(str(_lib_path(name, defines)))
        return _libs[key]
