"""Host emulation of the port's CUDA kernels, for holding their logic
against the plain versions on a machine without a card.

`load(name)` builds `csrc/<name>.cu` as host C++ with g++ (-std=c++20) and
-DNDP_HOST_EMULATION against the stand-in headers in `include/`, and loads
it: each launch runs the kernel's blocks one after another, every thread of
a block on a host thread of its own, with the block's barriers and shared
memory (see include/cuda_runtime.h). The library exports the same C entry
points as the card's; pass CPU tensors' pointers and a null stream. It
shows the kernels' indexing, staging, barriers and arithmetic order; not
their speed, register use or alignment faults, which only the card shows.
Libraries go to `build/emulate/` beside the package, named by a hash of the
sources, the flags and `defines`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "csrc"
FLAGS = ("-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-ffp-contract=off",
         "-Wno-unknown-pragmas", "-DNDP_HOST_EMULATION")
_libs: dict = {}


def compiler() -> str | None:
    """A g++ that takes -std=c++20 (std::barrier), or None."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        return None
    probe = subprocess.run([cxx, "-std=c++20", "-x", "c++", "-fsyntax-only", "-"],
                           input="#include <barrier>\nstd::barrier<> b(1);\n",
                           capture_output=True, text=True)
    return cxx if probe.returncode == 0 else None


def build_dir() -> Path:
    return HERE.parents[1] / "build" / "emulate"


def load(name: str, defines=()) -> ctypes.CDLL:
    """The host build of `csrc/<name>.cu` with `defines` (e.g.
    "NDP_K8_THREADS=256"), built first if needed; raises with the
    compiler's output if the build fails."""
    key = (name, tuple(defines))
    if key in _libs:
        return _libs[key]
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++20 compiler (g++) found")
    flags = FLAGS + tuple(f"-D{d}" for d in defines)
    h = hashlib.sha256(" ".join((cxx,) + flags).encode())
    for f in sorted(CSRC.glob("*.cuh")) + sorted((HERE / "include").glob("*.h")) + [
            CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        done = subprocess.run(
            [cxx, *flags, "-I", str(HERE / "include"), "-x", "c++", str(CSRC / f"{name}.cu"),
             "-o", str(tmp)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ {name}.cu failed ({done.returncode}):\n{done.stderr}")
        os.replace(tmp, out)
    _libs[key] = ctypes.CDLL(str(out))
    return _libs[key]


def launch(fn, jac_bf16: bool, consts, ptrs, B: int) -> None:
    """Run a launch entry point of an emulated library; raise if it
    returns an error."""
    err = fn(int(jac_bf16), ctypes.byref(consts), ctypes.byref(ptrs), B, None)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {err}")
