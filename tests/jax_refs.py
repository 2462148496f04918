"""Recorded outputs of the JAX package's Pallas paths, for the port's parity
tests.

Several parity tests hold the port's plain versions against the JAX
package's Pallas kernels. Built in interpret mode on the CPU, such a kernel
costs ~17-21 s to lower and ~10 s to compile, once per configuration and
process, while the port's side takes seconds. For fixed inputs the JAX
side's outputs are the same numbers in every run as long as the JAX package
and the installed JAX stay as they are. So `tools/record_jax_refs.py` runs
the JAX side once, exactly as the tests built it, and writes
`assets/jax_refs/<test file stem>.npz`; each of those tests builds its
inputs, checks them against the recording, runs the port's side and
compares it with the recorded arrays at its own tolerances.

A recording holds, under `<case>/<name>`, every array its test reads from
the JAX side; under `<case>/in/<name>`, a SHA-256 digest of each input
handed to the JAX call that numpy or the JAX package made (`digest`);
under `<case>/fp/<name>`, a fingerprint of each input that the port's own
code computed (`fingerprint`: torch picks its CPU kernels by the CPU's
features, so such an input is held to 1e-6 of its own scale, not to the
bit); and under `meta/`, the JAX version and a hash of the sources of
`ndp_nmpc_qd_tpu/` (`source_hash`), which `test_torch_jax_refs.py` holds
against the tree and the installed JAX.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
REF_DIR = ROOT / "assets" / "jax_refs"
JAX_PKG = ROOT / "ndp_nmpc_qd_tpu"

# the test files whose JAX side is recorded
STEMS = (
    "test_torch_episode",
    "test_torch_glue_fused",
    "test_torch_ipm_whole",
    "test_torch_riccati_iter",
    "test_torch_riccati_packed",
    "test_torch_riccati_sweep",
    "test_torch_step_whole",
    "test_torch_step_whole_bf16",
    "test_torch_two_kernel",
    "test_torch_two_kernel_bf16",
    "test_torch_two_kernel_layout",
)


def write_command(stem: str) -> str:
    return f"python tools/record_jax_refs.py --write {stem}"


def _update(h, x) -> None:
    """Feeds x to the hash with its type, dtype and shape: tensors (bf16 by
    its bit pattern), arrays (numpy, JAX), sequences and dicts item by item,
    anything else by its repr."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        h.update(f"tensor {x.dtype}".encode())
        x = x.contiguous().numpy()
    if isinstance(x, (list, tuple)):
        h.update(f"seq {len(x)}".encode())
        for v in x:
            _update(h, v)
    elif isinstance(x, dict):
        h.update(f"dict {len(x)}".encode())
        for k in sorted(x):
            h.update(repr(k).encode())
            _update(h, x[k])
    elif isinstance(x, np.ndarray) or hasattr(x, "__array__"):
        a = np.ascontiguousarray(np.asarray(x))
        h.update(f"array {a.dtype.name} {a.shape}".encode())
        h.update(a.tobytes())
    else:
        h.update(f"repr {x!r}".encode())


def digest(x) -> str:
    h = hashlib.sha256()
    _update(h, x)
    return h.hexdigest()


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def fingerprint(x) -> np.ndarray:
    """(n, 4) float64: the size, sum, sum of |.| and max |.| of each of the
    n tensors in x (a tensor or a nested sequence of them)."""
    rows = []
    for t in _leaves(x):
        a = torch.as_tensor(t).detach().cpu().double()
        rows.append((a.numel(), float(a.sum()), float(a.abs().sum()),
                     float(a.abs().max()) if a.numel() else 0.0))
    return np.array(rows, np.float64).reshape(-1, 4)


def fingerprint_mismatch(got: np.ndarray, want: np.ndarray, rtol: float = 1e-6) -> bool:
    """Unless the same tensors with sums and maxima within rtol of their own
    scale (the sum within rtol of the sum of |.|)."""
    if got.shape != want.shape or not np.array_equal(got[:, 0], want[:, 0]):
        return True
    scale = np.stack([want[:, 2], want[:, 2], want[:, 3]], axis=1)
    return bool((np.abs(got[:, 1:] - want[:, 1:]) > rtol * scale).any())


def input_entries(case: str, inputs: dict, computed: dict) -> dict:
    """The recording's `<case>/in/<name>` digests of the inputs made by numpy
    or the JAX package and `<case>/fp/<name>` fingerprints of those the
    port's code computed."""
    return {**{f"{case}/in/{n}": np.array(digest(v)) for n, v in inputs.items()},
            **{f"{case}/fp/{n}": fingerprint(v) for n, v in computed.items()}}


def source_hash() -> str:
    """SHA-256 over the JAX package's sources (paths and bytes of its .py and
    .cpp files; what builds and runs leave there is not hashed)."""
    h = hashlib.sha256()
    for p in sorted(JAX_PKG.rglob("*")):
        if p.suffix in (".py", ".cpp") and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(ROOT)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def jax_version() -> str:
    import jax
    import jaxlib

    return f"jax {jax.__version__}, jaxlib {jaxlib.__version__}"


def keys(cases, outputs, inputs=(), computed=()) -> tuple:
    """The keys a test reads: each output, input digest and fingerprint of
    each case."""
    return (tuple(f"{c}/{o}" for c in cases for o in outputs)
            + tuple(f"{c}/in/{i}" for c in cases for i in inputs)
            + tuple(f"{c}/fp/{i}" for c in cases for i in computed))


class Recording:
    """One test file's recording, loaded whole."""

    def __init__(self, stem: str):
        self.stem = stem
        self.path = REF_DIR / f"{stem}.npz"
        if not self.path.exists():
            pytest.fail(f"{self.path} is missing: run `{write_command(stem)}`")
        with np.load(self.path) as z:
            self.arrays = dict(z)

    def check_inputs(self, case: str, **inputs) -> None:
        """Fails unless these are the inputs the JAX side was recorded with:
        bitwise where the recording holds a digest, within a fingerprint's
        tolerance where it holds a fingerprint."""
        recorded = {k for k in self.arrays
                    if k.startswith(f"{case}/in/") or k.startswith(f"{case}/fp/")}
        fp = {n for n in inputs if f"{case}/fp/{n}" in recorded}
        live = input_entries(case, {n: v for n, v in inputs.items() if n not in fp},
                             {n: inputs[n] for n in fp})

        def differs(k):
            if k not in live or k not in recorded:
                return True
            if "/fp/" in k:
                return fingerprint_mismatch(live[k], self.arrays[k])
            return str(self.arrays[k]) != str(live[k])

        bad = sorted(k for k in recorded | set(live) if differs(k))
        if bad:
            pytest.fail(
                f"{self.path}: inputs {bad} differ from those the JAX side was recorded "
                f"with. If the change to them is meant, run `{write_command(self.stem)}`")

    def __call__(self, case: str, name: str) -> np.ndarray:
        return self.arrays[f"{case}/{name}"]
