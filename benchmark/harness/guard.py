"""The import guard: nothing the benchmark runs may load JAX or the JAX
package. Names are compared by their top-level part, whole, so the port
`ndp_nmpc_qd_tpu_torch` is not mistaken for `ndp_nmpc_qd_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ndp_nmpc_qd_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules=None) -> list[str]:
    """The sorted loaded module names whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules if top_level(name) in FORBIDDEN)
