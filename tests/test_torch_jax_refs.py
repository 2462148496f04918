"""The recordings of the JAX side that the port's parity tests read
(`jax_refs.py`, written by `tools/record_jax_refs.py`).

Each recording exists, holds every key its test reads (the test module's
REF_KEYS), and was made from the `ndp_nmpc_qd_tpu/` sources and the JAX
version that stand. A JAX upgrade or an edit to the JAX package fails here,
naming the command that records the file again.
"""

import importlib

import numpy as np
import pytest

import jax_refs


@pytest.fixture(scope="module")
def live():
    return jax_refs.source_hash(), jax_refs.jax_version()


@pytest.mark.parametrize("stem", jax_refs.STEMS)
def test_recording_holds_its_keys_and_matches_the_tree(stem, live):
    path = jax_refs.REF_DIR / f"{stem}.npz"
    cmd = jax_refs.write_command(stem)
    assert path.exists(), f"{path} is missing: run `{cmd}`"
    with np.load(path) as z:
        have = set(z.files)
        meta = {k: str(z[k]) for k in ("meta/jax_source", "meta/jax_version") if k in have}
    missing = sorted(set(importlib.import_module(stem).REF_KEYS) - have)
    assert not missing, f"{path} lacks {missing}: run `{cmd}`"
    source, version = live
    assert meta.get("meta/jax_source") == source, (
        f"{path} was recorded from other ndp_nmpc_qd_tpu/ sources: run `{cmd}`")
    assert meta.get("meta/jax_version") == version, (
        f"{path} was recorded with {meta.get('meta/jax_version')}, and {version} is "
        f"installed: run `{cmd}`")
