"""Checkpoint / resume for long batch runs.

Port of `ndp_nmpc_qd_tpu/utils/checkpoint.py`. The reference checkpoints
only NN weights (torch pickles, `nn_train.py:170-172`); for swarm-scale
batch episodes the whole episode state (plant, solver iterates with their
carried IPM duals, estimator, metrics) is saved too, so long runs survive
preemption.

Format: `torch.save` of the tree's tensors at `path` (loaded back with
`weights_only=True`, which unpickles tensors and containers only), and a
JSON sidecar `<path>.meta.json` recording each tensor's shape and dtype and
the tree's layout: "batch" (batch-first) or "kernel" (the (s, d, B) layout
of `packed_state=True`, `RtiController.layout`). The two layouts hold the
same numbers in another order, so a restore into the other layout, or into
a template of another shape or dtype, raises ValueError: the port's
counterpart of the JAX package's tile-size (SUB) check. A missing file
raises FileNotFoundError and a corrupt one raises; nothing falls back to an
older copy.

A tree is built of tuples (NamedTuples such as `RtiState` included),
lists, dicts with string keys, tensors and None.
"""

from __future__ import annotations

import json

import torch

LAYOUTS = ("batch", "kernel")


def _meta_path(path: str) -> str:
    return path + ".meta.json"


def _leaves(tree) -> list:
    """The tensors of a tree in a fixed order (dicts by sorted key)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in _leaves(sub)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    raise TypeError(f"checkpoint trees hold tensors, tuples, lists, dicts and None, "
                    f"not {type(tree).__name__}")


def _rebuild(like, it):
    """`like`'s structure with its tensors taken in order from `it`."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return next(it)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, it) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, it) for v in like)
    return {k: _rebuild(like[k], it) for k in sorted(like)}


def _signature(t: torch.Tensor) -> dict:
    return {"shape": list(t.shape), "dtype": str(t.dtype).removeprefix("torch.")}


def save_pytree(path: str, tree, layout: str = "batch") -> None:
    """Save the tensors of `tree` (copied to the host) to `path`, with the
    sidecar recording their shapes, dtypes and `layout`."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    leaves = _leaves(tree)
    torch.save([t.detach().cpu() for t in leaves], path)
    with open(_meta_path(path), "w") as f:
        json.dump({"layout": layout, "leaves": [_signature(t) for t in leaves]}, f)


def restore_pytree(path: str, like, layout: str = "batch"):
    """Restore into the structure of `like` (a template tree), each tensor
    on the device of its template's. Raises FileNotFoundError for a missing
    checkpoint or sidecar, ValueError where the layout, the number of
    tensors, a shape or a dtype differs from the template's, and torch's
    error for a corrupt file."""
    try:
        with open(_meta_path(path)) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(f"no checkpoint at {path} (its sidecar "
                                f"{_meta_path(path)} is missing)") from None
    if meta.get("layout") != layout:
        raise ValueError(
            f"checkpoint {path} holds the {meta.get('layout')!r} layout, the restore asks "
            f"for {layout!r}: the layouts order the same numbers differently")
    tmpl = _leaves(like)
    want = [_signature(t) for t in tmpl]
    if meta.get("leaves") != want:
        raise ValueError(f"checkpoint {path} holds tensors {meta.get('leaves')}, the template "
                         f"expects {want} (another episode config or layout)")
    data = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(data, list) and all(isinstance(t, torch.Tensor) for t in data)
            and [_signature(t) for t in data] == want):
        raise ValueError(f"checkpoint {path} does not match its sidecar")
    return _rebuild(like, iter(d.to(t.device) for d, t in zip(data, tmpl)))
