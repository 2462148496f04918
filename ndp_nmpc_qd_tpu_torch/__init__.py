"""PyTorch / CUDA port of `ndp_nmpc_qd_tpu` for NVIDIA Hopper (H100).

Mirrors the JAX package's module names. Plain tensor code is PyTorch; the
TPU's Pallas kernels become hand-written CUDA kernels under `csrc/`, each
with a plain PyTorch version beside it (`ops/kernels/`). The port imports
nothing of the JAX package.
"""

import functools

import torch


@functools.lru_cache(maxsize=None)
def const(values: tuple, dtype, device) -> torch.Tensor:
    """A constant tensor of host values (a tuple, nested for more
    dimensions), made once per dtype and device. Made anew every tick, it
    would be copied to the card every tick, and that copy waits for the
    work queued before it. Never write into it."""
    return torch.tensor(values, dtype=dtype, device=device)


def resolve_device(device=None) -> torch.device:
    """The device a controller or model runs on.

    Defaults to the card; with no card and no explicit device this raises
    instead of running on the CPU. Tests pass `device="cpu"`.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain versions"
            )
        return torch.device("cuda")
    return torch.device(device)
