"""PyTorch / CUDA port of `ndp_nmpc_qd_tpu` for NVIDIA Hopper (H100).

Mirrors the JAX package's module names. Plain tensor code is PyTorch; the
TPU's Pallas kernels become hand-written CUDA kernels under `csrc/`, each
with a plain PyTorch version beside it (`ops/kernels/`). The port imports
nothing of the JAX package.
"""

import torch


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
