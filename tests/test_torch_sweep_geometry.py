"""The launch geometry of the streamed sweeps K8 (dense backward sweep), K4
(glue-fused backward sweep) and K6 (backward sweep with the row terms
given), and of the linearization K3: `_cuda.sweep_geometry`, the Python
mirror of `ndp::k8::geometry` / `ndp::stream::geometry`, and
`_cuda.lin_geometry`, of `ndp::k3::geometry` (held against the C exports on
the card by chip_smoke.py and on the CPU by test_torch_kernel_emulation.py).
Every scenario in exactly one slot of one block (K3: every stage of every
scenario in one thread), a block's
shared memory within what an H100 block may take, its threads within the
kernel's launch bounds, and a slot's bytes the sum of the scenario's
arrays."""

import pytest
import torch

from ndp_nmpc_qd_tpu_torch.ops.kernels import _cuda

SMEM_MAX = 232448  # dynamic shared memory a block may take on sm_90


N = 20  # stages (OcpParams.N_node)


def lin_geometry_covers_every_stage_once(B):
    """K3: block = tile * (N + 1) + k covers stage k (k = N: the terminal
    node) of the tile's scenarios, a thread each."""
    g = _cuda.lin_geometry(B, N)
    S = g["scenarios_per_block"]
    assert g["threads_per_block"] == S and g["threads_per_scenario"] == 1 and S % 32 == 0
    assert g["smem_bytes_per_block"] == 0
    block = torch.arange(g["blocks"])
    tile, k = block // (N + 1), block % (N + 1)
    b = tile[:, None] * S + torch.arange(S)[None, :]
    served = (k[:, None] * B + b)[b < B]  # (stage, scenario) pairs
    assert served.numel() == (N + 1) * B
    assert torch.equal(served.sort().values, torch.arange((N + 1) * B))


@pytest.mark.parametrize("kind,jac_bf16", [("packed", False), ("glue", False), ("glue", True),
                                           ("given", False), ("given", True), ("lin", False)])
@pytest.mark.parametrize("B", [1, 7, 301, 65535, 65536])
def test_sweep_geometry_covers_every_scenario_once(B, kind, jac_bf16):
    if kind == "lin":
        lin_geometry_covers_every_stage_once(B)
        return
    g = _cuda.sweep_geometry(kind, B, jac_bf16)
    k = _cuda.SWEEP_KERNELS[kind]
    S, blocks, T = g["scenarios_per_block"], g["blocks"], g["threads_per_scenario"]
    slots = torch.arange(blocks)[:, None] * S + torch.arange(S)[None, :]
    served = slots[slots < B]
    assert served.numel() == B and torch.equal(served.sort().values, torch.arange(B))
    assert blocks * S - B < S  # no block without a scenario
    # the compute threads in whole warps, then one producer warp
    assert g["threads_per_block"] == -(-S * T // 32) * 32 + 32
    assert S * T <= k["max_threads"] and g["threads_per_block"] <= k["max_threads"] + 32
    assert g["smem_bytes_per_block"] == _cuda.sweep_smem(kind, S, jac_bf16) <= SMEM_MAX
    assert g["smem_bytes_per_block"] >= S * g["scenario_bytes"]
    slot, cols = _cuda.sweep_arrays(kind, jac_bf16)
    assert g["scenario_bytes"] == sum(b for _, b in slot + cols)
    assert 0 <= g["slot_bytes"] - sum(b for _, b in slot) < 128 and g["slot_bytes"] % 16 == 0
    if B >= 64:  # whole 16-byte rows and whole warps of compute threads
        assert S % k["vec"] == 0 and S * T % 32 == 0
