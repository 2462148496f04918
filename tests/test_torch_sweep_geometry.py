"""The launch geometry of the streamed sweeps K8 (dense backward sweep) and K4
(glue-fused backward sweep): `_cuda.sweep_geometry`, the Python mirror of
`ndp::k8::geometry` / `ndp::k4::geometry` (held against the C exports on the
card by chip_smoke.py and on the CPU by test_torch_kernel_emulation.py).
Every scenario in exactly one slot of one block, a block's shared memory
within what an H100 block may take, its threads within the kernel's
launch bounds, and a slot's bytes the sum of the scenario's arrays."""

import pytest
import torch

from ndp_nmpc_qd_tpu_torch.ops.kernels import _cuda

SMEM_MAX = 232448  # dynamic shared memory a block may take on sm_90


@pytest.mark.parametrize("kind,jac_bf16", [("packed", False), ("glue", False), ("glue", True)])
@pytest.mark.parametrize("B", [1, 7, 301, 65535, 65536])
def test_sweep_geometry_covers_every_scenario_once(B, kind, jac_bf16):
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
