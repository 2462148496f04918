"""The launch geometry of the team kernels K1 and K2 (`_cuda.team_geometry`,
the Python mirror of `ndp::team_geometry` in csrc/ndp_team.cuh, held against
the C export on the card by chip_smoke.py): every scenario in exactly one
slot of one block, a block's shared memory within what an H100 block may
take, and a slot's bytes the sum of the scenario's arrays."""

import pytest
import torch

from ndp_nmpc_qd_tpu_torch.ops.kernels import _cuda
from ndp_nmpc_qd_tpu_torch.params import NdpNmpcConfig

N = NdpNmpcConfig().ocp.N_node


@pytest.mark.parametrize("jac_bf16", [False, True])
@pytest.mark.parametrize("B", [1, 7, 301, 65535, 65536])
def test_team_geometry_covers_every_scenario_once(B, jac_bf16):
    g = _cuda.team_geometry(B, N, jac_bf16)
    S, blocks = g["scenarios_per_block"], g["blocks"]
    slots = torch.arange(blocks)[:, None] * S + torch.arange(S)[None, :]
    served = slots[slots < B]
    assert served.numel() == B and torch.equal(served.sort().values, torch.arange(B))
    assert blocks * S - B < S  # no block without a scenario
    assert g["threads_per_block"] == S * g["threads_per_scenario"] <= _cuda.MAX_THREADS
    assert g["smem_bytes_per_block"] == S * g["slot_bytes"] <= 232448
    arrays = _cuda.team_arrays(N, jac_bf16)
    assert g["scenario_bytes"] == sum(b for _, b in arrays)
    assert 0 <= g["slot_bytes"] - g["scenario_bytes"] < 128 and g["slot_bytes"] % 16 == 0
    if B >= 8:
        assert S >= 8  # a staged row of S floats fills at least one 32-byte sector
