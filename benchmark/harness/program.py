"""The port under test, built from a benchmark configuration file: the
benchmark hands it the file's numbers and takes from it only the system
under test, its outputs and its kernel names."""

from __future__ import annotations

import torch


def port_config(cfg: dict):
    """The port's `NdpNmpcConfig` with the file's groups."""
    from ndp_nmpc_qd_tpu_torch import params as P

    def build(kind, group):
        return kind(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in cfg.get(group, {}).items()})

    return P.NdpNmpcConfig(
        vehicle=build(P.VehicleParams, "vehicle"), ocp=build(P.OcpParams, "ocp"),
        estimator=build(P.EstimatorParams, "estimator"),
        downwash=build(P.DownwashParams, "downwash"), sim=build(P.SimParams, "sim"),
    )


def dtype_of(name: str | None):
    return None if name is None else getattr(torch, name)


class Sync:
    """An event on the card (record, then wait for it); nothing on the CPU,
    where every op has ended when it returns."""

    def __init__(self, dev: torch.device):
        self.ev = torch.cuda.Event() if dev.type == "cuda" else None

    def record(self):
        if self.ev is not None:
            self.ev.record()

    def wait(self):
        if self.ev is not None:
            self.ev.synchronize()


def synchronize(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
