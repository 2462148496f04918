"""`correct` comes out false for the control (the reference in the next
lower precision in the port's place) and for each fault a cell can have,
planted under the timed path; the harness's look for a card is skipped and
the rest of a run is driven at a small size on the CPU (the four-card cell
on two gloo ranks)."""

import functools
import sys
import types

import pytest
import torch

from ndp_nmpc_qd_tpu_torch.parallel.launch import LaunchError

from benchmark.tests.helpers import small_run

CELLS = ("scenario_batch.b65536", "formation.f65536", "formation.f262144.w4")


def batch_fault(kind):
    def wrap(cell, program):
        def broken(x0, xr, ur, other):
            st = cell.state
            before = [t.clone() for t in (st.x_bar, st.u_bar, *st.ipm)]
            u0, ok = program(x0, xr, ur, other)
            now = cell.state
            live = (now.x_bar, now.u_bar, *now.ipm)
            if kind == "state_unchanged":
                for t, b in zip(live, before):
                    t.copy_(b)
            elif kind == "half_left_out":
                h = cell.B // 2
                for t, b in zip(live, before):
                    t[..., h:] = b[..., h:]
                u0 = u0.clone()
                u0[h:] = 0.0
            elif kind == "answer_altered":
                u0 = u0 + torch.tensor([0.0, 0.0, 0.0, 0.5])
            elif kind == "duals_unchanged":
                for t, b in zip(now.ipm, before[2:]):
                    t.copy_(b)
            return u0, ok
        return broken
    return wrap


def plant_formation_fault(kind, cell, program):
    """`program` with `kind` planted under it (module level, so that the
    ranks of the four-card cell can unpickle it)."""
    if kind == "exchange_left_out":
        from ndp_nmpc_qd_tpu_torch.sim import closed_loop

        closed_loop.all_gather = lambda mesh, axis, t, dim=0: t
        return program

    if kind == "forbidden_loaded":
        sys.modules.setdefault("ndp_nmpc_qd_tpu", types.ModuleType("ndp_nmpc_qd_tpu"))
        return program

    def broken(st):
        new, (x, u0, thr) = program(st)
        if kind == "state_unchanged":
            new = st._replace(tick=new.tick, n_track=new.n_track)
        elif kind == "half_left_out":
            h = x.shape[0] // 2
            x_new = new.plant.x.clone()
            x_new[h:] = st.plant.x[h:]
            new = new._replace(plant=new.plant._replace(x=x_new))
            u0 = u0.clone()
            u0[h:] = 0.0
        elif kind == "answer_altered":
            u0 = u0 + torch.tensor([0.0, 0.0, 0.0, 0.5])
        return new, (x, u0, thr)
    return broken


def formation_fault(kind):
    return functools.partial(plant_formation_fault, kind)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    res, lines = small_run(cell, control=True)
    assert not res["correct"], lines
    assert res["checks"]["u0_gap"]["value"] > res["checks"]["u0_gap"]["limit"]


@pytest.mark.parametrize("kind", ("state_unchanged", "half_left_out", "answer_altered"))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(cell, kind):
    fault = batch_fault(kind) if cell.startswith("scenario") else formation_fault(kind)
    res, lines = small_run(cell, fault=fault)
    assert not res["correct"], lines


def test_duals_left_unchanged_are_not_correct():
    """Only the IPM's carried duals kept from the tick before: the dual gap
    fails where the command, iterates and flags may pass."""
    res, lines = small_run("scenario_batch.b65536", fault=batch_fault("duals_unchanged"))
    assert not res["correct"], lines
    assert res["checks"]["dual_gap"]["value"] > res["checks"]["dual_gap"]["limit"], lines


@pytest.mark.parametrize("cell", CELLS[1:])
def test_a_state_left_unchanged_fails_the_step_gap(cell):
    """At any size the formation's state left unchanged reads 1 in the step
    gap: the state gap and the command alone cannot see it where the
    positions are large."""
    res, lines = small_run(cell, fault=formation_fault("state_unchanged"))
    assert res["checks"]["step_gap"]["value"] >= 0.99, lines


def test_a_rank_that_loads_the_jax_package_ends_the_run():
    """A forbidden module loaded in a rank, not in the parent, ends the run
    with no result."""
    with pytest.raises(SystemExit) as exc:
        small_run("formation.f262144.w4", fault=formation_fault("forbidden_loaded"))
    assert exc.value.code == 3


def test_the_exchange_left_out_ends_the_sharded_run():
    """Without the all-gathers every rank holds only its own drones, and the
    episode's step cannot take the whole formation grid: the run ends with
    no result."""
    with pytest.raises(LaunchError):
        small_run("formation.f262144.w4", fault=formation_fault("exchange_left_out"))
