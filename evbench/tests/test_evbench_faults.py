"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (``run.run_cell``) on the CPU, on a 384² cell held to the limits of
the 8192² cell it stands for, through the port's plain path, with one
fault planted in the program: a round that returns its state unchanged,
and an answer altered where it is produced.  The cells have no batch and
no exchange between chips, so those faults do not apply."""

import time

import pytest
import torch

import eigen_value_tpu_torch.ops.solver_matvec as sm
from evbench.catalog import Catalog
from evbench.run import run_cell


def run(root, cell):
    return run_cell(Catalog(root), cell, 2**31 + 9, 0.2, False, torch.device("cpu"),
                    time.perf_counter(), log=lambda *a, **k: None)


@pytest.mark.parametrize("traffic", ["sym", "dense"])
def test_sound_run_is_correct(tiny, traffic):
    root, cells = tiny
    result = run(root, cells[traffic])
    assert result["correct"] and result["failed"] == 0


@pytest.mark.parametrize("traffic", ["sym", "dense"])
def test_round_that_returns_its_state_unchanged(tiny, monkeypatch, traffic):
    root, cells = tiny
    real = sm._make_cond_body

    def stuck(*args, **kwargs):
        cond, _ = real(*args, **kwargs)
        return cond, lambda c: c._replace(i=c.i + 1)

    monkeypatch.setattr(sm, "_make_cond_body", stuck)
    result = run(root, cells[traffic])
    assert not result["correct"] and result["failed"] == result["attempted"]
    assert result["checks"]["rounds_off"]["value"] > 0


@pytest.mark.parametrize("part", ["eigenvalue", "eigenvector"])
def test_answer_altered_where_it_is_produced(tiny, monkeypatch, part):
    root, cells = tiny
    real = sm._finish

    def altered(out, max_itr):
        res = real(out, max_itr)
        if part == "eigenvalue":
            return res._replace(eigenvalue=res.eigenvalue * (1 + 1e-4))
        ev = res.eigenvector.clone()
        ev[int(ev.argmax())] *= 1 + 1e-4
        return res._replace(eigenvector=ev)

    monkeypatch.setattr(sm, "_finish", altered)
    result = run(root, cells["sym"])
    assert not result["correct"]
    assert result["checks"]["pair_rel"]["value"] > result["checks"]["pair_rel"]["limit"]


def test_an_answer_that_is_not_a_number_writes_valid_json(tiny, monkeypatch):
    """λ not a number: the check reads null, never a bare NaN or Infinity."""
    import json

    root, cells = tiny
    real = sm._finish

    def nan(out, max_itr):
        res = real(out, max_itr)
        return res._replace(eigenvalue=res.eigenvalue * float("nan"))

    monkeypatch.setattr(sm, "_finish", nan)
    result = run(root, cells["dense"])
    assert not result["correct"]
    assert result["checks"]["pair_rel"]["value"] is None
    json.loads(json.dumps(result, allow_nan=False))
