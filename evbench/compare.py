"""What decides ``correct``: the answers of the timed calls against the
plain reference on the same stored matrices.

Compared, each against the limit of its cell (``limits/<cell>.json``):

* ``rounds_off``: the largest |rounds − the reference's rounds| over every
  answer (exact: limit 0);
* ``converged_off``: the answers whose ``converged`` differs from the
  reference's (exact: limit 0);
* ``pair_rel``: the largest relative error of an eigenpair: of λ,
  |λ − λ_ref| / |λ_ref|, over every answer, and of the eigenvector,
  max|ev − ev_ref| / max|ev_ref|, over the answers whose eigenvector was
  kept (the last on each matrix and a sample drawn from the seed).

Each answer is judged against the reference's solution of its matrix.

λ alone does not part the program from its control: λ = v[0] is one
entry, whose error in TF32 falls near float32's on some matrices, while the
eigenvector's n entries part them by a wide margin (PERF.md).  ``lam_rel``
and ``ev_rel``, the two parts, are printed beside the checks.
The readings each limit was set from are in PERF.md.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch

#: The compared numbers, in the order in which they are printed.
NUMBERS = ("rounds_off", "converged_off", "pair_rel")


class Answer(NamedTuple):
    """One solve as the caller received it: the pool index of its matrix,
    λ, rounds and converged on the host, and the eigenvector on the device
    (dropped from the record unless the answer is kept for the check)."""

    matrix: int
    eigenvalue: float
    rounds: int
    converged: bool
    eigenvector: Optional[torch.Tensor] = None


def _lam_rel(lam: float, ref: float) -> float:
    return abs(lam - ref) / abs(ref) if ref else abs(lam)


def _ev_rel(ev: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.to(torch.float64)
    return float((ev.to(ref.device, torch.float64) - ref).abs().max() / ref.abs().max())


def _worst(errors: Iterable[float]) -> float:
    """The largest error, infinite where one is not a number."""
    return max((e if math.isfinite(e) else math.inf for e in errors), default=0.0)


def numbers(answers: Iterable[Answer], kept: Iterable[Answer], refs: Sequence) -> Dict[str, float]:
    """The compared numbers (and ``lam_rel`` and ``ev_rel``, the parts of
    ``pair_rel``) of ``answers`` and of the answers ``kept`` with their
    eigenvectors, against ``refs``, the reference's solution of each pool
    matrix."""
    answers = list(answers)
    out = dict(
        rounds_off=max((abs(a.rounds - refs[a.matrix].rounds) for a in answers), default=0),
        converged_off=sum(a.converged != refs[a.matrix].converged for a in answers),
        lam_rel=_worst(_lam_rel(a.eigenvalue, refs[a.matrix].eigenvalue) for a in answers),
        ev_rel=_worst(_ev_rel(a.eigenvector, refs[a.matrix].eigenvector) for a in kept),
    )
    out["pair_rel"] = max(out["lam_rel"], out["ev_rel"])
    return out


def wrong_answers(answers: Iterable[Answer], refs: Sequence, limits: dict) -> int:
    """The answers that fail a limit of their own (rounds, converged, λ)."""
    return sum(
        abs(a.rounds - refs[a.matrix].rounds) > limits["rounds_off"]
        or a.converged != refs[a.matrix].converged
        or not _lam_rel(a.eigenvalue, refs[a.matrix].eigenvalue) <= limits["pair_rel"]
        for a in answers
    )


def judge(values: Dict[str, float], limits: dict) -> Tuple[bool, List[dict]]:
    """``(correct, checks)``: every number at or under its limit; each check
    is ``{"name", "value", "limit", "ok"}`` in :data:`NUMBERS` order."""
    checks = []
    for name in NUMBERS:
        value, limit = values[name], limits[name]
        checks.append(dict(name=name, value=value, limit=limit, ok=bool(value <= limit)))
    return all(c["ok"] for c in checks), checks
