"""One public call a matrix: ``max_eigenvalue(A, cfg)``, the caller's
matrices taken in turn, and the call over once λ, ``rounds`` and
``converged`` are on the host, which is what a caller pays.

``cfg`` is the configuration's stated semantics (``eps``, ``max_itr``,
``eps_mode``, ``storage_dtype``) with the traffic's ``solver`` knobs
(``symmetric``, say) over them.
"""

from __future__ import annotations

from eigen_value_tpu_torch import SolverConfig, max_eigenvalue

from evbench.compare import Answer
from evbench.pool import DTYPES


def solver_config(config: dict, traffic: dict) -> SolverConfig:
    kw = dict(eps=config["eps"], max_itr=config["max_itr"], eps_mode=config["eps_mode"])
    if config.get("storage_dtype"):
        kw["storage_dtype"] = DTYPES[config["storage_dtype"]]
    kw.update(traffic.get("solver", {}))
    return SolverConfig(**kw)


def start(config: dict, traffic: dict, pool: list):
    cfg = solver_config(config, traffic)

    def call(k: int) -> list:
        p = k % len(pool)
        res = max_eigenvalue(pool[p], cfg)
        return [Answer(p, res.eigenvalue.item(), int(res.rounds.item()),
                       bool(res.converged.item()), res.eigenvector)]

    return call
