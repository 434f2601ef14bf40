"""Batched solves (counterpart of ``eigen_value_tpu.parallel``).  The
sharded and multi-host solves are not ported yet (ROADMAP Queue 1 item 10)."""

from .batched import solve_batched

__all__ = ["solve_batched"]
