"""Solvers and kernels of the port."""
