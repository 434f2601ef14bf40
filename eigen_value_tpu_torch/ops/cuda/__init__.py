"""The hand-written Hopper kernels: build (build.py) and wrappers (kernels.py)."""
