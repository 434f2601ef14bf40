"""The oracle CLI (the reference's ``main.py`` harness):
``python -m eigen_value_tpu_torch.oracle``."""
