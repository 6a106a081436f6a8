"""The human-in-the-loop demo on the port (``python -m
coda_tpu_torch.demo.app``): the counterpart of the reference package's
``demo/app.py``."""
