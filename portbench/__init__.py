"""The port's benchmark (``spoofsv_torch`` on NVIDIA GPUs); see ``run.py``."""
