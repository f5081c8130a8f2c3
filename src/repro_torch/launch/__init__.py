"""Entry points of the port that a user runs (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``)."""
