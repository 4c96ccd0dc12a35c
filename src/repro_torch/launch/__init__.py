"""Command-line entry points: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``; ``specs`` gives parameter and
input shapes with nothing allocated."""
