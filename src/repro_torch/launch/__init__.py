"""Launch layer: production mesh, dry-run, roofline, train/serve drivers.

``python -m repro_torch.launch.train`` and ``python -m
repro_torch.launch.serve``; ``specs`` gives parameter and input shapes
with nothing allocated, and their shardings; ``mesh``, ``dryrun``,
``op_cost``, ``comm_bytes`` and ``roofline`` are the multi-pod dry run
and its accounting."""
