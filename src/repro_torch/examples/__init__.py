"""Runnable examples, the port's twins of the repo's ``examples/``:
``python -m repro_torch.examples.<name> [--device cpu]`` for ``quickstart``,
``serve_lm``, ``train_lm_mgd`` and ``chip_in_the_loop``."""
