"""Frozen arithmetic of the benchmark: what later changes to the program
may not move.  ``peaks`` (H100 peaks, the kernels' bounds and profiler
names), ``flops`` (model flops a step) and ``signs`` (the Rademacher sign
hash and the leaf-id rule).  Nothing here imports the program."""
