"""The paper's benches on the port: twins of the reference's
``benchmarks/`` scripts, writing the same JSON rows."""
