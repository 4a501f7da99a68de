"""Benchmark of pangraph_tpu_torch: build throughput on upstream deployments.

Run one cell as `python3 port_bench/run.py --workload NAME --seed N
--seconds S --trace 0|1` from the repository root (see run.py)."""
