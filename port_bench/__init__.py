"""The port's benchmark: ``python3 port_bench/run.py --workload <cell> ...``
(see ``run.py``); cells, configurations and metrics in ``BENCHMARK.json``."""
