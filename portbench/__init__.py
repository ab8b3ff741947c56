"""The port's benchmark: one command runs one cell of ``BENCHMARK.json``
once (``python3 -m portbench.run``); ``README.md`` says how to add cells,
configurations, traffic mixes and per-layer metrics."""
