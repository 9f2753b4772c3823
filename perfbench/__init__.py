"""The benchmark of the PyTorch and CUDA port: `python3 -m perfbench.run`
(see `run.py`), driven by `BENCHMARK.json`."""
