"""portbench: the benchmark of the PyTorch/CUDA port `stitchax_torch`.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`BENCHMARK.json` at the checkout's root names the cells; each cell's
configuration (`configs/<name>.json`), traffic mix (`traffic/<name>.json`),
limits (`limits/<cell>.json`) and per-layer metrics (`metrics/<name>.py`)
are files of their own, found by name.
"""
