"""The benchmark of `kissmpc_tpu_torch`, the PyTorch and CUDA port.

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell once on the card and prints one JSON line.  Everything a cell
needs is found by name: `configs/<config>.json`, `workloads/<cell>.json`,
`traffic/<kind>.py` and `metrics/<metric>.py`.  The yardstick (the
operation counts, the trace readers, the scenario generator and the plain
reference in `reference/`) lives here, apart from the program it measures.
"""
