"""The benchmark of the PyTorch/CUDA port ``repro_torch`` on one NVIDIA H100.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. ``BENCHMARK.json`` names the cells; each
cell's configuration (``configs/<name>.json``), traffic mix
(``traffic/<name>.json``) and metrics (``metrics/<name>.py``) are found by
name. A cell that serves a frozen single-shard index through the service,
with any filter kind and in a closed or an open loop, is an entry in
``BENCHMARK.json`` and data files beside these; keys that the harness
would not apply are refused. The reference (``reference/``) imports
nothing of the port."""
