"""The benchmark of nimble_tpu_torch: whole `align` (and `report`) jobs as
users run them, timed from outside the program, with the outputs held
against a plain reference (`benchmark/reference/`).

Run one cell: `python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout, on a machine with a
CUDA card. Everything that belongs to one configuration, traffic mix, cell,
per-layer metric or layer is a file of its own under `configs/`,
`traffic/`, `cells/`, `metrics/` and `layers/`, found by the name that
`BENCHMARK.json` gives it.
"""
