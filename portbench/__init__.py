"""portbench: the benchmark of dynseg_torch on one NVIDIA H100.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json. Everything that belongs to one
configuration, traffic mix, per-layer metric or cell lives in a file of
its own, found by name:

    configs/<config>.json    the net (blocks, wiring), sizes, precision,
                             data geometry, source
    mixes/<traffic>.json     parameters and the driver module that runs them
    drivers/<driver>.py      a general driver of one kind of traffic
    metrics/<metric>.py      a reader of one per-layer metric
    limits/<cell>.json       the limit of each number the comparison checks

The plain reference (`reference/`) imports neither the JAX package nor
dynseg_torch; nothing here imports JAX.
"""
