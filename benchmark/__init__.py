"""The port's benchmark: one cell of ``BENCHMARK.json`` run once on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:

    configs/<config>.json    sizes, source, overrides of the port's defaults
    traffic/<traffic>.json   the driver that runs the mix and its parameters
    workloads/<cell>.json    the cell's check: samples drawn and limits
    drivers/<driver>.py      one file per kind of loop (rollout, train, deploy)
    metrics/<metric>.py      one reader per per-layer metric
    reference/               the frozen plain reference and the work counts
    pending/<cell>.json      the ``BENCHMARK.json`` entries of a cell whose
                             files are all here but that is not yet run
                             (its runs spread too widely for a bound)

The program under test is ``paddlerobotics_torch``; nothing here imports JAX
or the JAX package.
"""
