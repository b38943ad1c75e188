"""The benchmark of ftrl_ffm_tpu_torch: one run of one cell is

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(benchmark/run.py).  BENCHMARK.json at the repository's root lists the
cells; configs/, traffic/, limits/ and metrics/ hold what belongs to each
configuration, traffic mix, cell and metric, and models/ what belongs to
each model type, found by name.  Nothing here
imports JAX or the JAX package, and the plain reference (reference/)
imports nothing of the program."""
