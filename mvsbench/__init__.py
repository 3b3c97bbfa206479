"""The benchmark of diffmvs_tpu_torch: a data-driven harness that runs one
cell of BENCHMARK.json (a configuration under a traffic mix) on the card
and prints its metrics as one JSON line. See mvsbench/run.py."""
