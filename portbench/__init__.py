"""The benchmark of ``ray_tpu_torch`` on NVIDIA cards: ``python3
portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
See README.md."""
