"""The benchmark of doa_mpc_tpu_torch: ``python3 mpcbench/run.py --workload <cell> ...``
(``run.py``), its harness, traffic generator, plain reference and yardstick."""
