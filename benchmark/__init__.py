"""The benchmark of ``llckbdm_tpu_torch``, the PyTorch and CUDA port of the
LL-KBDM pipeline.  ``python benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once; ``benchmark/README.md``
says how cells, configurations and metrics are found by name."""
