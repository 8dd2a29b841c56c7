"""The benchmark of the PyTorch and CUDA port ``supereight_tpu_torch``:
``python3 slambench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``run.py``)."""
