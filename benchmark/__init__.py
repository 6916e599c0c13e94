"""The benchmark of the PyTorch and CUDA port (``pamnet_tpu_torch``):
``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (``README.md``)."""
