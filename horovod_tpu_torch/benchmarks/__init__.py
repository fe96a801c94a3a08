"""Benchmarks of the port, run as ``python -m horovod_tpu_torch.benchmarks.<name>``."""
