"""The simulator's sweep drivers, run as modules:
``python -m swarmkit_tpu_torch.scripts.chaos_sweep`` and
``python -m swarmkit_tpu_torch.scripts.failover_fuzz``."""
