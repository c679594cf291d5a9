"""Drivers run as modules: the simulator's sweeps
(``python -m swarmkit_tpu_torch.scripts.chaos_sweep``,
``python -m swarmkit_tpu_torch.scripts.failover_fuzz``), the linter
(``python -m swarmkit_tpu_torch.scripts.swarmlint``), the learned
scorer's trainer (``python -m swarmkit_tpu_torch.scripts.train_scorer``)
and the trace report (``python -m swarmkit_tpu_torch.scripts.trace_report``)."""
