"""Fixture: device-path module reaching into forbidden layers, jax and the
reference package (fires).

The test harness lints this file as ``swarmkit_tpu_torch/ops/fixture.py``.
"""

import swarmkit_tpu_torch.state.store                      # ops -> state
from swarmkit_tpu_torch.manager.dispatcher import Dispatcher   # ops -> manager
from swarmkit_tpu_torch.sim import run_scenario            # production -> sim

from ..orchestrator import common                    # ops -> orchestrator

import jax.numpy as jnp                              # the port imports no jax
from swarmkit_tpu.ops import kernel                  # nor the reference
