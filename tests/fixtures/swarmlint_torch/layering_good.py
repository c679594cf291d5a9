"""Fixture: the corrected twin — device path sees only what it may.

The test harness lints this file as ``swarmkit_tpu_torch/ops/fixture.py``.
"""

import torch                                         # third-party: free

from swarmkit_tpu_torch.models.types import TaskState      # ops -> models
from swarmkit_tpu_torch.utils.metrics import registry      # ops -> utils
from swarmkit_tpu_torch.scheduler.nodeinfo import NodeInfo  # ops -> scheduler
from swarmkit_tpu_torch.obs.trace import tracer            # ops -> obs

from . import hashing                                # within the package
