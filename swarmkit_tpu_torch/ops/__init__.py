from .hashing import str_hash
from .kernel import (
    FusedCarry, FusedGroups, FusedShared, FusedStrategy, GroupInputs,
    NodeInputs, StrategyInputs, branch_sums, feasibility,
    feasibility_and_capacity, fetch_plan, plan_fused, plan_group,
    plan_strategy, seg_packfill, seg_waterfill, spread_score, strategy_score,
)
from .planner import TorchPlanner
from .preempt import plan_victims, select_victims

__all__ = [
    "FusedCarry", "FusedGroups", "FusedShared", "FusedStrategy",
    "GroupInputs", "NodeInputs", "StrategyInputs", "TorchPlanner",
    "branch_sums", "feasibility", "feasibility_and_capacity", "fetch_plan",
    "plan_fused", "plan_group", "plan_strategy", "plan_victims",
    "seg_packfill", "seg_waterfill", "select_victims", "spread_score",
    "str_hash", "strategy_score",
]
