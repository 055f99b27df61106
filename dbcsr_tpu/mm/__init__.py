"""Multiply engine (SURVEY.md §2.3): host symbolic planning, tile-stack
kernels, dense einsum fast path, distributed Cannon/SUMMA drivers.
"""
from .engine import (
    build_distributed_executor,
    build_multiply_executor,
    multiply,
    select_route,
)
from .filtered import FilteredExecutor, build_filtered_executor
from .kernels import tile_stack_matmul_crun, tile_stack_matmul_xla
from .plan import mnk_statistics, symbolic_product
from .tileplan import TileStackPlan, plan_tile_stacks_stores

__all__ = [
    "multiply",
    "build_multiply_executor",
    "build_distributed_executor",
    "build_filtered_executor",
    "FilteredExecutor",
    "symbolic_product",
    "mnk_statistics",
    "plan_tile_stacks_stores",
    "TileStackPlan",
    "select_route",
    "tile_stack_matmul_crun",
    "tile_stack_matmul_xla",
]
