"""Tall-and-skinny (TAS) matrix layer.

Analog of ``src/tas/`` (see SURVEY.md §2.6): matrices where one
dimension is much larger than the other (tensor unfoldings). The long
dimension is partitioned into ``nsplit`` groups; multiplication reshapes the
two large operands to compatible splits, replicates the small operand, runs
an ordinary multiply per group, and merges/sums the results
(``dbcsr_tas_multiply``, ``src/tas/dbcsr_tas_mm.F:79-782``).
"""
from .matrix import TASMatrix, extract_block_subset, tas_from_matrix
from .mm import (
    BatchedTAS,
    result_index_estimate,
    split_factor_estimate,
    tas_multiply,
)
from .parallel import tas_multiply_parallel, tas_multiply_subgrid
from .split import COLSPLIT, ROWSPLIT, TASSplit

__all__ = [
    "TASMatrix",
    "TASSplit",
    "ROWSPLIT",
    "COLSPLIT",
    "tas_from_matrix",
    "tas_multiply",
    "tas_multiply_parallel",
    "tas_multiply_subgrid",
    "split_factor_estimate",
    "result_index_estimate",
    "extract_block_subset",
    "BatchedTAS",
]
