"""Block-sparse tensor framework (rank 2..4+).

Analog of ``src/tensors/`` (SURVEY.md §2.7): tensors fold to 2-D
block-sparse matrices via an nd→2d mapping; contraction aligns operand
layouts and runs the folded product through the TAS layer.
"""
from .contract import BatchedContract, contract, contraction_layouts, copy_tensor
from .index import NDMapping, fold_indices, grouped_block_sizes, unfold_indices
from .pgrid import TensorPGrid, default_pgrid_dims
from .tensor import (
    Tensor,
    TensorBuilder,
    matrix_from_tensor,
    split_blocks,
    tensor_from_matrix,
)

__all__ = [
    "Tensor",
    "TensorBuilder",
    "NDMapping",
    "TensorPGrid",
    "contract",
    "contraction_layouts",
    "copy_tensor",
    "split_blocks",
    "BatchedContract",
    "tensor_from_matrix",
    "matrix_from_tensor",
    "fold_indices",
    "unfold_indices",
    "grouped_block_sizes",
    "default_pgrid_dims",
]
