"""dbcsr_tpu — distributed block-sparse matrix & tensor library on JAX.

A JAX/XLA/Pallas implementation of the capabilities of cp2k/dbcsr (see
SURVEY.md for the reference analysis and ARCHITECTURE.md for the design).
Public API mirrors the reference's Fortran/C API surface
(``src/dbcsr_api.F``) in Python-first form. The backend is JAX's own
choice, steered by ``JAX_PLATFORMS``.
"""
from .block.bcsr import (
    BCSRBuilder,
    BCSRMatrix,
    SYM_ANTISYMMETRIC,
    SYM_HERMITIAN,
    SYM_NONE,
    SYM_SYMMETRIC,
)
from .block.index import (
    BCSRIndex,
    build_index,
    convert_offsets_to_sizes,
    convert_sizes_to_offsets,
    merge_index,
)
from .core import (
    Config,
    DbcsrError,
    config_override,
    finalize_lib,
    get_config,
    init_lib,
    print_config,
    print_statistics,
    set_config,
    timed,
    timer_report,
)
from .mm.engine import multiply
from .mm.filtered import FilteredExecutor, build_filtered_executor
from .mm.reorder import locality_block_permutation, permute_blocks
from .ops.arithmetic import (
    ELEMENT_FUNCTIONS,
    add,
    add_on_diag,
    crop,
    dot,
    filter_blocks,
    function_of_elements,
    get_block_diag,
    get_diag,
    hadamard_product,
    scale,
    scale_by_vector,
    set_diag,
    set_value,
    trace,
    triu,
    zero,
)
from .ops.norms import (
    block_norms,
    block_norms_sq,
    norm_column,
    norm_frobenius,
    norm_gershgorin,
    norm_maxabs,
)
from .ops.csr import csr_write, from_csr, to_csr, to_csr_filter
from .ops.io import (
    binary_read,
    binary_write,
    checksum,
    get_info,
    get_stored_coordinates,
    print_block_sum,
    print_matrix,
    verify_matrix,
)
from .ops.random import random_block_sizes, random_dist_vector, random_matrix
from .ops.transform import (
    copy,
    desymmetrize,
    distribute,
    make_dense,
    make_undense,
    may_be_dense,
    redistribute,
    replicate_all,
    retile,
    sum_replicated,
    transpose,
)
from . import tas, tensors, testing
from .tas import TASMatrix, tas_multiply
from .tensors import NDMapping, Tensor, TensorBuilder, contract

__version__ = "0.1.0"
