"""Tensor framework tests.

Mirrors the reference's ``tests/dbcsr_tensor_unittest.F`` (818 LoC): nd
index-mapping checks, block access, layout reshapes, and contraction cases
across layouts validated against a dense ``einsum`` oracle (the reference's
``dbcsr_t_contract_test``, ``src/tensors/dbcsr_tensor_test.F:770``).
"""
import numpy as np
import pytest

import dbcsr_tpu as dt
from dbcsr_tpu.tensors import (
    BatchedContract,
    NDMapping,
    Tensor,
    TensorBuilder,
    contract,
    copy_tensor,
    fold_indices,
    matrix_from_tensor,
    tensor_from_matrix,
    unfold_indices,
)


def _random_tensor(block_sizes, occ, rng, mapping=None, name="T", dtype=np.float64):
    bs = [np.asarray(b, dtype=np.int32) for b in block_sizes]
    builder = TensorBuilder(bs, mapping, name=name, dtype=dtype)
    nbpd = [len(b) for b in bs]
    total = int(np.prod(nbpd))
    chosen = rng.random(total) < occ
    for flat in np.flatnonzero(chosen):
        bi = np.unravel_index(flat, nbpd)
        shp = tuple(int(bs[d][bi[d]]) for d in range(len(bs)))
        builder.put_block(bi, rng.standard_normal(shp))
    return builder.finalize()


def test_fold_unfold_roundtrip():
    dims = np.array([3, 4, 5])
    rng = np.random.default_rng(0)
    idx = np.stack(
        [rng.integers(0, d, size=50) for d in dims], axis=1
    ).astype(np.int64)
    flat = fold_indices(idx, dims)
    assert flat.max() < 60
    back = unfold_indices(flat, dims)
    np.testing.assert_array_equal(back, idx)


def test_mapping_fold_matches_manual():
    m = NDMapping(3, (0, 2), (1,))
    nbpd = [2, 3, 4]
    bi = np.array([[1, 2, 3]])
    rows, cols = m.fold(bi, nbpd)
    assert rows[0] == 1 * 4 + 3  # (dim0, dim2) row-major
    assert cols[0] == 2
    back = m.unfold(rows, cols, nbpd)
    np.testing.assert_array_equal(back, bi)


def test_block_access_roundtrip():
    rng = np.random.default_rng(1)
    bs = [np.array([2, 3]), np.array([4]), np.array([2, 2])]
    t = _random_tensor(bs, 1.0, rng, NDMapping(3, (1,), (2, 0)))
    blk = rng.standard_normal((3, 4, 2))
    builder = TensorBuilder(bs, NDMapping(3, (1,), (2, 0)), dtype=np.float64)
    builder.put_block((1, 0, 1), blk)
    t2 = builder.finalize()
    got = t2.get_block((1, 0, 1))
    np.testing.assert_allclose(got, blk)
    assert t2.get_block((0, 0, 0)) is None


def test_with_layout_preserves_dense():
    rng = np.random.default_rng(2)
    bs = [np.array([2, 3]), np.array([1, 4]), np.array([3, 2])]
    t = _random_tensor(bs, 0.7, rng, NDMapping(3, (0,), (1, 2)))
    d0 = t.to_dense()
    for m1, m2 in [((1,), (0, 2)), ((2, 0), (1,)), ((0, 1), (2,))]:
        t2 = t.with_layout(NDMapping(3, m1, m2))
        np.testing.assert_allclose(t2.to_dense(), d0)


def test_copy_tensor_order_permutes_dims():
    rng = np.random.default_rng(3)
    bs = [np.array([2, 2]), np.array([3]), np.array([1, 2])]
    t = _random_tensor(bs, 0.8, rng)
    p = copy_tensor(t, order=(2, 0, 1))
    np.testing.assert_allclose(p.to_dense(), np.transpose(t.to_dense(), (2, 0, 1)))


def test_matrix_tensor_roundtrip():
    rng = np.random.default_rng(4)
    rbs = dt.random_block_sizes(12, [2, 3], rng)
    cbs = dt.random_block_sizes(10, [2, 5], rng)
    m = dt.random_matrix(rbs, cbs, 0.5, rng, dtype=np.float64)
    t = tensor_from_matrix(m)
    assert t.ndim == 2
    np.testing.assert_allclose(t.to_dense(), np.asarray(m.to_dense()))
    m2 = matrix_from_tensor(t.with_layout(NDMapping(2, (1,), (0,))))
    np.testing.assert_allclose(
        np.asarray(m2.to_dense()), np.asarray(m.to_dense())
    )


# ---- contraction vs einsum oracle -----------------------------------------

def _einsum_check(spec, a, b, out, alpha=1.0):
    ref = alpha * np.einsum(spec, a.to_dense(), b.to_dense())
    np.testing.assert_allclose(out.to_dense(), ref, rtol=1e-10, atol=1e-10)


def test_contract_rank3_rank2():
    # C[i,j,l] = sum_k A[i,j,k] B[k,l]    ("ijk,kl->ijl")
    rng = np.random.default_rng(5)
    bs_i, bs_j, bs_k, bs_l = (
        np.array([2, 3]), np.array([2, 2]), np.array([3, 1, 2]), np.array([4])
    )
    a = _random_tensor([bs_i, bs_j, bs_k], 0.7, rng, NDMapping(3, (0, 1), (2,)))
    b = _random_tensor([bs_k, bs_l], 0.8, rng, NDMapping(2, (0,), (1,)))
    out = contract(
        1.0, a, b,
        contract_1=(2,), notcontract_1=(0, 1),
        contract_2=(0,), notcontract_2=(1,),
    )
    _einsum_check("ijk,kl->ijl", a, b, out)


def test_contract_rank3_rank3_to_rank2():
    # C[i,l] = sum_{j,k} A[i,j,k] B[j,k,l]   ("ijk,jkl->il")
    rng = np.random.default_rng(6)
    bs_i, bs_j, bs_k, bs_l = (
        np.array([3, 2]), np.array([2, 1]), np.array([2, 2]), np.array([3, 3])
    )
    a = _random_tensor([bs_i, bs_j, bs_k], 0.6, rng, NDMapping(3, (0,), (1, 2)))
    b = _random_tensor([bs_j, bs_k, bs_l], 0.6, rng, NDMapping(3, (2,), (0, 1)))
    out = contract(
        1.0, a, b,
        contract_1=(1, 2), notcontract_1=(0,),
        contract_2=(0, 1), notcontract_2=(2,),
    )
    _einsum_check("ijk,jkl->il", a, b, out)


def test_contract_rank3_rank3_to_rank4_with_maps():
    # C[l,i,m,j] = sum_k A[i,j,k] B[k,l,m]  (maps scatter output dims)
    rng = np.random.default_rng(7)
    bs_i, bs_j, bs_k = np.array([2, 2]), np.array([3]), np.array([2, 1])
    bs_l, bs_m = np.array([2]), np.array([1, 2])
    a = _random_tensor([bs_i, bs_j, bs_k], 0.8, rng)
    b = _random_tensor([bs_k, bs_l, bs_m], 0.8, rng)
    out = contract(
        1.0, a, b,
        contract_1=(2,), notcontract_1=(0, 1),
        contract_2=(0,), notcontract_2=(1, 2),
        map_1=(1, 3), map_2=(0, 2),
    )
    _einsum_check("ijk,klm->limj", a, b, out)


def test_contract_rank4_inputs():
    # C[i,j,m,n] = sum_{k,l} A[i,j,k,l] B[k,l,m,n]  ("ijkl,klmn->ijmn") —
    # rank-4 operands, the reference's maxrank (dbcsr_tensor.fypp)
    rng = np.random.default_rng(11)
    bs_i, bs_j = np.array([2, 2]), np.array([3])
    bs_k, bs_l = np.array([2, 1]), np.array([2])
    bs_m, bs_n = np.array([2]), np.array([1, 2])
    a = _random_tensor(
        [bs_i, bs_j, bs_k, bs_l], 0.7, rng, NDMapping(4, (0, 1), (2, 3))
    )
    b = _random_tensor(
        [bs_k, bs_l, bs_m, bs_n], 0.7, rng, NDMapping(4, (0, 1), (2, 3))
    )
    out = contract(
        1.0, a, b,
        contract_1=(2, 3), notcontract_1=(0, 1),
        contract_2=(0, 1), notcontract_2=(2, 3),
    )
    _einsum_check("ijkl,klmn->ijmn", a, b, out)


def test_contract_rank4_rank2_misaligned_layout():
    # rank-4 x rank-2 where A's at-rest layout does NOT match the
    # contraction grouping (forces the align/refold path)
    rng = np.random.default_rng(12)
    bs_i, bs_j, bs_k, bs_l = (
        np.array([2]), np.array([2, 1]), np.array([3]), np.array([2, 2])
    )
    bs_p = np.array([3, 1])
    a = _random_tensor(
        [bs_i, bs_j, bs_k, bs_l], 0.8, rng, NDMapping(4, (0, 2), (1, 3))
    )
    b = _random_tensor([bs_l, bs_p], 0.9, rng)
    out = contract(
        1.0, a, b,
        contract_1=(3,), notcontract_1=(0, 1, 2),
        contract_2=(0,), notcontract_2=(1,),
    )
    _einsum_check("ijkl,lp->ijkp", a, b, out)


def test_contract_alpha_beta_accumulate():
    rng = np.random.default_rng(8)
    bs_i, bs_k, bs_j = np.array([2, 3]), np.array([2, 2]), np.array([4])
    a = _random_tensor([bs_i, bs_k], 0.8, rng)
    b = _random_tensor([bs_k, bs_j], 0.8, rng)
    c0 = _random_tensor([bs_i, bs_j], 0.6, rng)
    out = contract(
        2.0, a, b, beta=0.5, c=c0,
        contract_1=(1,), notcontract_1=(0,),
        contract_2=(0,), notcontract_2=(1,),
    )
    ref = 2.0 * np.einsum("ik,kj->ij", a.to_dense(), b.to_dense()) + 0.5 * c0.to_dense()
    np.testing.assert_allclose(out.to_dense(), ref, rtol=1e-10, atol=1e-10)


def test_contract_filter_eps_drops_tiny_blocks():
    rng = np.random.default_rng(9)
    bs = np.array([2, 2])
    builder = TensorBuilder([bs, bs], dtype=np.float64)
    builder.put_block((0, 0), np.full((2, 2), 10.0))
    builder.put_block((1, 1), np.full((2, 2), 1e-14))
    a = builder.finalize()
    out = contract(
        1.0, a, a,
        contract_1=(1,), notcontract_1=(0,),
        contract_2=(0,), notcontract_2=(1,),
        filter_eps=1e-6,
    )
    # only the (0,0) product block survives
    assert out.nblks == 1
    assert out.get_block((0, 0)) is not None


def test_contract_bounds_batched_k_sum():
    # batching over contracted ranges must sum to the full contraction
    rng = np.random.default_rng(10)
    bs_i, bs_k, bs_j = np.array([3, 2]), np.array([2, 3, 1, 2]), np.array([2, 2])
    a = _random_tensor([bs_i, bs_k], 0.9, rng)
    b = _random_tensor([bs_k, bs_j], 0.9, rng)
    full = contract(
        1.0, a, b,
        contract_1=(1,), notcontract_1=(0,),
        contract_2=(0,), notcontract_2=(1,),
    ).to_dense()
    koff = np.concatenate([[0], np.cumsum(bs_k)])
    acc = np.zeros_like(full)
    for b0, b1 in [(0, 2), (2, 4)]:
        part = contract(
            1.0, a, b,
            contract_1=(1,), notcontract_1=(0,),
            contract_2=(0,), notcontract_2=(1,),
            bounds={"contract": {1: (int(koff[b0]), int(koff[b1]))}},
        )
        acc = acc + part.to_dense()
    np.testing.assert_allclose(acc, full, rtol=1e-10, atol=1e-12)


def test_batched_contract_caches_executor():
    rng = np.random.default_rng(11)
    bs_i, bs_k, bs_j = np.array([2, 2]), np.array([3]), np.array([2])
    a = _random_tensor([bs_i, bs_k], 1.0, rng)
    b = _random_tensor([bs_k, bs_j], 1.0, rng)
    with BatchedContract() as batch:
        o1 = batch.contract(
            a, b,
            contract_1=(1,), notcontract_1=(0,),
            contract_2=(0,), notcontract_2=(1,),
        )
        o2 = batch.contract(
            a, b,
            contract_1=(1,), notcontract_1=(0,),
            contract_2=(0,), notcontract_2=(1,),
        )
        assert len(batch._tas._cache) == 1
    ref = np.einsum("ik,kj->ij", a.to_dense(), b.to_dense())
    np.testing.assert_allclose(o1.to_dense(), ref, atol=1e-10)
    np.testing.assert_allclose(o2.to_dense(), ref, atol=1e-10)


def test_tensor_occupation_and_shape():
    rng = np.random.default_rng(12)
    bs = [np.array([2, 3]), np.array([4]), np.array([1, 1])]
    t = _random_tensor(bs, 1.0, rng)
    assert t.shape == (5, 4, 2)
    assert t.occupation() == pytest.approx(1.0)
