"""Reference-parity C API (v2): typed d/s/z/c matrix sweep and the tensor
C API contraction driver — the analogs of the reference's C smoke tests
(``tests/dbcsr_test.cpp``, ``tests/dbcsr_tensor_test.cpp``)."""
import os
import subprocess
import sys
import sysconfig
import shutil

import numpy as np
import pytest

import dbcsr_tpu as dt
from dbcsr_tpu.capi import build_capi, header_path

pytestmark = pytest.mark.skipif(
    shutil.which("gcc") is None, reason="no C compiler"
)


MATRIX_PROGRAM = r"""
#include <stdio.h>
#include <stdlib.h>
#include "dbcsr_tpu.h"

#define CHECK(call)                                                   \
  do {                                                                \
    if (call) {                                                       \
      fprintf(stderr, "FAIL %s: %s\n", #call, c_dbcsr_last_error());  \
      return 1;                                                       \
    }                                                                 \
  } while (0)

static int rbs[3] = {2, 3, 2};

/* typed end-to-end: build A (deterministic), C <- A*A^T, report trace/fro */
#define RUN_TYPED(SUF, CTYPE, DT, CPLX)                                     \
  static int run_##SUF(void) {                                              \
    int64_t A = 0, C = 0;                                                   \
    CHECK(c_dbcsr_create_new(&A, "A_" #SUF, 0, 'N', rbs, 3, rbs, 3, DT));   \
    for (int i = 0; i < 3; ++i)                                             \
      for (int j = 0; j < 3; ++j) {                                         \
        if ((i + j) % 2) continue;                                          \
        CTYPE blk[2 * 9];                                                   \
        int m = rbs[i], n = rbs[j];                                         \
        for (int k = 0; k < m * n * (CPLX ? 2 : 1); ++k)                    \
          blk[k] = (CTYPE)(0.01 * (i + 1) + 0.002 * (j + 1) + 0.0001 * k);  \
        CHECK(c_dbcsr_put_block2d_##SUF(A, i, j, blk, m, n, 0));            \
      }                                                                     \
    CHECK(c_dbcsr_finalize(A));                                             \
    CHECK(c_dbcsr_create_template(&C, "C_" #SUF, A, 0, 'N', DT));           \
    CHECK(c_dbcsr_finalize(C));                                             \
    double flop = 0;                                                        \
    CHECK(c_dbcsr_multiply_##SUF('N', 'T', 1.0, 0.0, A, A, 0.0, 0.0, C, 0, \
                                 -1.0, &flop));                             \
    double tre = 0, tim = 0, fro = 0;                                       \
    CHECK(c_dbcsr_trace_##SUF(C, &tre, &tim));                              \
    CHECK(c_dbcsr_frobenius_norm(C, &fro));                                 \
    printf("%s trace %.10e %.10e fro %.10e flop %.3e\n", #SUF, tre, tim,    \
           fro, flop);                                                      \
    /* scale by 2 then compare norms */                                     \
    CHECK(c_dbcsr_scale_##SUF(C, 2.0, 0.0));                                \
    double fro2 = 0;                                                        \
    CHECK(c_dbcsr_frobenius_norm(C, &fro2));                                \
    if (!(fro2 > 1.999 * fro && fro2 < 2.001 * fro)) {                      \
      fprintf(stderr, "%s: scale(2) norm mismatch\n", #SUF);                \
      return 1;                                                             \
    }                                                                       \
    int dtype = 0;                                                          \
    CHECK(c_dbcsr_get_data_type(C, &dtype));                                \
    if (dtype != DT) { fprintf(stderr, "dtype %d != %d\n", dtype, DT);      \
      return 1; }                                                           \
    CHECK(c_dbcsr_release(A));                                              \
    CHECK(c_dbcsr_release(C));                                              \
    return 0;                                                               \
  }

RUN_TYPED(d, double, dbcsr_type_real_8, 0)
RUN_TYPED(s, float, dbcsr_type_real_4, 0)
RUN_TYPED(z, double, dbcsr_type_complex_8, 1)
RUN_TYPED(c, float, dbcsr_type_complex_4, 1)

int main(void) {
  CHECK(c_dbcsr_init_lib());
  if (run_d() || run_s() || run_z() || run_c()) return 1;

  /* iterator + info surface on a small d matrix */
  int64_t A = 0;
  CHECK(c_dbcsr_create_new(&A, "It", 0, 'N', rbs, 3, rbs, 3,
                           dbcsr_type_real_8));
  double blk[9] = {1, 2, 3, 4, 5, 6, 7, 8, 9};
  CHECK(c_dbcsr_put_block2d_d(A, 0, 0, blk, 2, 2, 0));
  CHECK(c_dbcsr_put_block2d_d(A, 1, 2, blk, 3, 2, 0));
  CHECK(c_dbcsr_finalize(A));
  int64_t it = 0;
  int left = 0, count = 0;
  CHECK(c_dbcsr_iterator_start(&it, A));
  for (;;) {
    CHECK(c_dbcsr_iterator_blocks_left(it, &left));
    if (!left) break;
    int row, col, m, n;
    double buf[16];
    CHECK(c_dbcsr_iterator_next_2d_block_d(it, &row, &col, buf, &m, &n));
    count += m * n;
  }
  CHECK(c_dbcsr_iterator_stop(&it));
  printf("iterated %d\n", count);
  int nbr, nbc, nfr, nfc, nblks;
  CHECK(c_dbcsr_get_info(A, &nbr, &nbc, &nfr, &nfc, &nblks));
  printf("info %d %d %d %d %d\n", nbr, nbc, nfr, nfc, nblks);
  char name[64], mt;
  CHECK(c_dbcsr_get_name(A, name, 64));
  CHECK(c_dbcsr_get_matrix_type(A, &mt));
  printf("name %s type %c\n", name, mt);
  double occ;
  CHECK(c_dbcsr_get_occupation(A, &occ));
  if (!(occ > 0 && occ <= 1)) return 1;
  CHECK(c_dbcsr_release(A));
  CHECK(c_dbcsr_finalize_lib());
  printf("OK\n");
  return 0;
}
"""


TENSOR_PROGRAM = r"""
#include <stdio.h>
#include <stdlib.h>
#include "dbcsr_tpu.h"

#define CHECK(call)                                                   \
  do {                                                                \
    if (call) {                                                       \
      fprintf(stderr, "FAIL %s: %s\n", #call, c_dbcsr_last_error());  \
      return 1;                                                       \
    }                                                                 \
  } while (0)

/* rank-3 x rank-2 contraction T_ijk * M_kl -> R_ijl — the shape of the
 * reference's tensor C API test (tests/dbcsr_tensor_test.cpp) */
int main(void) {
  CHECK(c_dbcsr_init_lib());

  int bs_i[2] = {2, 3};
  int bs_j[2] = {2, 2};
  int bs_k[3] = {2, 1, 2};
  int bs_l[1] = {4};

  /* tensor A: (ij|k) */
  int nblk_a[3] = {2, 2, 3};
  const int *sizes_a[3] = {bs_i, bs_j, bs_k};
  int map1_a[2] = {0, 1}, map2_a[1] = {2};
  int64_t TA = 0;
  CHECK(c_dbcsr_t_create_new(&TA, "TA", 3, nblk_a, sizes_a, map1_a, 2,
                             map2_a, 1, dbcsr_type_real_8));
  /* tensor B: (k|l) */
  int nblk_b[2] = {3, 1};
  const int *sizes_b[2] = {bs_k, bs_l};
  int map1_b[1] = {0}, map2_b[1] = {1};
  int64_t TB = 0;
  CHECK(c_dbcsr_t_create_new(&TB, "TB", 2, nblk_b, sizes_b, map1_b, 1,
                             map2_b, 1, dbcsr_type_real_8));
  /* result C: (ij|l) */
  int nblk_c[3] = {2, 2, 1};
  const int *sizes_c[3] = {bs_i, bs_j, bs_l};
  int map1_c[2] = {0, 1}, map2_c[1] = {2};
  int64_t TC = 0;
  CHECK(c_dbcsr_t_create_new(&TC, "TC", 3, nblk_c, sizes_c, map1_c, 2,
                             map2_c, 1, dbcsr_type_real_8));

  /* fill A and B with deterministic values (every block) */
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      for (int k = 0; k < 3; ++k) {
        int idx[3] = {i, j, k};
        int shp[3] = {bs_i[i], bs_j[j], bs_k[k]};
        int nel = shp[0] * shp[1] * shp[2];
        double blk[32];
        for (int e = 0; e < nel; ++e)
          blk[e] = 0.1 * (i + 1) + 0.01 * (j + 1) + 0.001 * (k + 1)
                   + 0.0001 * e;
        CHECK(c_dbcsr_t_put_block_d(TA, 3, idx, shp, blk, 0));
      }
  for (int k = 0; k < 3; ++k) {
    int idx[2] = {k, 0};
    int shp[2] = {bs_k[k], 4};
    int nel = shp[0] * shp[1];
    double blk[8];
    for (int e = 0; e < nel; ++e) blk[e] = 0.05 * (k + 1) + 0.001 * e;
    CHECK(c_dbcsr_t_put_block_d(TB, 2, idx, shp, blk, 0));
  }
  CHECK(c_dbcsr_t_finalize(TA));
  CHECK(c_dbcsr_t_finalize(TB));

  int con1[1] = {2}, ncon1[2] = {0, 1};
  int con2[1] = {0}, ncon2[1] = {1};
  double flop = 0;
  CHECK(c_dbcsr_t_contract_d(1.0, 0.0, TA, TB, 0.0, 0.0, TC, con1, 1,
                             ncon1, 2, con2, 1, ncon2, 1, NULL, 0, NULL, 0,
                             NULL, NULL, NULL, -1.0, &flop));

  /* checks: dims, counts, a probed block */
  int nd = 0;
  CHECK(c_dbcsr_t_ndims(TC, &nd));
  int dims[3];
  CHECK(c_dbcsr_t_dims(TC, dims, 3));
  printf("ndims %d dims %d %d %d\n", nd, dims[0], dims[1], dims[2]);
  int nblks = 0;
  CHECK(c_dbcsr_t_get_num_blocks(TC, &nblks));
  int64_t nze = 0;
  CHECK(c_dbcsr_t_get_nze(TC, &nze));
  printf("nblks %d nze %lld flop %.3e\n", nblks, (long long)nze, flop);
  int idx0[3] = {0, 0, 0};
  double out[16];
  int found = 0, shp[3];
  CHECK(c_dbcsr_t_get_block_d(TC, 3, idx0, out, &found, shp));
  if (!found) { fprintf(stderr, "C(0,0,0) missing\n"); return 1; }
  printf("c000 %.12e shape %d %d %d\n", out[0], shp[0], shp[1], shp[2]);

  /* bounded contraction: k restricted to the first two k blocks (the
   * reference's bounds_1 batching) must equal the slice of the full ref */
  int64_t TCB = 0;
  CHECK(c_dbcsr_t_create_template(TC, &TCB, "TCB", dbcsr_type_real_8));
  int b1[2] = {0, 3}; /* k elements [0, 3) = blocks {2,1} of bs_k */
  CHECK(c_dbcsr_t_contract_d(1.0, 0.0, TA, TB, 0.0, 0.0, TCB, con1, 1,
                             ncon1, 2, con2, 1, ncon2, 1, NULL, 0, NULL, 0,
                             b1, NULL, NULL, -1.0, &flop));
  double cb0[16];
  int foundb = 0, shpb[3];
  CHECK(c_dbcsr_t_get_block_d(TCB, 3, idx0, cb0, &foundb, shpb));
  if (!foundb) { fprintf(stderr, "bounded C(0,0,0) missing\n"); return 1; }
  printf("cb000 %.12e\n", cb0[0]);
  CHECK(c_dbcsr_t_destroy(&TCB));

  /* iterator sweep */
  int64_t it = 0;
  int left = 0, seen = 0;
  CHECK(c_dbcsr_t_iterator_start(&it, TC));
  for (;;) {
    CHECK(c_dbcsr_t_iterator_blocks_left(it, &left));
    if (!left) break;
    int index[3], sizes[3];
    double buf[64];
    CHECK(c_dbcsr_t_iterator_next_block_d(it, index, buf, sizes, 3));
    seen++;
  }
  CHECK(c_dbcsr_t_iterator_stop(&it));
  if (seen != nblks) { fprintf(stderr, "iterator mismatch\n"); return 1; }

  /* tensor <-> matrix roundtrip */
  int64_t M = 0, T2 = 0;
  CHECK(c_dbcsr_create_new(&M, "M", 0, 'N', bs_i, 2, bs_i, 2,
                           dbcsr_type_real_8));
  double mb[9] = {1, 2, 3, 4, 5, 6, 7, 8, 9};
  CHECK(c_dbcsr_put_block2d_d(M, 0, 1, mb, 2, 3, 0));
  CHECK(c_dbcsr_finalize(M));
  CHECK(c_dbcsr_t_create_matrix(M, &T2, "T2"));
  int nd2 = 0;
  CHECK(c_dbcsr_t_ndims(T2, &nd2));
  if (nd2 != 2) { fprintf(stderr, "matrix tensor rank\n"); return 1; }

  /* typed index-only estimate (round 3): count + result coordinates */
  int nblks_idx = 0;
  int ridx[12];
  CHECK(c_dbcsr_t_contract_index_d(1.0, 0.0, TA, TB, 0.0, 0.0, TC, con1, 1,
                                   ncon1, 2, con2, 1, ncon2, 1, -1.0,
                                   &nblks_idx, ridx, 12));
  printf("cidx %d %d %d %d\n", nblks_idx, ridx[0], ridx[1], ridx[2]);

  /* typed filter: absolute Frobenius threshold far above all blocks
   * empties the tensor; method != 1 must fail */
  CHECK(c_dbcsr_t_filter_d(TC, 1e9, 1, 0));
  int nblks_f = 0;
  CHECK(c_dbcsr_t_get_num_blocks(TC, &nblks_f));
  printf("nblks_filtered %d\n", nblks_f);
  if (!c_dbcsr_t_filter_d(TC, 1.0, 2, 0)) {
    fprintf(stderr, "method=2 should fail\n");
    return 1;
  }

  CHECK(c_dbcsr_t_destroy(&TA));
  CHECK(c_dbcsr_t_destroy(&TB));
  CHECK(c_dbcsr_t_destroy(&TC));
  CHECK(c_dbcsr_t_destroy(&T2));
  CHECK(c_dbcsr_release(M));
  CHECK(c_dbcsr_finalize_lib());
  printf("OK\n");
  return 0;
}
"""


def _build_and_run(tmp_path, program, name):
    so = build_capi()
    if so is None:
        pytest.skip("could not build C shim (no shared libpython?)")
    src = tmp_path / f"{name}.c"
    src.write_text(program)
    exe = tmp_path / name
    subprocess.run(
        ["gcc", "-O1", str(src), so, f"-I{os.path.dirname(header_path())}",
         f"-Wl,-rpath,{os.path.dirname(so)}", "-o", str(exe)],
        check=True, capture_output=True,
    )
    env = dict(os.environ)
    site = sysconfig.get_paths()["purelib"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join([repo, site])
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [str(exe)], capture_output=True, text=True, env=env, timeout=540
    )
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip().endswith("OK"), out.stdout
    return out.stdout


def test_capi_typed_matrix_sweep(tmp_path):
    out = _build_and_run(tmp_path, MATRIX_PROGRAM, "typed")
    lines = {
        parts[0]: parts[1:]
        for parts in (l.split() for l in out.splitlines())
        if parts
    }
    # oracle for the d class
    rbs = np.array([2, 3, 2], dtype=np.int32)
    bld = dt.BCSRBuilder(rbs, rbs, dtype=np.float64)
    for i in range(3):
        for j in range(3):
            if (i + j) % 2:
                continue
            m, n = int(rbs[i]), int(rbs[j])
            blk = (
                0.01 * (i + 1) + 0.002 * (j + 1)
                + 0.0001 * np.arange(m * n)
            ).reshape(m, n)
            bld.put_block(i, j, blk)
    a = bld.finalize()
    c = dt.multiply("N", "T", 1.0, a, a)
    np.testing.assert_allclose(
        float(lines["d"][1]), dt.trace(c), rtol=1e-10
    )
    np.testing.assert_allclose(
        float(lines["d"][4]), dt.norm_frobenius(c), rtol=1e-10
    )
    # complex class: imaginary part of trace(A A^T) with our fill is != 0
    assert "z" in lines and "c" in lines and "s" in lines


def test_capi_tensor_contraction(tmp_path):
    out = _build_and_run(tmp_path, TENSOR_PROGRAM, "tensor")
    lines = {
        parts[0]: parts[1:]
        for parts in (l.split() for l in out.splitlines())
        if parts
    }
    assert lines["ndims"][0] == "3"
    # oracle: same contraction in Python
    from dbcsr_tpu.tensors import TensorBuilder, contract

    bs_i = np.array([2, 3]); bs_j = np.array([2, 2])
    bs_k = np.array([2, 1, 2]); bs_l = np.array([4])
    ta = TensorBuilder([bs_i, bs_j, bs_k], dtype=np.float64)
    for i in range(2):
        for j in range(2):
            for k in range(3):
                shp = (int(bs_i[i]), int(bs_j[j]), int(bs_k[k]))
                nel = int(np.prod(shp))
                blk = (
                    0.1 * (i + 1) + 0.01 * (j + 1) + 0.001 * (k + 1)
                    + 0.0001 * np.arange(nel)
                ).reshape(shp)
                ta.put_block((i, j, k), blk)
    tb = TensorBuilder([bs_k, bs_l], dtype=np.float64)
    for k in range(3):
        shp = (int(bs_k[k]), 4)
        blk = (0.05 * (k + 1) + 0.001 * np.arange(shp[0] * 4)).reshape(shp)
        tb.put_block((k, 0), blk)
    A, B = ta.finalize(), tb.finalize()
    R = contract(
        1.0, A, B, contract_1=(2,), notcontract_1=(0, 1),
        contract_2=(0,), notcontract_2=(1,),
    )
    ref = np.einsum("ijk,kl->ijl", A.to_dense(), B.to_dense())
    np.testing.assert_allclose(R.to_dense(), ref, atol=1e-12)
    blk = R.get_block((0, 0, 0))
    np.testing.assert_allclose(
        float(lines["c000"][0]), blk.reshape(-1)[0], rtol=1e-10
    )
    assert int(lines["nblks"][0]) == R.nblks
    # bounded contraction oracle: k elements [0, 3)
    refb = np.einsum(
        "ijk,kl->ijl", A.to_dense()[:, :, :3], B.to_dense()[:3, :]
    )
    np.testing.assert_allclose(
        float(lines["cb000"][0]), refb[0, 0, 0], rtol=1e-10
    )
    # typed contract_index: full 2x2x1 result pattern, first coord (0,0,0)
    assert lines["cidx"] == ["4", "0", "0", "0"]
    # typed filter with a huge absolute eps empties the tensor
    assert lines["nblks_filtered"][0] == "0"
