"""The format-independent byte counts, on hand-worked 4×4 matrices."""

from portbench.needed_bytes import cg_step_bytes, pcg_ic0_step_bytes, spmv_bytes


def test_spmv_bytes_4x4():
    # 6 nonzeros: 6·(4 + 4) values and columns, 5·4 row pointer,
    # 4·4 x read, 4·4 y written.
    assert spmv_bytes(6, 4, 4) == 48 + 20 + 16 + 16 == 100
    # bfloat16: 6·(2 + 4) + 20 + 4·2 + 4·2
    assert spmv_bytes(6, 4, 4, value_bytes=2) == 36 + 20 + 8 + 8 == 72
    # a 4×4 diagonal: 4·8 + 20 + 16 + 16
    assert spmv_bytes(4, 4, 4) == 84
    # rectangular 4×2 with 3 nonzeros: 24 + 20 + 2·4 + 4·4
    assert spmv_bytes(3, 4, 2) == 68


def test_solver_step_bytes_4x4():
    # the tridiagonal 4×4 (10 nonzeros: 4 diagonal, 3 below, 3 above)
    a = 10 * 8 + 5 * 4 + 16 + 16
    assert a == 132
    # CG: the SpMV, then q read, x and r read and written, p written
    assert cg_step_bytes(10, 4) == 132 + 6 * 16 == 228
    # IC(0)-PCG, 4 sweeps: A, 3 × strict(L) (3 nonzeros) and 3 × its
    # transpose, then x r p q z invd read and x r p z written
    low = 3 * 8 + 5 * 4 + 16 + 16
    assert low == 76
    assert pcg_ic0_step_bytes(10, 4, 3, 4) == 132 + 6 * 76 + 10 * 16 == 748
    # 2 sweeps: one SpMV per triangle
    assert pcg_ic0_step_bytes(10, 4, 3, 2) == 132 + 2 * 76 + 160
