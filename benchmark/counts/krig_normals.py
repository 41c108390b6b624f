"""Operations and bytes of one launch of ``krig_normals_indexed_kernel``
(the normals chain of a tile step): a frozen copy of ``chip_smoke.py``'s
``solve_flops``, ``krig_flops`` and its byte count of the indexed entry.

Shape: C cells, k neighbours, S pool stations, V variables, P systems a cell
(12 months x V), N neighbourhoods (1: shared by every month)."""


def solve_flops(k: int, xyz: bool = True) -> float:
    """One k-neighbour kriging system, a division, root, exp or asin as one:
    covariance (k^2 / 2 entries of 4), Cholesky (k^3 / 3), two right-hand
    sides through two triangular solves (4 k^2), the OK reduction (10 k);
    with ``xyz`` the k^2 / 2 pair distances of 12."""
    return 2 * k * k + k ** 3 / 3 + 4 * k * k + 10 * k + (6 * k * k if xyz else 0)


def cell_flops(k: int, n_systems: int, n_nbr: int = 1, q: int = 3, qa: int = 3,
               q_fixed: int = 2) -> float:
    """A cell's operations: per neighbourhood the weights, pair distances,
    the design columns no system changes, the gain rows and their small
    solves; per system its own design columns, the normal equations, the
    residuals, the variogram weights and the kriging solve."""
    def products(p):
        return p * (p + 1) // 2 + p

    per_nbr = (10 * k + 6 * k * k + q_fixed * 8 * k
               + (qa * 8 * k + products(qa + 1) * 3 * k + 200))
    per_system = ((q - q_fixed) * 8 * k + products(q + 1) * 3 * k + 200 + 10 * k + 6 * k
                  + solve_flops(k, xyz=False))
    return n_nbr * per_nbr + n_systems * per_system


def flops(C: int, k: int, S: int, V: int, P: int, N: int = 1) -> float:
    return C * cell_flops(k, P, N)


def nbytes(C: int, k: int, S: int, V: int, P: int, N: int = 1) -> float:
    """Inputs read once (idx int64, dist float32, mask bool; the station
    table (S, 19 + 48 V) and the cell table (C, 16), float32) and outputs
    written once (heads (P, C, 8) and gains (N, C, k), float32)."""
    return (N * C * k * (8 + 4 + 1) + (S * (19 + 48 * V) + C * 16) * 4
            + (P * C * 8 + N * C * k) * 4)
