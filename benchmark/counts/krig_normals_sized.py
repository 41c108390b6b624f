"""Operations and bytes of one launch of ``krig_normals_indexed_kernel`` at
per-variable sizes: ``counts/krig_normals.py`` with the slots read (k, the
neighbourhoods' width) apart from the slots the systems use (``k_normal``,
the first of them) and those the gain rows use (``k_anom``). At
``k_normal = k_anom = k`` both give the same counts.

Shape: C cells, k slots a neighbourhood, S pool stations, V variables in the
station table, P systems in the launch, N neighbourhoods (1: shared by every
month)."""


def solve_flops(k: int, xyz: bool = True) -> float:
    """One k-neighbour kriging system (``counts/krig_normals.py``)."""
    return 2 * k * k + k ** 3 / 3 + 4 * k * k + 10 * k + (6 * k * k if xyz else 0)


def cell_flops(k_normal: int, k_anom: int, n_systems: int, n_nbr: int = 1, q: int = 3,
               qa: int = 3, q_fixed: int = 2) -> float:
    """A cell's operations: per neighbourhood the weights, the pair distances
    and the design columns no system changes, on the systems' slots, and the
    gain rows with their small solves on the gain rows' slots, their own
    weights besides where the two differ; per system its own design columns,
    the normal equations, the residuals, the variogram weights and the
    kriging solve, on the systems' slots."""
    def products(p):
        return p * (p + 1) // 2 + p

    kn, ka = k_normal, k_anom
    per_nbr = (10 * kn + 6 * kn * kn + q_fixed * 8 * kn
               + (qa * 8 * ka + products(qa + 1) * 3 * ka + 200)
               + (10 * ka if ka != kn else 0))
    per_system = ((q - q_fixed) * 8 * kn + products(q + 1) * 3 * kn + 200 + 10 * kn + 6 * kn
                  + solve_flops(kn, xyz=False))
    return n_nbr * per_nbr + n_systems * per_system


def flops(C: int, k: int, S: int, V: int, P: int, N: int = 1, k_normal: int | None = None,
          k_anom: int | None = None) -> float:
    kn = k if k_normal is None else k_normal
    ka = k if k_anom is None else k_anom
    return C * cell_flops(kn, ka, P, N)


def nbytes(C: int, k: int, S: int, V: int, P: int, N: int = 1, k_normal: int | None = None,
           k_anom: int | None = None) -> float:
    """Inputs read once (idx int64, dist float32, mask bool, all k slots; the
    station table (S, 19 + 48 V) and the cell table (C, 16), float32) and
    outputs written once (heads (P, C, 8) and gains (N, C, k), float32): the
    sizes change no byte."""
    return (N * C * k * (8 + 4 + 1) + (S * (19 + 48 * V) + C * 16) * 4
            + (P * C * 8 + N * C * k) * 4)
