"""Operations and bytes of one launch of ``scatter_daily_packed_kernel``
(the daily contraction, + normal, reconcile and int16 packing of a tile
step): a frozen copy of ``chip_smoke.py``'s count, changed to count the
days the calendar has (not the padded 12 x dpm slots) and not to count the
output buffer as an input.

Shape: C cells, k neighbours, S pool stations, V variables, ndays days,
dpm day slots a month, N neighbourhoods, G gain rows."""


def flops(C: int, k: int, S: int, V: int, ndays: int, dpm: int = 31, N: int = 1,
          G: int = 1) -> float:
    """A multiply and an add a neighbour, a cell, a variable and a day."""
    return 2.0 * k * C * V * ndays


def nbytes(C: int, k: int, S: int, V: int, ndays: int, dpm: int = 31, N: int = 1,
           G: int = 1) -> float:
    """Inputs read once: idx (int64), mask (bool), gains (G, N, C, k), the
    station anomalies (V, S, 12 dpm), normals (V, 12, C) float32, ok (bool),
    slot_of_day (int32), scales; output: V ndays C int16."""
    return (N * C * k * (8 + 1) + G * N * C * k * 4 + V * S * 12 * dpm * 4 + V * 12 * C * (4 + 1)
            + ndays * 4 + V * 2 * 4 + V * ndays * C * 2)
