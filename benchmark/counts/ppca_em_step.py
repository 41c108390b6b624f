"""Operations and bytes of one trip of the PPCA EM loop (``stats/ppca.py``:
one ``_em_step`` and the frozen-element bookkeeping inside a
``ppca.em_step`` range) at the shape of its ``ppca.impute`` key: B targets,
T days, V series a target (itself and its predictors), q components. A
trip's work does not depend on the data: frozen targets are computed and
discarded.

An add, multiply, division or root counts as one operation; the q x q
inverse as 2 q^3 and the solve for the new loadings as 2 q^3 / 3 + 2 V q^2.
"""


def flops(B: int, T: int, V: int, q: int) -> float:
    """float32 operations. Per target and day: Xc = X - c (V); Z = Xc W Minv
    (2 V q + 2 q^2); Sxz = Xc^T Z (2 V q); Szz = Z^T Z (2 q^2); low = Z Wn^T
    (2 V q); the mean of Xc - low (2 V); recon = low + c (V); sigma^2's mean
    square of X - recon (3 V); the stop test's mean squares of Xn - X (3 V)
    and of Xn (2 V). Per target: M = W^T W + sigma^2 I (2 V q^2 + q), its
    inverse, Szz's T sigma^2 Minv (2 q^2), the solve, c's update (V)."""
    per_day = 8 * V * q + 4 * q * q + 12 * V
    per_target = 2 * V * q * q + q + 2 * q ** 3 + 2 * q * q + 2 * q ** 3 / 3 + 2 * V * q * q + V
    return B * (T * per_day + per_target)


def nbytes(B: int, T: int, V: int, q: int) -> float:
    """Inputs read once and outputs written once: the state X and the
    centred observations Yc (float32) and the mask (bool), (B, T, V) each,
    read, and X written; per target the loadings (V, q), c (V), sigma^2 and
    the stop test's delta (float32) and the iteration count (int32) read and
    written, and the active flag (bool) read and written."""
    return B * T * V * (4 + 4 + 1 + 4) + B * (2 * 4 * (V * q + V + 3) + 2)
