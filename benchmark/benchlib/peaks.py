"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W), the denominators of every roofline share; a frozen copy of
``chip_smoke.py``'s constants."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the float32
    operations at the peak rate, whichever is longer (``chip_smoke.py::bound``)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
