"""Device and dtype policy of the port.

* The device is always explicit: a caller names it, or a function follows
  the device of the tensors it is given. Nothing here falls back to the CPU
  when no GPU is found; ``cuda_device`` raises instead. The one other way to
  the CPU is ``TOPOTPU_PLATFORM=cpu``, which ``platform_devices`` reads for
  the entry points that take no device (the CLI, the engine's mesh).
* Compute is float32. Tests may run the plain paths in float64.
* TF32 is off for both matmuls and cuDNN. The WLS/kriging chain loses whole
  degrees at reduced matmul precision, and the daily contraction loses
  hundredths of a degree, so any plain torch product on the card must run
  at full float32. ``apply_precision_policy`` sets both flags; importing
  this module calls it once.
"""

from __future__ import annotations

import os

import torch

COMPUTE_DTYPE = torch.float32


def apply_precision_policy() -> None:
    """Full-fp32 matmuls and convolutions (no TF32) on CUDA."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when no CUDA device exists."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", index)


def platform_devices() -> list:
    """The devices a run takes where the caller names none: the CPU when
    ``TOPOTPU_PLATFORM=cpu`` is set, else every visible CUDA device (raises
    where there is none)."""
    if os.environ.get("TOPOTPU_PLATFORM") == "cpu":
        return [torch.device("cpu")]
    cuda_device()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


apply_precision_policy()
