"""Progress reporting (the port's own copy of ``topotpu.utils``)."""

from topotpu_torch.utils.status import StatusCheck  # noqa: F401
