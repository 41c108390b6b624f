"""Station QA: the non-spatial and spatial checks of the observations and
the location checks (numpy on the host)."""

from topotpu_torch.qa.qa_temp import run_qa_non_spatial, run_qa_spatial  # noqa: F401
from topotpu_torch.qa.qa_location import check_coordinates, check_elevation  # noqa: F401
