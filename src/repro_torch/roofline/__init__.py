"""Roofline analysis of the port's traced steps on the H100 (the port of
`repro/roofline/`): `analysis` counts a step, `memory` models a rank's
memory, `report` writes the dry run's tables."""

from repro_torch.roofline.analysis import (  # noqa: F401
    HW,
    count_params,
    count_step,
    model_flops,
    roofline_terms,
)
