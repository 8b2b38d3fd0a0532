"""Fused multi-operator pipelines — the framework's "model" layer.

The reference library only exposes single operators; production consumers
(MET Norway's Diana / fimex stacks) chain them per level on the CPU.  On
an accelerator the win is fusing whole derived-field *pipelines* into one
jitted program over a 3-D ``[nlev, ny, nx]`` stack, so the elementwise
chains fuse into the stencil reads instead of round-tripping device
memory per op.
"""

from .pipeline import (  # noqa: F401
    DerivedFields, DerivedFieldsStacked, derived_fields,
    derived_fields_stacked, derived_fields_plevel, derived_fields_isobaric, STANDARD_PLEVELS,
)
from .ensemble import (  # noqa: F401
    EnsembleSummary, ensemble_derived_summary,
)
