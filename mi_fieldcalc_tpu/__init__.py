"""mi_fieldcalc_tpu — accelerator-native meteorological field-calculation
engine.

A from-scratch JAX/XLA/Pallas re-design of MET Norway's mi-fieldcalc
(metno/mi-fieldcalc): the full derived
-field operator suite over batched 2-D/3-D lat-lon grids, with the
reference's missing-value sentinel + tri-state definedness flag replaced by
mask lanes fused into every kernel, and multi-device scaling via
``jax.sharding`` domain decomposition with halo exchange.

Public surface:

* :mod:`mi_fieldcalc_tpu.field` — the Field pytree (values + mask) and
  sentinel codecs,
* :mod:`mi_fieldcalc_tpu.constants` — physical constants, saturation-vapor
  table, ICAO atmosphere,
* :mod:`mi_fieldcalc_tpu.ops` — the ~70 derived-field operators,
* :mod:`mi_fieldcalc_tpu.parallel` — mesh / halo-exchange machinery,
* :mod:`mi_fieldcalc_tpu.models` — fused multi-op pipelines,
* :mod:`mi_fieldcalc_tpu.api` — drop-in NumPy compatibility layer matching
  the reference's pybind11 module and C++ signatures.
"""

__version__ = "0.1.0"

from .field import (  # noqa: F401
    UNDEF, Field, ValuesDefined, combine_defined, defined_counts, defined_state,
    from_sentinel, from_values, full_undef,
)
from .layout import (  # noqa: F401
    padded_shape, padded_shape_sharded, pad_field, pad_array, trim_field,
    trim_array,
)
from .ingest import (  # noqa: F401
    aligned_target, resample_align, resample_maps,
)
from . import constants  # noqa: F401
from . import ops  # noqa: F401
from . import parallel  # noqa: F401
from . import models  # noqa: F401
from . import api  # noqa: F401
