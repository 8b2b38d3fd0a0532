"""Drop-in compatibility shim for the reference's Python module.

The reference installs a pybind11 extension named ``mi_fieldcalc``
binding the ``ValuesDefined`` enum and 15 functions
(python/py_mi_fieldcalc.cc:179-208).  This module lets that code run
unchanged against this build::

    import mi_fieldcalc                       # this shim
    out = mi_fieldcalc.abshum(t, rhum, undef) # same signature/layout

Everything re-exports from :mod:`mi_fieldcalc_tpu.api`, which keeps the
binding's exact call signatures — including its ``shape(0) -> nx``
transposed-axes convention (py_mi_fieldcalc.cc:88) — and additionally
exposes the full ~70-function C++ surface the reference never bound
(docs/MIGRATION.md).
"""

from mi_fieldcalc_tpu.api import *            # noqa: F401,F403
from mi_fieldcalc_tpu.api import __all__      # noqa: F401
from mi_fieldcalc_tpu import __version__      # noqa: F401
