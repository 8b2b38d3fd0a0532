"""Operator suite: every derived-field calculation of the reference library
(mi-fieldcalc FieldCalculations.h:113-304), re-designed as fused, mask-aware
JAX programs over batched [..., ny, nx] grids."""

from .levels import (  # noqa: F401
    pleveltemp, plevelthe, plevelhum, pleveldz2tmean, plevelducting,
    hleveltemp, hlevelthe, hlevelhum, hlevelducting, hlevelpressure,
    aleveltemp, alevelthe, alevelhum, alevelducting, sea_sound_speed,
)
from .stability import (  # noqa: F401
    k_index, ducting_index, showalter_index, boyden_index, sweat_index,
)
from .stencil import (  # noqa: F401
    fill_edges, gradient, relvort, absvort, divergence, advection, jacobian,
    plevelgwind_xcomp, plevelgwind_ycomp, plevelgvort, ilevelgwind,
    plevelqvector, thermal_front_parameter, momentum_x_coordinate,
    momentum_y_coordinate, shapiro2_filter,
)
from .elementwise import (  # noqa: F401
    cvtemp, cvhum, abshum, vectorabs, wind_cooling, under_cooled_rain,
    pressure2flightlevel, values2classes, minvalue_fields, maxvalue_fields,
    minvalue_field_const, maxvalue_field_const, absvalue_field, log10_field,
    pow10_field, log_field, exp_field, power_field, replace_undefined,
    replace_defined, field_oper_field, field_oper_constant,
    constant_oper_field, snow_in_cm,
)
from .ensemble import (  # noqa: F401
    sum_fields, mean_value, stddev_value, extreme_value, probability,
)
from .window import (  # noqa: F401
    neighbour_prob_functions, neighbour_functions,
)
from .icing import (  # noqa: F401
    vessel_icing_overland, vessel_icing_mertins, vessel_icing_modstall,
    vessel_icing_mincog,
)
from .vertical import (  # noqa: F401
    plevel_interp, hlevel_to_plevel,
)
from .fused_suite import (  # noqa: F401
    alevel_suite_fused, hlevel_suite_fused,
)
