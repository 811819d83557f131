"""The paper's coupled-STO reservoir physics, in PyTorch."""

from repro_torch.core.constants import (
    DT,
    STOParams,
    default_params,
    initial_magnetization,
)
from repro_torch.core.coupling import (
    coupling_field_x,
    make_coupling_matrix,
    make_input_matrix,
    spectral_radius,
)
from repro_torch.core.ensemble import broadcast_params
from repro_torch.core.integrators import (
    BS32,
    EULER,
    HEUN,
    RK4,
    TABLEAUX,
    convergence_order,
    integrate_adaptive,
    integrate_python_loop,
    integrate_scan,
    make_step,
)
from repro_torch.core.reservoir import (
    Readout,
    fit_lms,
    fit_ridge,
    fit_rls,
    nmse,
    predict,
)
from repro_torch.core.sto import (
    effective_field_b,
    llg_field,
    llg_rhs_from_b,
    norm_error,
)
