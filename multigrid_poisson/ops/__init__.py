"""Numerical operations: jnp oracle implementations and padded-layout ops."""

from .stencils import (  # noqa: F401
    add_correction,
    interior_color_masks,
    jacobi_sweep,
    mean_abs_error,
    mean_abs_interior_residual,
    redblack_gs_sweep,
    relative_residual_norm,
    residual,
    smooth,
    smoothing_error,
)
from .zoom import prolongate, restrict_residual, zoom  # noqa: F401
from .coarse import dense_solve, exact_solve, gauss_seidel_solve  # noqa: F401
