"""lanczos_tpu: a Krylov-subspace framework in JAX.

Brand-new JAX/XLA implementation of the capabilities of the header-only
C++ library mrcdr/lambda-lanczos (see SURVEY.md): extremal eigenpairs of
symmetric/Hermitian operators via Lanczos with full reorthogonalization and
deflated restarts, and Krylov matrix exponentiation exp(a*A) v — driven by a
pluggable matrix-vector product that scales over device meshes.
"""

from .api import LambdaLanczos, Exponentiator
from .ops.operators import (
    LinearOperator,
    DenseDFOperator,
    DenseOperator,
    COOOperator,
    CSROperator,
    BSROperator,
    DIAOperator,
    SumOperator,
    ScaledOperator,
    ShiftInvertOperator,
    FunctionOperator,
    as_operator,
)
from .ops.filters import ChebyshevFilterOperator
from .solvers.filtered import filtered_lanczos
from .solvers.lanczos import EigenPairManager, LanczosConfig
from .solvers.minres import minres
from .solvers.exponentiator import ExponentiatorConfig
from .parallel import mesh
from .diagnostics import (
    LanczosWarning,
    BudgetExhaustedWarning,
    BandCoverageWarning,
    MissedCopyWarning,
    AccuracyWarning,
    OverflowGuardWarning,
)
from .scipy_compat import eigsh, expm_multiply
from .utils.compile_cache import enable_compilation_cache

__all__ = [
    "LambdaLanczos",
    "Exponentiator",
    "LinearOperator",
    "DenseDFOperator",
    "DenseOperator",
    "COOOperator",
    "CSROperator",
    "BSROperator",
    "DIAOperator",
    "SumOperator",
    "ScaledOperator",
    "ShiftInvertOperator",
    "FunctionOperator",
    "as_operator",
    "EigenPairManager",
    "LanczosConfig",
    "ExponentiatorConfig",
    "minres",
    "ChebyshevFilterOperator",
    "filtered_lanczos",
    "mesh",
    "eigsh",
    "expm_multiply",
    "enable_compilation_cache",
    "LanczosWarning",
    "BudgetExhaustedWarning",
    "BandCoverageWarning",
    "MissedCopyWarning",
    "AccuracyWarning",
    "OverflowGuardWarning",
]

__version__ = "0.1.0"
