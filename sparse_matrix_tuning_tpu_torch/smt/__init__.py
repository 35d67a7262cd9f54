from sparse_matrix_tuning_tpu_torch.smt.select import (  # noqa: F401
    block_stats,
    select_submatrices,
)
from sparse_matrix_tuning_tpu_torch.smt.plan import SMTPlan, LinearPlan  # noqa: F401
