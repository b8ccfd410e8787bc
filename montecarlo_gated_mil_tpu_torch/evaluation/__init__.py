"""Port of ``montecarlo_gated_mil_tpu.evaluation``."""

from montecarlo_gated_mil_tpu_torch.evaluation.report import (  # noqa: F401
    aggregate_classification_reports,
    aggregate_fold_accuracies,
    classification_report_dict,
    classification_report_text,
)
from montecarlo_gated_mil_tpu_torch.evaluation.dp_eval import mc_test_dp  # noqa: F401
