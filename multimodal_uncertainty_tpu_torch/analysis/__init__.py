"""Offline analysis of the sweeps' artifacts (port of the JAX package's
``analysis/``, numpy and pandas only). Ported: the robustness tables and the
helpers they use. Not ported yet: ``round1``, ``calibration`` and the
plotting helpers of ``utils``."""
from multimodal_uncertainty_tpu_torch.analysis.robustness_tables import (  # noqa: F401
    acc_table,
    auc_table,
    ece_table,
    ensemble_overtime,
    epoch_wise_analysis,
    process_predictions_food101,
    process_predictions_hatefulmeme,
)
from multimodal_uncertainty_tpu_torch.analysis.utils import (  # noqa: F401
    get_correlation,
    load_robustness_experiment_results,
)
