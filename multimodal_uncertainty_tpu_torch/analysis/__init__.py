"""Offline analysis of the sweeps' artifacts (port of the JAX package's
``analysis/``, numpy and pandas only). Ported: the robustness tables and the
helpers they use, the FashionMNIST round's ``round1`` and temperature
scaling (``calibration``). Not ported yet: the plotting helpers of
``utils``."""
from multimodal_uncertainty_tpu_torch.analysis.robustness_tables import (  # noqa: F401
    acc_table,
    auc_table,
    ece_table,
    ensemble_overtime,
    epoch_wise_analysis,
    process_predictions_food101,
    process_predictions_hatefulmeme,
)
from multimodal_uncertainty_tpu_torch.analysis.round1 import (  # noqa: F401
    accuracy_breakdown,
    head_diversity,
    kendall_tau,
    missing_view_accuracy,
    subnetwork_kendalltau,
    trunk_pred_top,
)
from multimodal_uncertainty_tpu_torch.analysis.utils import (  # noqa: F401
    get_correlation,
    load_robustness_experiment_results,
)
