"""Evaluation sweeps producing the reference's .npy artifacts (port of the
JAX package's ``evals/``): the FLAVA-fusion and the MMBT robustness sweeps,
the FashionMNIST missing-view sweep and the per-head prediction dumps."""
from multimodal_uncertainty_tpu_torch.evals.prediction_saving import (  # noqa: F401
    save_predictions,
)
from multimodal_uncertainty_tpu_torch.evals.robustness_fmnist import (  # noqa: F401
    missing_view_sweep,
)
from multimodal_uncertainty_tpu_torch.evals.robustness_mmbt import (  # noqa: F401
    build_mmbt_variant_masks,
    mmbt_robustness_sweep,
)
from multimodal_uncertainty_tpu_torch.evals.robustness_transformer import (  # noqa: F401
    build_variant_masks,
    input_sampling_masks,
    transformer_robustness_sweep,
)
