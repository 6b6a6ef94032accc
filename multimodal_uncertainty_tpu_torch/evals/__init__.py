"""Evaluation sweeps producing the reference's .npy artifacts (port of the
JAX package's ``evals/``). Ported: the FLAVA-fusion and the MMBT robustness
sweeps. Not ported yet: the FashionMNIST sweeps (``robustness_fmnist``,
``prediction_saving``)."""
from multimodal_uncertainty_tpu_torch.evals.robustness_mmbt import (  # noqa: F401
    build_mmbt_variant_masks,
    mmbt_robustness_sweep,
)
from multimodal_uncertainty_tpu_torch.evals.robustness_transformer import (  # noqa: F401
    build_variant_masks,
    input_sampling_masks,
    transformer_robustness_sweep,
)
