"""FashionMNIST per-head prediction dumps of a trained checkpoint of this
package.

The port of the repo-root ``eval_prediction_saving.py``: the same flags as
``eval_robustness``, the same ``{ckpt}_predictions.npy`` (S, M, C) float32
and ``{ckpt}_labels.npy`` (S,) files (``evals/prediction_saving.py``), and
the same summary lines. It runs on the card; pass ``--device cpu`` to run on
the CPU::

    python -m multimodal_uncertainty_tpu_torch.eval_prediction_saving \\
        --checkpoint_path results/fmnist/model_best_val.pt \\
        --model_type MIMO-shuffle-instance --save_path results/fmnist
"""
from __future__ import annotations


def main(argv=None):
    from multimodal_uncertainty_tpu_torch.eval_robustness import build_parser, load_eval
    from multimodal_uncertainty_tpu_torch.evals.prediction_saving import save_predictions

    args, model, valid, ckpt_name = load_eval(
        build_parser("python -m multimodal_uncertainty_tpu_torch.eval_prediction_saving"), argv)
    outputs, labels = save_predictions(model, valid, model_type=args.model_type,
                                       save_path=args.save_path, checkpoint_name=ckpt_name)
    s, m, c = outputs.shape
    print(f"Gathered predictions of {s} samples, {m} views, {c} classes")
    print(f"Gathered labels of {len(labels)} samples")
    return outputs, labels


if __name__ == "__main__":
    main()
