"""Fit temperature scaling on saved prediction dumps (port of the repository's
``tools/calibrate.py``).

Reads the ``eval_prediction_saving`` contract: ``*_predictions.npy``, per-head
logits (S, E, C) or reduced (S, C), and ``*_labels.npy``. Fits the
NLL-optimal temperature on the validation dump, reports ECE and NLL before
and after (on the test dump when given: fit on val, report on test), and
prints the T to serve with (``predict --temperature``) as one JSON object::

    python -m multimodal_uncertainty_tpu_torch.tools.calibrate \\
        --val_predictions results/run/model_best_val_predictions.npy \\
        --val_labels results/run/model_best_val_labels.npy \\
        [--test_predictions ... --test_labels ...] [--reliability_csv out.csv] [--n_bins 15]

numpy only: it runs anywhere, no card needed.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np

from multimodal_uncertainty_tpu_torch.analysis.calibration import calibration_report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m multimodal_uncertainty_tpu_torch.tools.calibrate")
    ap.add_argument("--val_predictions", required=True, help="(S, E, C) or (S, C) logits .npy")
    ap.add_argument("--val_labels", required=True)
    ap.add_argument("--test_predictions", default=None)
    ap.add_argument("--test_labels", default=None)
    ap.add_argument("--n_bins", type=int, default=15)
    ap.add_argument("--reliability_csv", default=None,
                    help="write the reliability curve at the recommended serving temperature "
                         "(the fitted T only when the guard accepts it)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.test_predictions is None) != (args.test_labels is None):
        ap.error("--test_predictions and --test_labels go together")

    test_logits = np.load(args.test_predictions) if args.test_predictions else None
    test_labels = np.load(args.test_labels) if args.test_labels else None
    rep = calibration_report(np.load(args.val_predictions), np.load(args.val_labels),
                             test_logits, test_labels, n_bins=args.n_bins)
    curve = rep.pop("reliability_after")
    if args.reliability_csv:
        rows = np.column_stack([curve["bin_edges"][:-1], curve["bin_edges"][1:],
                                curve["confidence"], curve["accuracy"], curve["count"]])
        np.savetxt(args.reliability_csv, rows, delimiter=",",
                   header="bin_lo,bin_hi,confidence,accuracy,count", comments="")
    rep["eval_split"] = "test" if test_logits is not None else "val"
    # the guarded recommendation, not the raw fit: the NLL-optimal T can worsen max-prob ECE
    rep["serve_with"] = (f"python -m multimodal_uncertainty_tpu_torch.predict --temperature "
                         f"{rep['recommended_temperature']:.4f}")
    if rep["guard"] is not None:
        print(f"WARNING: fitted T={rep['temperature']:.4f} rejected: {rep['guard']}",
              file=sys.stderr)
    print(json.dumps(rep, indent=2))
    return rep


if __name__ == "__main__":
    main()
