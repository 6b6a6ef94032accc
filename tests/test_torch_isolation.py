"""The port stands alone: no JAX, no flax, nothing of the JAX package; and
its entry points default to the card, raising when there is none."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "multimodal_uncertainty_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import multimodal_uncertainty_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "multimodal_uncertainty_tpu" or m.startswith("multimodal_uncertainty_tpu."))
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 39  # every module of the port was imported


_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+(jax|flax)\b", re.M),
    re.compile(r"\bmultimodal_uncertainty_tpu\."),
    re.compile(r"\bimport\s+multimodal_uncertainty_tpu\b(?!_)"),
]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")] + ["chip_smoke.py"]
))
def test_source_names_no_jax(path):
    text = (ROOT / path).read_text()
    for pat in _FORBIDDEN:
        assert not pat.search(text), f"{path}: {pat.pattern}"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
    from multimodal_uncertainty_tpu_torch.serving import FusionPredictor
    from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights
    from multimodal_uncertainty_tpu_torch import train
    from multimodal_uncertainty_tpu_torch.zoo import (
        build_flava,
        build_vilt,
        setup_flava,
        setup_mmbt,
        setup_vilt,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = FlavaFusionTransformer(multimodal_hidden_size=64, image_hidden_size=8,
                                   text_hidden_size=8, multimodal_num_attention_heads=1,
                                   multimodal_num_hidden_layers=1)
    ckpt = str(tmp_path / "model_best_val.pt")
    save_weights(model, None, ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusionPredictor(model, ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_flava("Vanilla", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_flava(multimodal_num_hidden_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--framework", "flava", "--save_path", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_mmbt(n_classes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--framework", "mmbt", "--dataset", "food101", "--tiny",
                    "--save_path", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_vilt(n_classes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_vilt(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--framework", "vilt", "--dataset", "food101", "--tiny", "--fast_dw",
                    "--save_path", str(tmp_path / "run")])
    FusionPredictor(model, ckpt, device="cpu")  # an explicit CPU request is honoured
    setup_flava(multimodal_num_hidden_layers=1, device="cpu")
    with pytest.raises(FileNotFoundError, match="packed"):  # past the device check
        monkeypatch.setenv("DATA_DIR", str(tmp_path))
        train.main(["--framework", "flava", "--save_path", str(tmp_path / "run"),
                    "--device", "cpu"])
