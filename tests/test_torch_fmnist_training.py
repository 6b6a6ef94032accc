"""The FashionMNIST round's training setup, trainer and CLIs in the port, on
the CPU: ``setup_fashionmnist`` against the JAX package's (its plateau
schedulers on val_loss and val_acc, ``size_fn``, the optimizers' settings),
the trainer's ``size_fn`` and ``scheduler_metric``, and the three CLIs end to
end (``train_fashionmnist`` with the ``n_epochs - 1`` quirk and ``--resume``,
``eval_robustness``, ``eval_prediction_saving``).

Tolerances: the schedules and plateau decisions exactly; an eval loop on the
same weights within 1e-5 of the JAX trainer's (fp32 sums in another order); a
resumed run's epoch equal to the uninterrupted run's to 1e-6 relative (the
same CPU kernels in the same order; the data order is stateless by epoch).
"""
import os

import jax
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.data.fmnist import get_fmnist as jax_get_fmnist
from multimodal_uncertainty_tpu.training.optim import warmup_linear_schedule
from multimodal_uncertainty_tpu.training.trainer import Trainer as JaxTrainer
from multimodal_uncertainty_tpu.zoo import setup_fashionmnist as jax_setup
from multimodal_uncertainty_tpu_torch import eval_prediction_saving, eval_robustness
from multimodal_uncertainty_tpu_torch import train_fashionmnist
from multimodal_uncertainty_tpu_torch.data.fmnist import get_fmnist
from multimodal_uncertainty_tpu_torch.models.jax_import import mimo_resnet_state_dict_from_jax
from multimodal_uncertainty_tpu_torch.training import optim
from multimodal_uncertainty_tpu_torch.training.callbacks import LambdaCallback
from multimodal_uncertainty_tpu_torch.training.loop import load_history
from multimodal_uncertainty_tpu_torch.training.trainer import Trainer
from multimodal_uncertainty_tpu_torch.zoo import setup_fashionmnist


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the test run puts several processes on
    a few cores at once, and torch's CPU convolutions spinning on every core
    from each of them slow to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("transformer,model_type", [
    (False, "MIMO-shuffle-instance"), (False, "single-model-weight-sharing"),
    (True, "MultiHead"), (True, "MIMO-shuffle-instance"),
])
def test_setup_matches_jax_plateau_metric_optimizer_and_size_fn(transformer, model_type):
    """The plateau scheduler's settings and the metric it reads (ResNet:
    val_loss, mode min, factor 0.1, patience ``lr_patience``, threshold
    1e-4; transformer: val_acc, mode max, factor 0.5, patience 10), the
    optimizer (SGD at a constant rate, or BertAdam's warmup-linear schedule
    over ``total_steps``), and ``size_fn`` (weight-sharing counts 4 views a
    sample) equal the JAX setup's."""
    kw = dict(model_type=model_type, transformer=transformer, lr=0.05, warmup=0.2,
              total_steps=40, lr_patience=3, multimodal_num_hidden_layers=1)
    js = jax_setup(**kw, seed_key=jax.random.key(0), attn_impl="xla")
    ts = setup_fashionmnist(**kw, device="cpu")
    assert ts.scheduler_metric == js.scheduler_metric
    for field in ("mode", "factor", "patience", "threshold", "threshold_mode", "cooldown"):
        assert getattr(ts.plateau, field) == getattr(js.plateau, field), field
    assert ts.plateau.patience == (10 if transformer else 3)
    x, y = np.zeros((5, 4, 1, 14, 14), np.float32), np.zeros(5, np.int64)
    port_size = (ts.size_fn or (lambda x, y: len(y)))(torch.from_numpy(x), torch.from_numpy(y))
    assert port_size == js.size_fn(x, y) == (20 if model_type.startswith("single") else 5)
    if transformer:
        assert isinstance(ts.optimizer, optim.BertAdam)
        for step in (0, 3, 8, 39, 45):  # BertAdam's warmup_linear over total_steps
            ref = float(warmup_linear_schedule(0.05, 0.2, 40.0)(jax.numpy.asarray(step)))
            assert ts.schedule(step) == pytest.approx(ref, rel=1e-6, abs=1e-12)
    else:
        assert isinstance(ts.optimizer, optim.SGD)
        assert (ts.optimizer.momentum, ts.optimizer.weight_decay) == (0.9, 0.001)
        assert ts.schedule(0) == ts.schedule(1000) == pytest.approx(0.05)
    with pytest.raises(ValueError):
        setup_fashionmnist(model_type="MIMO-shuffle-view", transformer=True, device="cpu")


class _Spy(optim.ReduceLROnPlateau):
    def step(self, metric):
        self.seen = getattr(self, "seen", []) + [metric]
        return super().step(metric)


@pytest.mark.parametrize("model_type", ["MIMO-shuffle-instance", "single-model-weight-sharing"])
def test_trainer_steps_the_plateau_on_the_setups_metric_and_weighs_by_size_fn(
        model_type, tmp_path):
    """Two epochs of the ResNet: the plateau reads history's val_loss (not
    val_acc) and its scale reaches the optimizer; every batch's weight is
    ``size_fn(x, y)`` on the batch as loaded."""
    ts = setup_fashionmnist(model_type=model_type, lr=0.05, lr_patience=0, device="cpu")
    spy = _Spy(mode="min", factor=0.1, patience=0, threshold=1e-4)
    sizes = []

    def size_fn(x, y):
        sizes.append((tuple(x.shape), (ts.size_fn or (lambda x, y: len(y)))(x, y)))
        return sizes[-1][1]

    train, valid, _ = get_fmnist(str(tmp_path), batch_size=16, synthetic=True, synthetic_n=48,
                                 seed=1)
    H = {}
    trainer = Trainer(ts.bundle, ts.optimizer, seed=1, verbose=False, plateau=spy,
                      size_fn=size_fn)
    trainer.train_loop(train, valid_generator=valid, epochs=2,
                       scheduler_metric=ts.scheduler_metric,
                       callbacks=[LambdaCallback(on_epoch_end=lambda e, logs: H.update(
                           {e: dict(logs)}))])
    assert spy.seen == [H[1]["val_loss"], H[2]["val_loss"]]
    assert ts.optimizer.lr_scale == spy.scale
    assert all(shape[1:] == (4, 1, 14, 14) for shape, _ in sizes)  # as loaded, before forming
    want = 4 if model_type.startswith("single") else 1
    assert all(n == want * shape[0] for shape, n in sizes)


@pytest.mark.parametrize("model_type", ["MIMO-shuffle-instance", "single-model-weight-sharing"])
def test_eval_loop_matches_the_jax_trainer(model_type, tmp_path):
    """The same weights and batches through both trainers' eval loops (the
    weight-sharing views folded into the batch at eval, its size_fn): val_loss
    and val_acc within 1e-5."""
    js = jax_setup(model_type=model_type, seed_key=jax.random.key(2), attn_impl="xla")
    ts = setup_fashionmnist(model_type=model_type, device="cpu")
    variables = jax.tree_util.tree_map(np.asarray, {"params": js.state.params,
                                                    "batch_stats": js.state.batch_stats})
    ts.model.load_state_dict(mimo_resnet_state_dict_from_jax(variables), strict=True)
    kw = dict(datapath=str(tmp_path), batch_size=10, synthetic=True, synthetic_n=100, seed=3)
    ref = JaxTrainer(js.bundle, js.optimizer, js.state, rng=jax.random.key(0),
                     size_fn=js.size_fn, verbose=False).eval_loop(jax_get_fmnist(**kw)[1], "val")
    got = Trainer(ts.bundle, ts.optimizer, seed=0, verbose=False,
                  size_fn=ts.size_fn).eval_loop(get_fmnist(**kw)[1], "val")
    assert got["val_loss"] == pytest.approx(ref["val_loss"], abs=1e-5)
    assert got["val_acc"] == pytest.approx(ref["val_acc"], abs=1e-5)


def _train(tmp_path, run, *extra):
    return train_fashionmnist.main(["--device", "cpu", "--save_path", str(tmp_path / run),
                                    "--synthetic", "--sample_size", "64", "--batch_size", "16",
                                    *extra])


def test_train_cli_quirk_checkpoints_and_resume_equal_an_uninterrupted_run(tmp_path, monkeypatch):
    """``--n_epochs 3`` trains 2 epochs (the reference's n_epochs - 1); the
    checkpoints exist; ``--resume --n_epochs 4`` from it trains epoch 3 only,
    and its history row equals that of an uninterrupted ``--n_epochs 4`` run
    (weights, BatchNorm statistics, SGD momentum and the plateau's state all
    restored; the data order is stateless by epoch)."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    args = ("--model_type", "MIMO-shuffle-instance", "--keep_epoch_ckpts", "1", "--ece")
    _train(tmp_path, "split", *args, "--n_epochs", "3")
    hist = load_history(str(tmp_path / "split"))
    assert hist["epoch"] == [1, 2] and all(np.isfinite(hist["loss"])) and "val_ece" in hist
    files = set(os.listdir(tmp_path / "split"))
    assert {"history.csv", "model_best_val.pt", "model_last_epoch.pt", "model_epoch_2.pt"} <= files
    assert "model_epoch_1.pt" not in files  # --keep_epoch_ckpts 1
    trainer = _train(tmp_path, "split", *args, "--n_epochs", "4", "--resume")
    _train(tmp_path, "whole", *args, "--n_epochs", "4")
    split, whole = load_history(str(tmp_path / "split")), load_history(str(tmp_path / "whole"))
    assert split["epoch"] == whole["epoch"] == [1, 2, 3]
    for key in ("loss", "acc", "val_loss", "val_acc", "test_loss", "test_acc", "val_ece"):
        np.testing.assert_allclose(split[key], whole[key], rtol=1e-6, err_msg=key)
    assert trainer.optimizer.step == 3 * 4  # 64 samples at batch 16, three epochs


def test_transformer_train_and_eval_clis_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The MIMO transformer (1 layer, 3 heads) trains one epoch through the
    CLI; both eval CLIs read its best checkpoint and write their files:
    (4, S, 4, 10) and (S, 4, 10) float32, S = the synthetic t10k's 128 rows,
    with the reference's summary lines."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    tf = ("--transformer", "--multimodal_num_hidden_layers", "1", "--model_type",
          "MIMO-shuffle-instance")
    _train(tmp_path, "tf", *tf, "--n_epochs", "2", "--lr", "1e-4")
    ckpt = str(tmp_path / "tf" / "model_best_val.pt")
    argv = ["--device", "cpu", "--checkpoint_path", ckpt, "--save_path", str(tmp_path / "ev"),
            "--synthetic", "--batch_size", "48", *tf]
    sweep, labels = eval_robustness.main(argv)
    out = capsys.readouterr().out
    assert "Gathered predictions of 128 samples, 4 views, 4 dups, 10 classes" in out
    dump, dump_labels = eval_prediction_saving.main(argv)
    out = capsys.readouterr().out
    assert "Gathered predictions of 128 samples, 4 views, 10 classes" in out
    assert np.load(tmp_path / "ev" / "model_best_val_predictions_robustness.npy").shape == (
        4, 128, 4, 10)
    saved = np.load(tmp_path / "ev" / "model_best_val_predictions.npy")
    assert saved.shape == (128, 4, 10) and saved.dtype == np.float32
    np.testing.assert_array_equal(np.load(tmp_path / "ev" / "model_best_val_labels.npy"),
                                  dump_labels)
    np.testing.assert_array_equal(labels, dump_labels)


def test_weight_sharing_eval_clis_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    ws = ("--model_type", "single-model-weight-sharing")
    _train(tmp_path, "ws", *ws, "--n_epochs", "2")
    argv = ["--device", "cpu", "--checkpoint_path", str(tmp_path / "ws" / "model_best_val.pt"),
            "--save_path", str(tmp_path / "ev"), "--synthetic", *ws]
    sweep, labels = eval_robustness.main(argv)
    assert sweep.shape == (4, 128, 3, 10) and labels.shape == (3 * 128,)
    dump, dump_labels = eval_prediction_saving.main(argv)
    assert dump.shape == (128, 4, 10) and dump_labels.shape == (128,)
    np.testing.assert_array_equal(labels, np.repeat(dump_labels, 3))


@pytest.mark.parametrize("cli,flags,message", [
    (train_fashionmnist, ["--attn_impl", "pallas"], "attention implementations"),
    (train_fashionmnist, ["--transformer", "--model_type", "Vanilla"], "--transformer takes"),
    (eval_robustness, ["--checkpoint_path", "c", "--data_parallel", "2"], "mesh sweeps"),
    (eval_prediction_saving, ["--checkpoint_path", "c", "--data_parallel", "2"], "mesh sweeps"),
])
def test_clis_reject_what_is_not_ported(cli, flags, message, tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--save_path", str(tmp_path), *flags])
    assert message in capsys.readouterr().err


def test_clis_default_to_the_card_and_take_the_vestigial_flags(tmp_path):
    """Without ``--device`` the CLIs ask for ``cuda`` (and raise here, where
    there is none); ``--use_gpu`` and ``--verbose`` are taken and ignored."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_fashionmnist.main(["--save_path", str(tmp_path), "--use_gpu", "--verbose"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_robustness.main(["--save_path", str(tmp_path), "--checkpoint_path", "c",
                              "--use_gpu", "--verbose"])
