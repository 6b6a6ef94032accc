"""The port's training slice against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; weights
cross over through ``fusion_state_dict_from_jax``; the MIMO permutations that
the JAX step draws from its key are injected into the port's data forming.
The JAX side runs its XLA attention on the CPU.

Tolerances: 1e-6 for the losses, metrics and optimizer (the same fp32 math);
1e-5 for five training steps of the fusion model (fp32 matmuls summed in
another order, then through AdamW).
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_uncertainty_tpu.data import flava_encoded as jax_flava
from multimodal_uncertainty_tpu.data import loaders as jax_loaders
from multimodal_uncertainty_tpu.models.fusion import FlavaFusionTransformer as JaxFusion
from multimodal_uncertainty_tpu.ops import data_forming as jax_forming
from multimodal_uncertainty_tpu.ops import losses as jax_losses
from multimodal_uncertainty_tpu.ops import metrics as jax_metrics
from multimodal_uncertainty_tpu.training import optim as jax_optim
from multimodal_uncertainty_tpu.training.loop import construct_default_callbacks as jax_callbacks
from multimodal_uncertainty_tpu.training.steps import build_train_step
from multimodal_uncertainty_tpu.training.trainer import Trainer as JaxTrainer
from multimodal_uncertainty_tpu.zoo import setup_flava as jax_setup_flava
from multimodal_uncertainty_tpu_torch import train as port_train
from multimodal_uncertainty_tpu_torch.data import flava_encoded as port_flava
from multimodal_uncertainty_tpu_torch.data import loaders as port_loaders
from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
from multimodal_uncertainty_tpu_torch.models.jax_import import (
    adamw_state_from_jax,
    fusion_state_dict_from_jax,
)
from multimodal_uncertainty_tpu_torch.ops import data_forming, losses, metrics
from multimodal_uncertainty_tpu_torch.training import optim
from multimodal_uncertainty_tpu_torch.training.loop import (
    construct_default_callbacks,
    load_history,
    resume_train_state,
)
from multimodal_uncertainty_tpu_torch.training.steps import to_device, train_step
from multimodal_uncertainty_tpu_torch.training.trainer import Trainer
from multimodal_uncertainty_tpu_torch.zoo import setup_flava


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- losses, metrics


@pytest.mark.parametrize("eval_", [False, True])
def test_mimo_cross_entropy_matches_jax(eval_):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 2, 5)).astype(np.float32) * 3
    y = rng.integers(0, 5, size=(6,) if eval_ else (6, 2))
    ref = jax_losses.mimo_cross_entropy(jnp.asarray(logits), jnp.asarray(y), eval=eval_)
    got = losses.mimo_cross_entropy(_t(logits), _t(y), eval=eval_)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("eval_", [False, True])
def test_accuracy_matches_jax(eval_):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(7, 2, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=(7,) if eval_ else (7, 2))
    ref = jax_metrics.accuracy(jnp.asarray(logits), jnp.asarray(y), eval=eval_)
    got = metrics.accuracy(_t(logits), _t(y), eval=eval_)
    assert float(got) == pytest.approx(float(ref), abs=1e-5)


def test_host_metrics_match_jax():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 2, size=50)
    scores = np.round(rng.random(50), 1)  # ties
    assert metrics.binary_auroc(labels, scores) == jax_metrics.binary_auroc(labels, scores)
    logits = rng.normal(size=(50, 4)) * 2
    np.testing.assert_array_equal(metrics.softmax_np(logits), jax_metrics.softmax_np(logits))
    probs = metrics.softmax_np(logits)
    y = rng.integers(0, 4, size=50)
    assert (metrics.expected_calibration_error(probs, y)
            == jax_metrics.expected_calibration_error(probs, y))
    with pytest.raises(ValueError, match="both classes"):
        metrics.binary_auroc(np.zeros(3), np.ones(3))


# ---------------------------------------------------------------- data forming


def _jax_perms(key, b):
    """The two permutations ``data_forming_func_transformer`` draws from key."""
    k1, k2 = jax.random.split(key)
    return np.asarray(jax.random.permutation(k1, b)), np.asarray(jax.random.permutation(k2, b))


@pytest.mark.parametrize("model_type", ["Vanilla", "MultiHead", "MIMO-shuffle-instance"])
@pytest.mark.parametrize("phase", ["train", "eval"])
def test_data_forming_matches_jax_with_injected_perms(model_type, phase):
    rng = np.random.default_rng(3)
    img = rng.normal(size=(6, 4, 3)).astype(np.float32)
    txt = rng.normal(size=(6, 5, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=6)
    key = jax.random.key(11)
    (ji, jt), jy = jax_forming.data_forming_func_transformer(
        key, (jnp.asarray(img), jnp.asarray(txt)), jnp.asarray(y), phase=phase,
        model_type=model_type)
    (ti, tt), ty = data_forming.data_forming_func_transformer(
        (_t(img), _t(txt)), _t(y), phase=phase, model_type=model_type,
        perms=_jax_perms(key, 6))
    for got, want in ((ti, ji), (tt, jt), (ty, jy)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_data_forming_draws_from_the_generator():
    img = torch.arange(8.0)[:, None, None].expand(8, 2, 3)
    txt = torch.arange(8.0)[:, None, None].expand(8, 4, 3) + 100
    y = torch.arange(8)
    (i1, t1), y1 = data_forming.data_forming_func_transformer(
        (img, txt), y, phase="train", model_type="MIMO-shuffle-instance",
        generator=torch.Generator().manual_seed(5))
    (i2, _), y2 = data_forming.data_forming_func_transformer(
        (img, txt), y, phase="train", model_type="MIMO-shuffle-instance",
        generator=torch.Generator().manual_seed(5))
    assert torch.equal(i1, i2) and torch.equal(y1, y2)  # a function of the generator's seed
    assert torch.equal(y1[:, 0], i1[:, 0, 0].long()) and torch.equal(y1[:, 1], t1[:, 0, 0].long() - 100)
    assert sorted(y1[:, 0].tolist()) == list(range(8)) and not torch.equal(y1[:, 0], y1[:, 1])
    with pytest.raises(ValueError, match="generator or perms"):
        data_forming.data_forming_func_transformer((img, txt), y, phase="train",
                                                   model_type="MIMO-shuffle-instance")


# ---------------------------------------------------------------- optimizer

WIDTHS = dict(num_classes=3, image_hidden_size=16, text_hidden_size=24,
              multimodal_hidden_size=64, multimodal_num_attention_heads=2,
              multimodal_num_hidden_layers=1, out_dim=2)


def test_cosine_warmup_schedule_matches_jax():
    ref = jax_optim.cosine_warmup_schedule(3e-4, warmup_steps=7, total_steps=30)
    got = optim.cosine_warmup_schedule(3e-4, warmup_steps=7, total_steps=30)
    for step in range(0, 34):
        assert got(step) == pytest.approx(float(ref(jnp.asarray(step))), rel=1e-6, abs=1e-12)
    assert got(0) == 0.0


def test_adamw_with_cosine_schedule_matches_jax_and_state_converts():
    """Ten AdamW steps on the same params and grads: parameters and the
    optimizer state (through ``adamw_state_from_jax``) equal the JAX
    ``adamw``'s to 1e-6."""
    rng = np.random.default_rng(4)
    jmodel = JaxFusion(attn_impl="xla", **WIDTHS)
    sample = (np.zeros((2, 3, 16), np.float32), np.zeros((2, 2, 24), np.float32))
    params = jmodel.init({"params": jax.random.key(0)}, sample, train=False)["params"]
    schedule = jax_optim.cosine_warmup_schedule(1e-2, warmup_steps=3, total_steps=10)
    jopt = jax_optim.adamw(schedule, b1=0.9, b2=0.98, eps=1e-9, weight_decay=0.01)
    jstate = jopt.init(params)

    model = FlavaFusionTransformer(**WIDTHS)
    model.load_state_dict(fusion_state_dict_from_jax(params))
    opt = optim.AdamW(model.named_parameters(),
                      optim.cosine_warmup_schedule(1e-2, warmup_steps=3, total_steps=10),
                      b1=0.9, b2=0.98, eps=1e-9, weight_decay=0.01)
    for _ in range(10):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), params)
        updates, jstate = jopt.update(grads, jstate, params)
        params = jax.tree_util.tree_map(jnp.add, params, updates)
        tgrads = fusion_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
        for name, p in model.named_parameters():
            p.grad = tgrads[name]
        opt.update()
    want = fusion_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
    converted = adamw_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
    own = opt.state_dict()
    assert int(converted["step"]) == int(own["step"]) == 10
    assert float(converted["lr_scale"]) == float(own["lr_scale"]) == 1.0
    for key in ("mu", "nu"):
        for name, t in own[key].items():
            np.testing.assert_allclose(t.numpy(), converted[key][name].numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=f"{key} {name}")
    fresh = optim.AdamW(model.named_parameters(), lambda s: 0.0)
    fresh.load_state_dict(converted)  # the converted state loads into the port's optimizer
    assert fresh.step == 10


def test_adamw_lr_is_zero_at_step_zero_and_decays_every_parameter():
    p = torch.nn.Parameter(torch.ones(3))
    opt = optim.AdamW([("p", p)], optim.cosine_warmup_schedule(0.1, 2, 10), weight_decay=0.5)
    p.grad = torch.ones(3)
    opt.update()
    assert torch.equal(p.detach(), torch.ones(3)) and opt.step == 1  # lr(0) = 0
    p.grad = torch.zeros(3)
    opt.update()  # lr(1) = 0.05: the moment and the decay both move p
    assert bool((p.detach() < 1.0).all())
    with pytest.raises(ValueError, match="missing"):
        opt.load_state_dict({**opt.state_dict(), "mu": {}})


# ---------------------------------------------------------------- training parity

B, N_TRAIN, D_IN = 8, 40, 64


def _dataset(n, seed, *, d=D_IN, img_len=(5, 12), txt_len=(3, 9), n_classes=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(int(rng.integers(*img_len)), d)).astype(np.float32),
             rng.normal(size=(int(rng.integers(*txt_len)), d)).astype(np.float32),
             int(rng.integers(0, n_classes))) for _ in range(n)]


def _setups(model_type="MIMO-shuffle-instance", steps_per_epoch=5, layers=2, lr=1e-3):
    kw = dict(model_type=model_type, n_classes=3, lr=lr, n_epochs=2,
              steps_per_epoch=steps_per_epoch, multimodal_num_attention_heads=2,
              multimodal_num_hidden_layers=layers, image_hidden_size=D_IN,
              text_hidden_size=D_IN)
    js = jax_setup_flava(**kw, sample_shapes=((B, 32), (B, 32)), seed_key=jax.random.key(0),
                         attn_impl="xla")
    ts = setup_flava(**kw, seed=0, device="cpu")
    ts.model.load_state_dict(fusion_state_dict_from_jax(jax.device_get(js.state.params)))
    return js, ts


def test_five_training_steps_match_jax():
    """setup_flava in both packages from the same weights, on the same
    MapLoader batches with the permutations the JAX step drew: per-step
    losses within 1e-5 relative, parameters within 1e-5 after five steps."""
    data = _dataset(N_TRAIN, 5)
    jloader = jax_loaders.MapLoader(data, B, jax_flava.collate_fn_flava, shuffle=True, seed=3)
    tloader = port_loaders.MapLoader(data, B, port_flava.collate_fn_flava, shuffle=True, seed=3)
    js, ts = _setups()
    jstep = build_train_step(js.bundle, js.optimizer, donate=False)
    rng = jax.random.key(9)
    perms = []
    bundle = dataclasses.replace(
        ts.bundle,
        data_forming=lambda gen, x, y, phase: data_forming.data_forming_func_transformer(
            x, y, phase=phase, model_type="MIMO-shuffle-instance", perms=perms[-1]),
    )
    state = js.state
    for i, (jb, tb) in enumerate(zip(jloader.iter_epoch(1), tloader.iter_epoch(1)), start=1):
        (ji, jt), jy = jb
        (ti, tt), ty = tb
        np.testing.assert_array_equal(ji, ti)  # identical batches
        np.testing.assert_array_equal(jt, tt)
        np.testing.assert_array_equal(jy, ty)
        key = jax.random.fold_in(jax.random.fold_in(rng, 1), i)
        perms.append(_jax_perms(jax.random.split(key, 3)[0], B))
        state, jlogs = jstep(state, (jnp.asarray(ji), jnp.asarray(jt)), jnp.asarray(jy), key)
        x, y = to_device(tb, "cpu")
        tlogs = train_step(bundle, ts.optimizer, x, y)
        np.testing.assert_allclose(float(tlogs["loss"]), float(jlogs["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
        assert float(tlogs["acc"]) == pytest.approx(float(jlogs["acc"]), abs=1e-4)
    assert i == 5 and ts.step == 5
    want = fusion_state_dict_from_jax(jax.device_get(state.params))
    noise_bound = 2 * sum(ts.schedule(t) for t in range(5))
    for name, p in ts.model.state_dict().items():
        got, ref = p.numpy(), want[name].numpy()
        if name.endswith("attn.in_proj.bias"):
            # The key bias's true gradient is exactly 0 (a constant added to
            # every key shifts each softmax row by a constant), so each
            # package hands AdamW its own fp32 rounding noise there, which
            # AdamW normalises into steps of up to lr_t: bounded by
            # 2 * sum(lr_t), not by the rounding of the math.
            d = got.shape[0] // 3
            assert np.abs(got[d:2 * d] - ref[d:2 * d]).max() <= noise_bound, name
            got, ref = np.delete(got, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=name)


# ---------------------------------------------------------------- trainer, CLI


def _write_shards(root, n_train=24, n_eval=8, seed=6, n_classes=2):
    shard_dir = os.path.join(root, "flava_packed")
    os.makedirs(shard_dir, exist_ok=True)
    for k, (phase, n) in enumerate((("train", n_train), ("dev", n_eval), ("test", n_eval))):
        items = _dataset(n, seed + k, d=768, n_classes=n_classes)
        items[0] = (*items[0][:2], 0)  # both classes in every split (AUROC)
        items[1] = (*items[1][:2], 1)
        img_len = [len(i) for i, _, _ in items]
        txt_len = [len(t) for _, t, _ in items]
        np.save(os.path.join(shard_dir, f"{phase}_img.npy"), np.concatenate([i for i, _, _ in items]))
        np.save(os.path.join(shard_dir, f"{phase}_txt.npy"), np.concatenate([t for _, t, _ in items]))
        np.save(os.path.join(shard_dir, f"{phase}_img_offsets.npy"), np.cumsum([0] + img_len))
        np.save(os.path.join(shard_dir, f"{phase}_txt_offsets.npy"), np.cumsum([0] + txt_len))
        np.save(os.path.join(shard_dir, f"{phase}_labels.npy"), np.asarray([l for *_, l in items]))
    return shard_dir


def test_trainer_two_epochs_history_checkpoints_and_resume(tmp_path):
    """The port's Trainer for 2 epochs on tiny shards: history.csv has the JAX
    Trainer's columns, the checkpoint files exist, and a resume from
    model_last_epoch.pt reproduces the last val metrics."""
    import types

    datapath = str(tmp_path / "data")
    _write_shards(datapath)
    args = types.SimpleNamespace(batch_size=8, seed=1, sample_size=None, n_workers=0)
    train, valid, test = port_flava.get_dataset_flava(args, datapath)

    def port_setup():
        return setup_flava(model_type="MIMO-shuffle-instance", n_classes=2, lr=1e-4,
                           n_epochs=2, steps_per_epoch=len(train),
                           multimodal_num_hidden_layers=1, seed=2, device="cpu")

    out = tmp_path / "port"
    out.mkdir()
    H = {}
    setup = port_setup()
    trainer = Trainer(setup.bundle, setup.optimizer, seed=1, verbose=False)
    trainer.train_loop(train, valid_generator=valid, test_generator=test, epochs=2,
                       callbacks=construct_default_callbacks(H, str(out)), auc=True, ece=True)

    jout = tmp_path / "jax"
    jout.mkdir()
    jargs = types.SimpleNamespace(**vars(args), labels=[0, 1], error_cases_remover=False,
                                  name_extractor=None)
    jtrain, jvalid, jtest = jax_flava.get_dataset_flava(jargs, datapath)
    js = jax_setup_flava(model_type="MIMO-shuffle-instance", n_classes=2, lr=1e-4,
                         n_epochs=2, steps_per_epoch=len(jtrain),
                         multimodal_num_hidden_layers=1, seed_key=jax.random.key(2),
                         attn_impl="xla")
    JaxTrainer(js.bundle, js.optimizer, js.state, rng=jax.random.key(1), verbose=False
               ).train_loop(jtrain, valid_generator=jvalid, test_generator=jtest, epochs=2,
                            callbacks=jax_callbacks({}, str(jout)), scheduler_step_on="batch",
                            auc=True, ece=True)

    port_csv = pd.read_csv(out / "history.csv")
    assert list(port_csv.columns) == list(pd.read_csv(jout / "history.csv").columns)
    assert len(port_csv) == 2 and np.isfinite(port_csv["loss"]).all()
    for f in ("model_best_val.pt", "model_epoch_1.pt", "model_epoch_2.pt", "model_last_epoch.pt"):
        assert (out / f).exists(), f
    assert load_history(str(out))["epoch"] == [1, 2]

    fresh = port_setup()
    resume_train_state(fresh.model, fresh.optimizer, str(out / "model_last_epoch.pt"))
    assert fresh.step == setup.step == 2 * len(train)
    again = Trainer(fresh.bundle, fresh.optimizer, seed=1, verbose=False).eval_loop(valid, "val")
    assert again["val_loss"] == pytest.approx(H["val_loss"][-1], rel=1e-6)
    assert again["val_acc"] == pytest.approx(H["val_acc"][-1], abs=1e-6)
    for a, b in zip(fresh.optimizer.mu.values(), setup.optimizer.mu.values()):
        assert torch.equal(a, b)


def _cli(tmp_path, *extra):
    return ["--framework", "flava", "--save_path", str(tmp_path / "run"), "--batch_size", "8",
            "--lr", "1e-4", "--model_type", "MIMO-shuffle-instance",
            "--multimodal_num_hidden_layers", "1", *extra]


def test_train_cli_on_the_cpu_one_epoch_then_resume(tmp_path, monkeypatch):
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_shards(str(tmp_path / "data" / "hateful-meme-dataset"))
    port_train.main(_cli(tmp_path, "--device", "cpu", "--n_epochs", "1"))
    run = tmp_path / "run"
    assert load_history(str(run))["epoch"] == [1]
    assert {"history.csv", "model_best_val.pt", "model_epoch_1.pt",
            "model_last_epoch.pt"} <= set(os.listdir(run))
    port_train.main(_cli(tmp_path, "--device", "cpu", "--n_epochs", "2", "--resume",
                         "--keep_epoch_ckpts", "1"))
    hist = load_history(str(run))
    assert hist["epoch"] == [1, 2] and "val_auc" in hist
    assert "model_epoch_1.pt" not in os.listdir(run) and "model_epoch_2.pt" in os.listdir(run)


@pytest.mark.parametrize("flag", [
    ["--framework", "vilt", "--batch_decode"], ["--fast_decode"],
    ["--ckpt_backend", "orbax"], ["--data_parallel", "2"], ["--sequence_parallel", "2"],
    ["--pipeline_parallel", "2"], ["--num_processes", "2"], ["--transfer_quant", "int8"],
    ["--fsdp"],
])
def test_train_cli_rejects_what_is_not_ported(tmp_path, flag, capsys):
    argv = _cli(tmp_path, "--device", "cpu")
    if flag[0] == "--framework":
        argv = argv[2:]
    with pytest.raises(SystemExit):
        port_train.main(argv + flag)
    assert "ported to PyTorch yet" in capsys.readouterr().err


def test_train_cli_takes_bf16_and_builds_flava_in_bf16(tmp_path, monkeypatch):
    """``--bf16`` (rejected until the bf16 slice) sets FLAVA's compute dtype
    to bf16, as the root CLI's ``dtype=jnp.bfloat16``: fp32 parameters, bf16
    logits on a loader batch (``tests/test_torch_bf16.py`` trains it)."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_shards(str(tmp_path / "data" / "hateful-meme-dataset"))
    args = port_train.add_conditional_args(
        port_train.build_parser().parse_args(_cli(tmp_path, "--device", "cpu", "--bf16")))
    train, _, _, setup = port_train._flava_setup(args, torch.device("cpu"))
    assert setup.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in setup.model.parameters())
    (img, txt), _ = to_device(next(iter(train)), "cpu")
    with torch.inference_mode():
        assert setup.model.eval()((img, txt)).dtype == torch.bfloat16


class _Toy(torch.nn.Module):
    """(img, txt) -> (B, 2, 2) logits from the mean image token."""

    def __init__(self, scale=1.0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((3, 2), scale))

    def forward(self, x):
        return (x[0].mean(dim=1) @ self.w)[:, None, :].expand(-1, 2, -1)


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _toy_trainer(loss_fn, scale=1.0):
    from functools import partial

    from multimodal_uncertainty_tpu_torch.training.steps import ModelBundle

    model = _Toy(scale)
    bundle = ModelBundle(model=model, loss_fn=loss_fn,
                         data_forming=lambda g, x, y, phase: data_forming.
                         data_forming_func_transformer(x, y, phase=phase, model_type="MultiHead"),
                         metric_fns=(("acc", partial(metrics.accuracy, dummy_dim=True)),))
    opt = optim.AdamW(model.named_parameters(), lambda step: 1e-3)
    return Trainer(bundle, opt, seed=0, verbose=False)


def _toy_batches(n_batches=2, b=4):
    rng = np.random.default_rng(8)
    out = []
    for _ in range(n_batches):
        img = rng.normal(size=(b, 5, 3)).astype(np.float32)
        img[..., 0] = np.abs(img[..., 0]) + 1  # class 0 scores higher under w = scale
        out.append(((img, np.zeros((b, 2, 3), np.float32)), np.zeros(b, np.int64)))
    return _Loader(out)


def test_trainer_stops_on_nan_loss_and_weights_epochs_by_size():
    def nan_loss(logits, y, eval=False):
        return losses.mimo_cross_entropy(logits, y, eval=eval) * float("nan")

    H = {}
    from multimodal_uncertainty_tpu_torch.training.callbacks import LambdaCallback

    record = LambdaCallback(on_epoch_end=lambda e, logs: H.setdefault("epochs", []).append(e))
    _toy_trainer(nan_loss).train_loop(_toy_batches(), epochs=5, callbacks=[record])
    assert H["epochs"] == [1]  # the NaN epoch ends the run

    trainer = _toy_trainer(losses.mimo_cross_entropy)
    loader = _toy_batches()
    (img, txt), y = loader.batches[1]
    loader.batches[1] = ((img[:1], txt[:1]), y[:1])  # batch sizes 4 and 1
    per_batch = [trainer.eval_loop(_Loader([b]), "val")["val_loss"] for b in loader.batches]
    info = trainer.eval_loop(loader, "val")
    assert info["val_loss"] == pytest.approx((4 * per_batch[0] + per_batch[1]) / 5, rel=1e-6)


def test_trainer_patience_counts_epochs_at_100_percent_train_acc():
    epochs = []
    from multimodal_uncertainty_tpu_torch.training.callbacks import LambdaCallback

    record = LambdaCallback(on_epoch_end=lambda e, logs: epochs.append(logs["acc"]))
    _toy_trainer(losses.mimo_cross_entropy, scale=5.0).train_loop(
        _toy_batches(), epochs=10, patience=3, callbacks=[record])
    assert epochs == [100.0, 100.0, 100.0]  # stopped after `patience` such epochs


@pytest.mark.parametrize("flags", [
    ["--use_gpu"], ["--verbose"], ["--embed_sz", "300"], ["--hidden", "512", "256"],
    ["--hidden_sz", "768"], ["--img_hidden_sz", "2048"], ["--include_bn", "0"],
])
def test_train_cli_takes_and_ignores_the_vestigial_flags(tmp_path, monkeypatch, flags):
    """The root ``train.py`` keeps the reference's unused flags (:20-68); the
    port takes them too and changes nothing: the run gets past the parser
    and the device check to the data (here: no shards)."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path))
    args = port_train.build_parser().parse_args(_cli(tmp_path, "--device", "cpu", *flags))
    assert args.lr == 1e-4 and args.device == "cpu"
    with pytest.raises(FileNotFoundError, match="packed"):
        port_train.main(_cli(tmp_path, "--device", "cpu", *flags))


def test_train_cli_takes_diversity_coef_and_ignores_it_without_diversity(tmp_path, monkeypatch):
    """The root ``train.py`` takes ``--diversity_coef`` (float, default 0.1,
    :139) and its step reads it only under ``--diversity`` (``training/
    steps.py:70``). So does the port: without ``--diversity`` the run goes on
    to the data whatever the coefficient; with ``--diversity guided`` FLAVA's
    bundle carries both, and the step adds the term
    (``tests/test_torch_diversity.py``)."""
    import multimodal_uncertainty_tpu_torch.data.flava_encoded as FE

    monkeypatch.setenv("DATA_DIR", str(tmp_path))
    parser = port_train.build_parser()
    assert parser.parse_args(_cli(tmp_path)).diversity_coef == 0.1
    args = parser.parse_args(_cli(tmp_path, "--device", "cpu", "--diversity_coef", "0.3"))
    assert args.diversity_coef == 0.3 and args.diversity == "none"
    with pytest.raises(FileNotFoundError, match="packed"):
        port_train.main(_cli(tmp_path, "--device", "cpu", "--diversity_coef", "0.1"))
    monkeypatch.setattr(FE, "get_dataset_flava", lambda args, path: ([0], [0], [0]))
    for extra, want in (([], ("none", 0.3)), (["--diversity", "guided"], ("guided", 0.3))):
        args = port_train.add_conditional_args(parser.parse_args(
            _cli(tmp_path, "--device", "cpu", "--diversity_coef", "0.3", *extra)))
        _, _, _, setup = port_train._flava_setup(args, torch.device("cpu"))
        assert (setup.bundle.diversity_kind, setup.bundle.diversity_coef) == want


def test_train_cli_maps_an_integer_device_to_that_card(monkeypatch, tmp_path):
    """The root CLIs' ``--device`` is a GPU index: ``--device 0`` is cuda:0
    (it reached the card check, not torch's 'Invalid device string')."""
    from multimodal_uncertainty_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(_cli(tmp_path, "--device", "0"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("0") == torch.device("cuda:0")
    assert resolve_device(1) == torch.device("cuda:1")
    assert resolve_device("cuda:1") == torch.device("cuda:1")
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_cli_rejects_profile_epoch_as_profile_dir(tmp_path, monkeypatch):
    """``--profile_dir`` and ``--profile_epoch`` are taken (both rejected
    before this slice): a two-epoch run with ``--profile_epoch 2`` writes
    that epoch's trace under the directory and none of epoch 1; a
    ``--profile_epoch`` without ``--profile_dir`` traces nothing."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_shards(str(tmp_path / "data" / "hateful-meme-dataset"), n_train=16)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the profiler records every CPU op: keep the cores for others
    try:
        prof = tmp_path / "p"
        port_train.main(_cli(tmp_path, "--device", "cpu", "--n_epochs", "2", "--profile_dir",
                             str(prof), "--profile_epoch", "2"))
        assert os.listdir(prof) == ["epoch_2.pt.trace.json.gz"]
        port_train.main(_cli(tmp_path, "--device", "cpu", "--n_epochs", "1", "--profile_epoch",
                             "1"))
    finally:
        torch.set_num_threads(threads)
    assert os.listdir(prof) == ["epoch_2.pt.trace.json.gz"]
    assert "Epoch 1/1" in (tmp_path / "run" / "out.log").read_text()
    shutil.rmtree(tmp_path / "run")  # 768-wide checkpoints: keep the test's disk use small


def test_train_cli_ignores_compile_cache_and_says_so(tmp_path, monkeypatch, caplog):
    """``--compile_cache`` names an XLA compilation cache: taken, ignored,
    with one logged line."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path))
    with caplog.at_level("WARNING"), pytest.raises(FileNotFoundError, match="packed"):
        port_train.main(_cli(tmp_path, "--device", "cpu", "--compile_cache", "/x/cache"))
    assert any("--compile_cache /x/cache ignored" in r.getMessage() for r in caplog.records)
