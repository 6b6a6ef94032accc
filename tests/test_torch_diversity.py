"""``--diversity guided|random`` in the port against the JAX package's
``ops/diversity.py`` and its train step, on the CPU.

The same numpy logits and labels go to both packages; the ``random`` kind's
noise is JAX's draw, injected (``noise=``). The train steps start from the
same weights (``models/jax_import.py``) on the same batch, with
``MultiHead`` data forming (no permutation to inject).

Tolerances: the diversity terms within 1e-6 (the same fp32 math); a train
step's loss and gradients within 1e-5 x max(1, max|ref|) (fp32 sums in
another order), the key biases (true gradient 0) aside.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.models.fusion import FlavaFusionTransformer as JaxFusion
from multimodal_uncertainty_tpu.models.mimo_transformer import MIMOTransformer as JaxTransformer
from multimodal_uncertainty_tpu.ops import data_forming as jax_forming
from multimodal_uncertainty_tpu.ops import diversity as jax_div
from multimodal_uncertainty_tpu_torch import train as port_train
from multimodal_uncertainty_tpu_torch import train_fashionmnist
from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
from multimodal_uncertainty_tpu_torch.models.jax_import import (
    fusion_state_dict_from_jax,
    mimo_transformer_state_dict_from_jax,
)
from multimodal_uncertainty_tpu_torch.models.mimo_transformer import MIMOTransformer
from multimodal_uncertainty_tpu_torch.ops import data_forming, diversity, losses
from multimodal_uncertainty_tpu_torch.training import optim
from multimodal_uncertainty_tpu_torch.training.loop import load_history
from multimodal_uncertainty_tpu_torch.training.steps import ModelBundle, train_step
from multimodal_uncertainty_tpu_torch.zoo import setup_fashionmnist, setup_flava


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test processes share a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _logits(b=6, e=3, c=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, e, c)) * 2).astype(np.float32), rng.integers(0, c, size=(b, e))


@pytest.mark.parametrize("per_head", [False, True])
def test_muted_probs_match_jax(per_head):
    logits, y = _logits()
    y = y if per_head else y[:, 0]
    got = diversity.muted_probs(_t(logits), _t(y))
    want = jax_div.muted_probs(jnp.asarray(logits), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert float(got[np.arange(6), :, y if not per_head else y[:, 0]].abs().max()) == 0.0


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_guided_penalty_matches_jax(heads):
    logits, y = _logits(e=heads, seed=heads)
    got = diversity.guided_diversity_penalty(_t(logits), _t(y))
    want = jax_div.guided_diversity_penalty(jnp.asarray(logits), jnp.asarray(y))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == pytest.approx(float(want), abs=1e-6)


@pytest.mark.parametrize("kind,coef", [("none", 0.3), ("guided", 0.0), ("guided", 0.3),
                                       ("random", 0.3)])
def test_apply_diversity_matches_jax_with_its_noise(kind, coef):
    logits, y = _logits(seed=7)
    key = jax.random.key(5)
    p = jax_div.muted_probs(jnp.asarray(logits), jnp.asarray(y))
    noise = np.asarray(jax.random.normal(key, p.shape, p.dtype))
    loss = np.float32(1.25)
    want = jax_div.apply_diversity(jnp.asarray(loss), jnp.asarray(logits), jnp.asarray(y), key,
                                   kind=kind, coef=coef)
    got = diversity.apply_diversity(torch.tensor(loss), _t(logits), _t(y), kind=kind, coef=coef,
                                    noise=_t(noise))
    assert float(got) == pytest.approx(float(want), abs=1e-6)
    if kind != "none" and coef:
        assert float(got) != float(loss)
    with pytest.raises(ValueError, match="unknown diversity kind"):
        diversity.apply_diversity(torch.tensor(loss), _t(logits), _t(y), kind="directed", coef=1.0)
    assert diversity.DIVERSITY_KINDS == jax_div.DIVERSITY_KINDS


def test_random_kind_draws_its_noise_from_the_generator():
    logits, y = _logits(seed=3)
    runs = [diversity.apply_diversity(torch.tensor(0.0), _t(logits), _t(y),
                                      torch.Generator().manual_seed(s), kind="random", coef=1.0)
            for s in (1, 1, 2)]
    assert float(runs[0]) == float(runs[1]) != float(runs[2])


# ---------------------------------------------------------------- train steps


def _jax_grads(model, params, x, y, kind, coef, jax_forming_fn):
    """The JAX step's loss and gradients (``training/steps.py:57-76``): its
    key split, data forming, apply and diversity term."""
    key = jax.random.key(17)
    k_form, k_drop, k_div = jax.random.split(key, 3)
    x, y = jax_forming_fn(k_form, x, y)

    def loss_fn(p):
        logits = model.apply({"params": p}, x, train=True, rngs={"dropout": k_drop})
        loss = model.compute_loss(logits, y)
        return jax_div.apply_diversity(loss, logits, y, k_div, kind=kind, coef=coef)

    return jax.jit(jax.value_and_grad(loss_fn))(params)


def _port_step(model, x, y, forming, kind, coef, loss_fn):
    bundle = ModelBundle(model=model, loss_fn=loss_fn, data_forming=forming,
                         diversity_kind=kind, diversity_coef=coef)
    opt = optim.AdamW(model.named_parameters(), optim.constant_schedule(1e-3))
    logs = train_step(bundle, opt, x, y, torch.Generator().manual_seed(0))
    return float(logs["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()}


def _assert_grads(got, want, skip="attn.in_proj.bias"):
    assert set(got) == set(want)
    for name, g in got.items():
        g, ref = g.numpy(), want[name].numpy()
        if name.endswith(skip):
            d = ref.shape[0] // 3
            g, ref = np.delete(g, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        np.testing.assert_allclose(g, ref, atol=1e-5 * max(1.0, float(np.abs(ref).max())),
                                   rtol=0, err_msg=name)


FUSION = dict(out_dim=2, num_classes=3, image_hidden_size=16, text_hidden_size=16,
              multimodal_hidden_size=64, multimodal_num_attention_heads=2,
              multimodal_num_hidden_layers=1)


def test_flava_guided_train_step_matches_the_jax_step():
    """One MultiHead fusion step with ``guided`` at 0.5: the port's
    ``train_step`` loss and gradients against the JAX step's, and the term
    is in the loss (it differs from the step without it)."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=(4, 6, 16)).astype(np.float32)
    txt = rng.normal(size=(4, 5, 16)).astype(np.float32)
    y = rng.integers(0, 3, size=4)
    jmodel = JaxFusion(**FUSION, attn_impl="xla")
    init = jax.jit(functools.partial(jmodel.init, train=False))
    params = init({"params": jax.random.key(1)}, (jnp.asarray(img), jnp.asarray(txt)))["params"]
    ref_loss, ref_grads = _jax_grads(
        jmodel, params, (jnp.asarray(img), jnp.asarray(txt)), jnp.asarray(y), "guided", 0.5,
        lambda k, x, y: jax_forming.data_forming_func_transformer(k, x, y, phase="train",
                                                                  model_type="MultiHead"))
    weights = fusion_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))

    def forming(gen, x, y, phase):
        return data_forming.data_forming_func_transformer(x, y, phase=phase,
                                                          model_type="MultiHead")

    runs = {}
    for coef in (0.5, 0.0):
        model = FlavaFusionTransformer(**FUSION)
        model.load_state_dict(weights)
        runs[coef] = _port_step(model, (_t(img), _t(txt)), _t(y), forming, "guided", coef,
                                losses.mimo_cross_entropy)
    loss, grads = runs[0.5]
    assert loss == pytest.approx(float(ref_loss), rel=1e-5)
    assert loss != runs[0.0][0]
    _assert_grads(grads, fusion_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                           ref_grads)))


def test_fashionmnist_transformer_guided_train_step_matches_the_jax_step():
    """One MultiHead step of the MIMO transformer (64 wide, 1 layer, 2 heads,
    4 heads of the ensemble) with ``guided`` at 0.5, against the JAX step."""
    tf = dict(out_dim=4, num_classes=10, hidden_size=64, multimodal_num_hidden_layers=1,
              multimodal_num_attention_heads=2)
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (4, 4, 1, 14, 14)).astype(np.float32)
    y = rng.integers(0, 10, size=4)
    jmodel = JaxTransformer(**tf, attn_impl="xla")
    init = jax.jit(functools.partial(jmodel.init, train=False))
    params = init({"params": jax.random.key(2)}, jnp.asarray(x))["params"]
    ref_loss, ref_grads = _jax_grads(
        jmodel, params, jnp.asarray(x), jnp.asarray(y), "guided", 0.5,
        lambda k, x, y: jax_forming.data_forming_func(k, x, y, phase="train",
                                                      model_type="MultiHead"))
    model = MIMOTransformer(**tf)
    model.load_state_dict(mimo_transformer_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    loss, grads = _port_step(
        model, _t(x), _t(y),
        lambda gen, x, y, phase: data_forming.data_forming_func(x, y, phase=phase,
                                                                model_type="MultiHead"),
        "guided", 0.5, model.compute_loss)
    assert loss == pytest.approx(float(ref_loss), rel=1e-5)
    _assert_grads(grads, mimo_transformer_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, ref_grads)))


def test_diversity_draws_leave_the_permutations_and_dropout_seeds_alone():
    """The step's generator yields the same MIMO permutations with
    ``random`` diversity on or off: the noise has a generator of its own (the
    JAX step's k_div), so the step's generator ends in the same state."""
    states = []
    for kind in ("random", "none"):
        ts = setup_flava(model_type="MIMO-shuffle-instance", n_classes=3,
                         multimodal_num_hidden_layers=1, image_hidden_size=8,
                         text_hidden_size=8, diversity=kind, diversity_coef=0.5, device="cpu")
        gen = torch.Generator().manual_seed(3)
        x = (torch.randn(4, 5, 8, generator=torch.Generator().manual_seed(0)),
             torch.randn(4, 3, 8, generator=torch.Generator().manual_seed(1)))
        train_step(ts.bundle, ts.optimizer, x, torch.tensor([0, 1, 2, 0]), gen)
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])


# ---------------------------------------------------------------- setups and CLIs


def test_setups_carry_the_diversity_settings():
    ts = setup_flava(multimodal_num_hidden_layers=1, diversity="random", diversity_coef=0.2,
                     device="cpu")
    assert (ts.bundle.diversity_kind, ts.bundle.diversity_coef) == ("random", 0.2)
    tf = setup_fashionmnist(model_type="MultiHead", diversity="guided", diversity_coef=0.3,
                            device="cpu")
    assert (tf.bundle.diversity_kind, tf.bundle.diversity_coef) == ("guided", 0.3)
    assert setup_flava(multimodal_num_hidden_layers=1, device="cpu").bundle.diversity_kind == "none"


@pytest.mark.parametrize("kind", ["guided", "random"])
def test_fashionmnist_cli_trains_with_diversity(kind, tmp_path, monkeypatch):
    """``train_fashionmnist --diversity`` (rejected before this slice) trains
    the MIMO ResNet one epoch with the term at ``--diversity_coef``: a finite
    history row, and a loss that differs from the run without the term."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    argv = ["--device", "cpu", "--synthetic", "--sample_size", "32", "--batch_size", "16",
            "--model_type", "MultiHead", "--n_epochs", "2", "--lr", "0.05"]
    train_fashionmnist.main(argv + ["--save_path", str(tmp_path / kind), "--diversity", kind,
                                    "--diversity_coef", "5"])
    train_fashionmnist.main(argv + ["--save_path", str(tmp_path / "none")])
    with_term, without = load_history(str(tmp_path / kind)), load_history(str(tmp_path / "none"))
    assert with_term["epoch"] == [1] and np.isfinite(with_term["loss"]).all()
    assert with_term["loss"] != without["loss"]


def test_train_cli_reads_diversity_for_flava_only(tmp_path, monkeypatch, caplog):
    """``--diversity`` and ``--diversity_coef`` reach FLAVA's bundle; MMBT and
    ViLT take the flag and ignore it with a warning (the root CLI passes it to
    FLAVA only)."""
    import multimodal_uncertainty_tpu_torch.data.flava_encoded as FE

    monkeypatch.setenv("DATA_DIR", str(tmp_path))
    monkeypatch.setattr(FE, "get_dataset_flava", lambda args, path: ([0], [0], [0]))
    args = port_train.add_conditional_args(port_train.build_parser().parse_args(
        ["--framework", "flava", "--save_path", str(tmp_path / "f"), "--device", "cpu",
         "--diversity", "guided", "--diversity_coef", "0.4", "--multimodal_num_hidden_layers",
         "1"]))
    _, _, _, setup = port_train._flava_setup(args, torch.device("cpu"))
    assert (setup.bundle.diversity_kind, setup.bundle.diversity_coef) == ("guided", 0.4)
    with caplog.at_level("WARNING"):
        port_train._warn_flava_only_diversity(port_train.build_parser().parse_args(
            ["--framework", "mmbt", "--save_path", "x", "--diversity", "random"]))
    assert any("--diversity random ignored for --framework mmbt" in r.getMessage()
               for r in caplog.records)
