"""The port's bf16 training (``train --bf16``) against the JAX package's, on the CPU.

FLAVA fusion and MMBT run their activations in bf16 with fp32 parameters,
optimizer state, BatchNorm statistics and checkpoints, the LayerNorms and the
loss in fp32 inside, as the JAX package's ``dtype=jnp.bfloat16`` does. The
same numpy inputs and the same weights (through ``models/jax_import.py``) go
to both packages. The JAX side runs its XLA attention (one FLAVA case its
Pallas K1 in interpret mode); the port its plain attention (the CUDA kernels
run only on the card: ``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances, each stated again where it is used: bf16 outputs within a few
bf16 steps of the JAX package's (both round fp32 sums to bf16, in another
order); a bf16 training step's parameters and gradients within what the JAX
package's own bf16 run differs from its fp32 run by at these seeds, the
numbers given beside each bound; BatchNorm's fp32 statistics within 1e-6.
"""
import dataclasses
import functools
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu import zoo as jax_zoo
from multimodal_uncertainty_tpu.models import bert as JB
from multimodal_uncertainty_tpu.models.fusion import FlavaFusionTransformer as JaxFusion
from multimodal_uncertainty_tpu.models.layers import BatchNorm as JaxBatchNorm
from multimodal_uncertainty_tpu.models.layers import Linear as JaxLinear
from multimodal_uncertainty_tpu.ops import dw as jdw
from multimodal_uncertainty_tpu.ops import losses as jax_losses
from multimodal_uncertainty_tpu.training.state import TrainState
from multimodal_uncertainty_tpu.training.steps import build_train_step
from multimodal_uncertainty_tpu.zoo import setup_flava as jax_setup_flava
from multimodal_uncertainty_tpu.zoo import setup_mmbt as jax_setup_mmbt
from multimodal_uncertainty_tpu_torch import train as port_train
from multimodal_uncertainty_tpu_torch.data.images import write_ppm
from multimodal_uncertainty_tpu_torch.models import bert as TB
from multimodal_uncertainty_tpu_torch.models import transformer as TT
from multimodal_uncertainty_tpu_torch.models import vilt as TV
from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
from multimodal_uncertainty_tpu_torch.models.jax_import import (
    fusion_state_dict_from_jax,
    mmbt_state_dict_from_jax,
)
from multimodal_uncertainty_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    LayerNormFP32,
    Linear,
)
from multimodal_uncertainty_tpu_torch.ops import data_forming, losses
from multimodal_uncertainty_tpu_torch.ops import dw as DW
from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights
from multimodal_uncertainty_tpu_torch.training.loop import load_history
from multimodal_uncertainty_tpu_torch.training.steps import to_device, train_step
from multimodal_uncertainty_tpu_torch.zoo import setup_flava, setup_mmbt

BF16_STEP = 2.0 ** -7  # bf16's spacing at 1


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if isinstance(a, jax.Array) else (
        a.detach().float().numpy())


# ---------------------------------------------------------------- FLAVA fusion forward

WIDTHS = dict(num_classes=5, image_hidden_size=64, text_hidden_size=48,
              multimodal_hidden_size=256, multimodal_num_attention_heads=2,
              multimodal_num_hidden_layers=2)
CONFIGS = {"vanilla": dict(out_dim=1), "mimo": dict(out_dim=2),
           "cls_token": dict(out_dim=2, cls_token=True), "avg_pool": dict(out_dim=2, avg_pool=True)}


def _fusion_inputs(b=3, seed=1):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, 24, 64)).astype(np.float32)
    txt = rng.normal(size=(b, 16, 48)).astype(np.float32)
    txt_mask = np.arange(16)[None] < rng.integers(2, 17, size=b)[:, None]
    return img, txt, txt_mask


@pytest.mark.parametrize("config,attn_impl", [(c, "xla") for c in CONFIGS]
                         + [("mimo", "pallas_interpret")])
def test_fusion_bf16_logits_match_jax(config, attn_impl):
    """FlavaFusionTransformer(dtype=bf16) against the JAX module with
    ``dtype=jnp.bfloat16`` on the same weights and inputs (ragged text mask):
    bf16 logits within 2e-2 absolute (|logits| < 2, where a bf16 step is
    2^-7; both sum in fp32 and round to bf16 at other points). The ``mimo``
    case runs again through JAX's packed Pallas kernel K1 in interpret mode."""
    kw = {**WIDTHS, **CONFIGS[config]}
    img, txt, txt_mask = _fusion_inputs()
    jmodel = JaxFusion(attn_impl=attn_impl, dtype=jnp.bfloat16, **kw)
    variables = jmodel.init({"params": jax.random.key(7)}, (img, txt), train=False)
    ref = jmodel.apply(variables, (jnp.asarray(img), jnp.asarray(txt)), train=False,
                       txt_mask=jnp.asarray(txt_mask))
    model = FlavaFusionTransformer(dtype=torch.bfloat16, **kw).eval()
    model.load_state_dict(fusion_state_dict_from_jax(variables["params"]), strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.inference_mode():
        out = model((torch.from_numpy(img), torch.from_numpy(txt)),
                    txt_mask=torch.from_numpy(txt_mask))
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-2, rtol=0)


@pytest.mark.parametrize("heads", [1, 4, 8])
def test_fusion_bf16_logits_match_jax_k6_at_the_narrow_and_wide_head_dims(heads, monkeypatch):
    """The ``mimo`` fusion at ``multimodal_hidden_size=192`` with 1, 4 and 8
    heads (Dh 192, 48 and 24: the head dims the port runs on its own K6
    tensor-core sources at D=768 under ``--bf16``) against the JAX module with
    ``dtype=jnp.bfloat16`` and ``attn_impl="pallas_interpret"``, which runs
    these head dims on its heads-first kernel K6 (``_sdpa_pallas_fwd_impl``,
    in interpret mode; counted: one call a layer). bf16 logits within 2e-2
    absolute, as above."""
    from multimodal_uncertainty_tpu.ops import attention as JA

    calls = []
    real = JA._sdpa_pallas_fwd_impl

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(JA, "_sdpa_pallas_fwd_impl", counting)
    kw = {**WIDTHS, **CONFIGS["mimo"], "multimodal_hidden_size": 192,
          "multimodal_num_attention_heads": heads}
    img, txt, txt_mask = _fusion_inputs(seed=heads)
    jmodel = JaxFusion(attn_impl="pallas_interpret", dtype=jnp.bfloat16, **kw)
    variables = jmodel.init({"params": jax.random.key(heads)}, (img, txt), train=False)
    calls.clear()
    ref = jmodel.apply(variables, (jnp.asarray(img), jnp.asarray(txt)), train=False,
                       txt_mask=jnp.asarray(txt_mask))
    assert len(calls) == WIDTHS["multimodal_num_hidden_layers"]
    assert all(shape[1] == heads and shape[-1] == 192 // heads for shape in calls), calls
    model = FlavaFusionTransformer(dtype=torch.bfloat16, **kw).eval()
    model.load_state_dict(fusion_state_dict_from_jax(variables["params"]), strict=True)
    with torch.inference_mode():
        out = model((torch.from_numpy(img), torch.from_numpy(txt)),
                    txt_mask=torch.from_numpy(txt_mask))
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-2, rtol=0)


def test_fusion_bf16_logits_match_jax_k1_at_dh_384(monkeypatch):
    """The ``mimo`` fusion at ``multimodal_hidden_size=384`` with 1 head (Dh
    384: the head dim the port runs on ``csrc/attention_fwd_tc_384.cu`` under
    ``--bf16``, FLAVA at 2 heads of D=768) against the JAX module with
    ``dtype=jnp.bfloat16`` and ``attn_impl="pallas_interpret"``, which runs
    it on its packed kernel K1 (``_sdpa_packed_fwd_impl``) or, past its
    whole-sequence budget, the flash kernel K3 (``_sdpa_flash_fwd_impl``), in
    interpret mode; the calls are counted (one a layer, at head dim 384).
    bf16 logits within 2e-2 absolute, as above."""
    from multimodal_uncertainty_tpu.ops import attention as JA

    calls = []
    for name in ("_sdpa_packed_fwd_impl", "_sdpa_flash_fwd_impl"):
        real = getattr(JA, name)

        def counting(*args, _real=real, _name=name, **kwargs):
            calls.append((_name, args[0].shape))
            return _real(*args, **kwargs)

        monkeypatch.setattr(JA, name, counting)
    kw = {**WIDTHS, **CONFIGS["mimo"], "multimodal_hidden_size": 384,
          "multimodal_num_attention_heads": 1}
    img, txt, txt_mask = _fusion_inputs(seed=384)
    jmodel = JaxFusion(attn_impl="pallas_interpret", dtype=jnp.bfloat16, **kw)
    variables = jmodel.init({"params": jax.random.key(384)}, (img, txt), train=False)
    calls.clear()
    ref = jmodel.apply(variables, (jnp.asarray(img), jnp.asarray(txt)), train=False,
                       txt_mask=jnp.asarray(txt_mask))
    assert len(calls) == WIDTHS["multimodal_num_hidden_layers"], calls
    assert all(shape[-1] in (384, 3 * 384) for _, shape in calls), calls
    model = FlavaFusionTransformer(dtype=torch.bfloat16, **kw).eval()
    model.load_state_dict(fusion_state_dict_from_jax(variables["params"]), strict=True)
    with torch.inference_mode():
        out = model((torch.from_numpy(img), torch.from_numpy(txt)),
                    txt_mask=torch.from_numpy(txt_mask))
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-2, rtol=0)


# ---------------------------------------------------------------- MMBT attention dropout


def test_mmbt_bf16_attention_dropout_grads_match_jax_k5(monkeypatch):
    """BERT's attention with attention-probs dropout 0.1 in bf16 at MMBT's
    layout (B=4, 5 image tokens + 40 of text, 2 heads of Dh=64, MMBT's key
    masks, one sample keeping only the image segment): the port's forward and
    its plain dropout backward (``attention_bwd_dropout_plain``, which the
    tensor-core kernel of ``csrc/attention_bwd_tc.cu`` is held to on the
    card) against the JAX package's K5 in interpret mode
    (``_sdpa_pallas_hl_drop`` and its backward ``_sdpa_pallas_hl_drop_bwd``,
    whose kernel body is counted), handed the keep mask JAX drew from the
    same key. bf16 inputs and cotangent on both sides; both round Pd and dS
    to bf16 before their products and sum in fp32, in other orders: out
    within 2e-2 x max(1, max|ref|) (dropout scales it by 1 / (1 - rate)),
    dq, dk, dv within 3e-2 x max(1, max|ref|), the card's bf16 gates."""
    from multimodal_uncertainty_tpu.ops import attention as JA
    from multimodal_uncertainty_tpu_torch.ops import attention as TA

    b, n_img, length, n_head, rate = 4, 5, 40, 2, 0.1
    s, d = n_img + length, 2 * 64
    rng = np.random.default_rng(18)
    q, k, v, g = (rng.normal(size=(b, s, d)).astype(np.float32) for _ in range(4))
    mask = np.zeros((b, s), bool)
    mask[:, :n_img] = True
    mask[0, n_img:] = True
    mask[1, n_img:n_img + 17] = True
    mask[1, 1:n_img] = False
    mask[3, n_img:n_img + 7] = True  # row 2: the image segment only
    key = jax.random.key(18)
    calls = {"fwd": 0, "bwd_kernel": 0}
    real_drop, real_body = JA._sdpa_pallas_hl_drop, JA._attn_bwd_kernel_hl_drop

    def counting_drop(*a, **kw):
        calls["fwd"] += 1
        return real_drop(*a, **kw)

    def counting_body(*a, **kw):
        calls["bwd_kernel"] += 1
        return real_body(*a, **kw)

    monkeypatch.setattr(JA, "_sdpa_pallas_hl_drop", counting_drop)
    monkeypatch.setattr(JA, "_attn_bwd_kernel_hl_drop", counting_body)
    to_bf16 = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, g)]
    ref_out, vjp = jax.vjp(lambda a, b_, c: JA.attention_heads_last_dropout(
        a, b_, c, jnp.asarray(mask), n_head=n_head, rate=rate, rng=key,
        impl="pallas_interpret"), *to_bf16[:3])
    ref_grads = vjp(to_bf16[3])
    assert calls["fwd"] == 1 and calls["bwd_kernel"] >= 1, calls  # K5, both directions
    keep = torch.from_numpy(np.asarray(
        jax.random.bernoulli(key, 1.0 - rate, (b, n_head, s, s))).astype(np.uint8))
    ins = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    out = TA.attention_heads_last_dropout_keep(*ins, torch.from_numpy(mask), keep,
                                               n_head=n_head, rate=rate)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == torch.bfloat16 and ref_out.dtype == jnp.bfloat16
    want = _f32(ref_out)
    np.testing.assert_allclose(_f32(out), want, atol=2e-2 * max(1.0, np.abs(want).max()), rtol=0)
    for name, t, r in zip("qkv", ins, ref_grads):
        assert t.grad.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        want = _f32(r)
        np.testing.assert_allclose(_f32(t.grad), want, atol=3e-2 * max(1.0, np.abs(want).max()),
                                   rtol=0, err_msg=f"d{name}")


# ---------------------------------------------------------------- FLAVA training steps

B, D_IN = 8, 64


def _flava_batches(n, seed=5):
    """n collated batches of B samples: ragged image and text lengths padded
    as the FLAVA collate pads them (zero rows, lengths masked)."""
    from multimodal_uncertainty_tpu_torch.data.flava_encoded import collate_fn_flava

    rng = np.random.default_rng(seed)
    return [collate_fn_flava([(rng.normal(size=(int(rng.integers(5, 12)), D_IN)).astype(np.float32),
                               rng.normal(size=(int(rng.integers(3, 9)), D_IN)).astype(np.float32),
                               int(rng.integers(0, 3))) for _ in range(B)]) for _ in range(n)]


def _jax_perms(key, b):
    """The two permutations the JAX MIMO data forming draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return np.asarray(jax.random.permutation(k1, b)), np.asarray(jax.random.permutation(k2, b))


def test_three_adamw_steps_in_bf16_match_jax():
    """``setup_flava(dtype=bf16)`` in both packages from the same weights,
    three steps on the same batches with the permutations the JAX step drew.

    Losses within 2e-3 relative (the JAX package's own bf16 and fp32 losses
    differ by up to 1.3e-3 here). Parameters, AdamW's moments and every
    gradient stay fp32. After three steps every parameter element is within
    2 x the sum of the learning rates of JAX's (AdamW normalises each step,
    so an element whose bf16 gradient lies within rounding of 0 moves by up
    to lr either way; ROADMAP Queue 3's key-bias bound), and each leaf's
    update, outside the key biases (true gradient 0), is within 0.2 of the
    JAX update's norm (the JAX package's own bf16 and fp32 updates differ by
    up to 0.13 of it at this seed)."""
    kw = dict(model_type="MIMO-shuffle-instance", n_classes=3, lr=1e-3, n_epochs=2,
              steps_per_epoch=5, multimodal_num_attention_heads=2,
              multimodal_num_hidden_layers=2, image_hidden_size=D_IN, text_hidden_size=D_IN)
    js = jax_setup_flava(**kw, sample_shapes=((B, 32), (B, 32)), seed_key=jax.random.key(0),
                         attn_impl="xla", dtype=jnp.bfloat16)
    ts = setup_flava(**kw, seed=0, device="cpu", dtype=torch.bfloat16)
    ts.model.load_state_dict(fusion_state_dict_from_jax(jax.device_get(js.state.params)))
    init = {n: t.clone() for n, t in ts.model.state_dict().items()}
    jstep = build_train_step(js.bundle, js.optimizer, donate=False)
    perms = []
    bundle = dataclasses.replace(
        ts.bundle, data_forming=lambda gen, x, y, phase: data_forming.data_forming_func_transformer(
            x, y, phase=phase, model_type="MIMO-shuffle-instance", perms=perms[-1]))
    grad_dtypes = set()
    real_update = ts.optimizer.update

    def update(*args, **kwargs):
        grad_dtypes.update(p.grad.dtype for p in ts.model.parameters())
        return real_update(*args, **kwargs)

    ts.optimizer.update = update
    state = js.state
    for i, batch in enumerate(_flava_batches(3), start=1):
        (img, txt), y = batch
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(9), 1), i)
        perms.append(_jax_perms(jax.random.split(key, 3)[0], B))
        state, jlogs = jstep(state, (jnp.asarray(img), jnp.asarray(txt)), jnp.asarray(y), key)
        x, ty = to_device(batch, "cpu")
        tlogs = train_step(bundle, ts.optimizer, x, ty)
        np.testing.assert_allclose(float(tlogs["loss"]), float(jlogs["loss"]), rtol=2e-3,
                                   err_msg=f"loss at step {i}")
    assert grad_dtypes == {torch.float32}
    assert all(t.dtype == torch.float32 for t in (*ts.optimizer.mu.values(),
                                                  *ts.optimizer.nu.values()))
    want = fusion_state_dict_from_jax(jax.device_get(state.params))
    bound = 2 * sum(ts.schedule(t) for t in range(3))
    for name, p in ts.model.state_dict().items():
        assert p.dtype == torch.float32, name
        got, ref, start = p.numpy(), want[name].numpy(), init[name].numpy()
        assert np.abs(got - ref).max() <= bound, name
        if name.endswith("attn.in_proj.bias"):
            d = got.shape[0] // 3
            got, ref, start = (np.delete(a, np.s_[d:2 * d]) for a in (got, ref, start))
        moved = np.linalg.norm(ref - start)
        assert np.linalg.norm(got - ref) <= 0.2 * moved, name


# ---------------------------------------------------------------- MMBT

BERT = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=256, max_position_embeddings=128, hidden_dropout_prob=0.0)
N_CLASSES, RESNET, IMG = 5, (1, 1, 1, 1), 64
MMBT_KW = dict(n_classes=N_CLASSES, lr=5e-5, warmup=0.0, total_steps=10.0, resnet_layers=RESNET,
               dropout=0.0, gradient_accumulation_steps=2)


@functools.lru_cache(maxsize=None)
def _mmbt_variables(seed=0):
    """The JAX init of the tiny MMBT as numpy trees."""
    from multimodal_uncertainty_tpu.models.mmbt import MultimodalBertClf as JaxMMBT

    jmodel = JaxMMBT(config=JB.BertConfig(**BERT), n_classes=N_CLASSES, resnet_layers=RESNET,
                     dropout=0.0, attn_impl="xla")
    x = (jnp.zeros((2, 8), jnp.int32), jnp.ones((2, 8), jnp.int32), jnp.ones((2, 8), jnp.int32),
         jnp.zeros((2, IMG, IMG, 3), jnp.float32))
    variables = jax.jit(functools.partial(jmodel.init, train=False))(
        {"params": jax.random.key(seed)}, x)
    return {k: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
            for k, v in variables.items()}


def _mmbt_batch(seed=3, bsz=4, lt=24):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, lt + 1, size=bsz)
    mask = (np.arange(lt)[None] < lengths[:, None]).astype(np.int64)
    text = rng.integers(104, BERT["vocab_size"], size=(bsz, lt)) * mask
    imgs = rng.integers(0, 256, size=(bsz, IMG, IMG, 3), dtype=np.uint8)
    return (text, mask.copy(), mask, imgs), rng.integers(0, N_CLASSES, size=bsz)


def _jax_mmbt(monkeypatch, dtype):
    variables = _mmbt_variables()

    def init_state(model, optimizer, sample_x, key, *, accum):
        params, stats = (jax.tree_util.tree_map(jnp.asarray, variables[k])
                         for k in ("params", "batch_stats"))
        return TrainState(params=params, opt_state=optimizer.init(params), batch_stats=stats,
                          step=jnp.zeros((), jnp.int32),
                          accum_grads=jax.tree_util.tree_map(jnp.zeros_like, params))

    monkeypatch.setattr(jax_zoo, "_init_state", init_state)
    return jax_setup_mmbt(**MMBT_KW, bert_config=JB.BertConfig(**BERT), image_size=IMG,
                          seed_key=jax.random.key(0), attn_impl="xla", dtype=dtype)


def _port_mmbt(dtype=torch.bfloat16):
    ts = setup_mmbt(**MMBT_KW, bert_config=TB.BertConfig(**BERT), device="cpu", dtype=dtype)
    ts.model.load_state_dict(mmbt_state_dict_from_jax(_mmbt_variables()), strict=True)
    return ts


def _jax_micro_step(js, batch):
    """One JAX micro-step with both encoders live: (state after, loss)."""
    x, y = batch
    jstep = build_train_step(js.bundle, js.optimizer, gradient_accumulation_steps=2,
                             donate=False)
    state, logs = jstep(js.state, tuple(jnp.asarray(a) for a in x), jnp.asarray(y),
                        jax.random.key(1), jnp.asarray((False, False)))
    return state, float(logs["loss"])


def _port_names(tree) -> dict:
    return {n: t.numpy() for n, t in mmbt_state_dict_from_jax(
        {"params": jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)}).items()}


def test_mmbt_bf16_forward_matches_jax(monkeypatch):
    """The tiny MMBT (BERT 128 wide, ResNet (1, 1, 1, 1)) with ``dtype=bf16``
    in eval: bf16 logits within 2e-2 absolute of the JAX package's (|logits|
    < 0.5, where a bf16 step is 2^-9)."""
    js = _jax_mmbt(monkeypatch, jnp.bfloat16)
    ts = _port_mmbt()
    batch = _mmbt_batch()
    ref, _ = js.bundle.apply_fn({"params": js.state.params, "batch_stats": js.state.batch_stats},
                                tuple(jnp.asarray(a) for a in batch[0]), train=False, rngs={})
    x, _ = to_device(batch, "cpu")
    ts.model.eval()
    with torch.inference_mode():
        out = ts.bundle.apply_fn(ts.model, x, train=False)
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-2, rtol=0)


def test_mmbt_bf16_micro_step_gradients_match_jax(monkeypatch):
    """One micro-step of ``setup_mmbt(dtype=bf16)`` with accumulation 2,
    both encoders live, in both packages from the same weights: the loss
    within 2e-3 relative; the accumulated gradients (grad / 2) fp32, and
    every leaf outside the ResNet within 0.1 x its max |JAX gradient| (the
    worst here is 4.7e-2, and JAX's own bf16 gradients differ from its fp32
    ones by up to 4.2e-2 there); BERT's key biases (true gradient 0) within
    1e-4. The ResNet's gradient in bf16 is mostly rounding at this size (a
    BatchNorm over 16 values a channel in layer4): JAX's own bf16 gradient
    is 0.33 of the ResNet gradient's norm away from its fp32 one, so the
    port's is held to within 1.5 x that distance of JAX's, in norm, and so
    are its fp32 BatchNorm running statistics."""
    jb = _jax_mmbt(monkeypatch, jnp.bfloat16)
    jf = _jax_mmbt(monkeypatch, None)
    batch = _mmbt_batch()
    state_b, loss_b = _jax_micro_step(jb, batch)
    state_f, _ = _jax_micro_step(jf, batch)
    ts = _port_mmbt()
    x, y = to_device(batch, "cpu")
    logs = train_step(ts.bundle, ts.optimizer, x, y, torch.Generator().manual_seed(1),
                      flags=(False, False), accumulator=ts.accumulator)
    np.testing.assert_allclose(float(logs["loss"]), loss_b, rtol=2e-3)
    ref_b, ref_f = _port_names(state_b.accum_grads), _port_names(state_f.accum_grads)
    got = {n: t.numpy() for n, t in ts.accumulator.grads.items()}
    assert all(t.dtype == torch.float32 for t in ts.accumulator.grads.values())
    resnet = [n for n in got if n.startswith("enc.img_encoder.")]
    for name in set(got) - set(resnet):
        err = np.abs(got[name] - ref_b[name]).max()
        if name.endswith("attention.self.key.bias"):
            assert err <= 1e-4, name
        else:
            assert err <= 0.1 * np.abs(ref_b[name]).max(), name

    def dist(a, b, names):
        return float(np.sqrt(sum(((a[n] - b[n]) ** 2).sum() for n in names)))

    assert dist(got, ref_b, resnet) <= 1.5 * dist(ref_f, ref_b, resnet)
    sd = ts.model.state_dict()
    stats = {n: t.numpy() for n, t in mmbt_state_dict_from_jax(
        {"params": {}, "batch_stats": jax.tree_util.tree_map(np.asarray, state_b.batch_stats)}
    ).items() if not n.endswith("num_batches_tracked")}
    stats_f = {n: t.numpy() for n, t in mmbt_state_dict_from_jax(
        {"params": {}, "batch_stats": jax.tree_util.tree_map(np.asarray, state_f.batch_stats)}
    ).items() if not n.endswith("num_batches_tracked")}
    assert all(sd[n].dtype == torch.float32 and np.isfinite(sd[n].numpy()).all() for n in stats)
    port_stats = {n: sd[n].numpy() for n in stats}
    assert dist(port_stats, stats, list(stats)) <= 1.5 * dist(stats_f, stats, list(stats))


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm2d_bf16_matches_flax(train):
    """``BatchNorm2d`` on a bf16 input against flax's ``BatchNorm(dtype=bf16)``
    (the JAX package's ``layers.BatchNorm``): the bf16 output within one bf16
    step of the output's scale (both normalise in fp32 and round once); in
    training the running statistics stay fp32 and equal flax's within 1e-6
    (both from the input's fp32 values; flax takes E[x^2] - E[x]^2)."""
    x = (np.random.default_rng(2).normal(size=(4, 3, 3, 6)) * 2 + 1).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jbn = JaxBatchNorm(use_running_average=not train, dtype=jnp.bfloat16)
    variables = {"params": {"bn": {"scale": jnp.linspace(0.5, 1.5, 6),
                                   "bias": jnp.linspace(-0.2, 0.3, 6)}},
                 "batch_stats": {"bn": {"mean": jnp.linspace(-0.1, 0.2, 6),
                                        "var": jnp.linspace(0.9, 1.1, 6)}}}
    ref, mutated = jbn.apply(variables, xb, mutable=["batch_stats"])
    bn = BatchNorm2d(6)
    bn.load_state_dict(mmbt_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    bn.train(train)
    out = bn(torch.from_numpy(_f32(xb)).bfloat16().permute(0, 3, 1, 2))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = _f32(ref)
    np.testing.assert_allclose(_f32(out.permute(0, 2, 3, 1)), ref,
                               atol=BF16_STEP * max(1.0, np.abs(ref).max()), rtol=0)
    stats = mutated["batch_stats"]["bn"] if train else variables["batch_stats"]["bn"]
    for own, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        assert own.dtype == torch.float32
        np.testing.assert_allclose(own.numpy(), np.asarray(stats[key]), atol=1e-6, rtol=0)


def test_conv2d_runs_in_the_input_dtype():
    """``Conv2d`` keeps its fp32 weight and computes in a bf16 input's dtype
    (``F.conv2d`` refuses mixed operands), as flax's ``Conv(dtype=bf16)``:
    the output equals the convolution of the bf16-rounded weight, and the
    weight's gradient comes back fp32."""
    conv = Conv2d(3, 4, 3, 2, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 9, 9, generator=torch.Generator().manual_seed(1)).bfloat16()
    out = conv(x)
    assert out.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    ref = torch.nn.functional.conv2d(x, conv.weight.detach().bfloat16(), stride=2, padding=1)
    torch.testing.assert_close(out.detach(), ref, atol=0, rtol=0)
    out.float().sum().backward()
    assert conv.weight.grad.dtype == torch.float32


# ---------------------------------------------------------------- dW, loss


def test_bf16_fast_dw_linear_matches_jax_at_the_pooler():
    """A ``fast_dw`` Linear (768 x 768: both widths multiples of 128) on a
    bf16 input, its weight fp32, at the pooler's strided x[:, 0] (K = 4):
    against the JAX package's ``Linear`` under ``pallas_dw("interpret")``
    (``dot_general_dw`` in interpret mode on ``kernel.astype(bf16)``). dW is
    rounded to bf16, then widened to the fp32 parameter's dtype, on both
    sides; dW, the bias's gradient and dx within one bf16 step of their
    scale (both sum in fp32 and round once)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 7, 768)).astype(np.float32)
    g = rng.normal(size=(4, 768)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jlin = JaxLinear(768)
    params = jlin.init(jax.random.key(3), xb[:, 0])

    def loss(p, a):
        with jdw.pallas_dw("interpret"):
            y = jlin.apply(p, a[:, 0])
        return jnp.sum(y.astype(jnp.float32) * g)

    (ref_p, ref_dx) = jax.grad(loss, argnums=(0, 1))(params, xb)
    lin = Linear(768, 768).train()
    lin.fast_dw = True
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(params["params"]["kernel"]).T.copy()))
        lin.bias.copy_(torch.from_numpy(np.asarray(params["params"]["bias"])))
    tx = torch.from_numpy(_f32(xb)).bfloat16().requires_grad_()
    seen = []
    weight_grad = DW.weight_grad

    def recording(x2d, dy2d):
        seen.append((tuple(x2d.shape), x2d.stride(), x2d.dtype))
        return weight_grad(x2d, dy2d)

    DW.weight_grad = recording
    try:
        out = lin(tx[:, 0])
        (out.float() * torch.from_numpy(g)).sum().backward()
    finally:
        DW.weight_grad = weight_grad
    assert out.dtype == torch.bfloat16
    assert seen == [((4, 768), (7 * 768, 1), torch.bfloat16)]  # the strided rows, in place
    assert lin.weight.grad.dtype == torch.float32
    assert torch.equal(lin.weight.grad, lin.weight.grad.bfloat16().float())  # rounded to bf16
    for got, ref in ((lin.weight.grad.t(), ref_p["params"]["kernel"]),
                     (lin.bias.grad, ref_p["params"]["bias"]), (tx.grad, ref_dx)):
        ref = _f32(ref)
        np.testing.assert_allclose(_f32(got), ref, atol=BF16_STEP * np.abs(ref).max(), rtol=0)


def test_softmax_cross_entropy_widens_bf16_logits_like_jax():
    """The loss of bf16 logits is computed in fp32 (``ops/losses.py``, as
    JAX's ``logits.astype(jnp.float32)``): an fp32 loss equal to JAX's within
    1e-6 relative, and a bf16 gradient for the bf16 logits."""
    rng = np.random.default_rng(6)
    logits = jnp.asarray(rng.normal(size=(16, 7)) * 4).astype(jnp.bfloat16)
    labels = rng.integers(0, 7, size=16)
    ref = jax_losses.softmax_cross_entropy(logits, jnp.asarray(labels))
    t = torch.from_numpy(_f32(logits)).bfloat16().requires_grad_()
    got = losses.softmax_cross_entropy(t, torch.from_numpy(labels))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    got.backward()
    assert t.grad.dtype == torch.bfloat16


# ---------------------------------------------------------------- where bf16 runs


def _record_dtypes(model, monkeypatch):
    """Input dtypes by module name for every Linear, Conv2d, BatchNorm2d and
    LayerNormFP32 of ``model``, and those of every attention call."""
    seen = {}
    for name, m in model.named_modules():
        if isinstance(m, (Linear, Conv2d, BatchNorm2d, LayerNormFP32)):
            m.register_forward_pre_hook(
                lambda mod, args, name=name: seen.setdefault(name, set()).add(args[0].dtype))
    calls = []
    for module, fn in ((TT, "attention_qkv_packed"), (TB, "attention_heads_last")):
        real = getattr(module, fn)

        def recording(*args, real=real, **kwargs):
            calls.append(args[0].dtype)
            return real(*args, **kwargs)

        monkeypatch.setattr(module, fn, recording)
    return seen, calls


def test_flava_bf16_step_runs_bf16_at_every_block(monkeypatch):
    """One ``setup_flava(dtype=bf16)`` train step: every Linear and LayerNorm
    takes a bf16 input (the projections the cast features), every attention
    call (one a layer) a bf16 packed QKV; the gradients are fp32."""
    ts = setup_flava(model_type="MIMO-shuffle-instance", n_classes=3, lr=1e-3,
                     multimodal_num_attention_heads=2, multimodal_num_hidden_layers=2,
                     image_hidden_size=D_IN, text_hidden_size=D_IN, device="cpu",
                     dtype=torch.bfloat16)
    seen, calls = _record_dtypes(ts.model, monkeypatch)
    x, y = to_device(_flava_batches(1)[0], "cpu")
    train_step(ts.bundle, ts.optimizer, x, y, torch.Generator().manual_seed(0))
    assert calls == [torch.bfloat16] * 2
    assert seen and all(v == {torch.bfloat16} for v in seen.values()), seen
    assert all(p.grad.dtype == torch.float32 for p in ts.model.parameters())


def test_mmbt_bf16_micro_step_runs_bf16_at_every_block(monkeypatch):
    """One ``setup_mmbt(dtype=bf16)`` micro-step: every convolution,
    BatchNorm and Linear takes a bf16 input, every BERT layer's attention
    bf16 q, k, v, every LayerNorm bf16 but the shared embedding LayerNorm
    (fp32 sums of the fp32 tables, cast after it, as in JAX)."""
    ts = _port_mmbt()
    seen, calls = _record_dtypes(ts.model, monkeypatch)
    x, y = to_device(_mmbt_batch(), "cpu")
    train_step(ts.bundle, ts.optimizer, x, y, torch.Generator().manual_seed(0),
               flags=(False, False), accumulator=ts.accumulator)
    assert calls == [torch.bfloat16] * BERT["num_hidden_layers"]
    assert seen.pop("enc.txt_embeddings.LayerNorm") == {torch.float32}
    assert any(".conv" in n for n in seen) and any(".bn" in n for n in seen)
    assert all(v == {torch.bfloat16} for v in seen.values()), seen


# ---------------------------------------------------------------- the train CLI


def _write_shards(root, rng, n=(16, 8, 8), d=768):
    shard_dir = os.path.join(root, "flava_packed")
    os.makedirs(shard_dir)
    for phase, count in zip(("train", "dev", "test"), n):
        img_len, txt_len = rng.integers(5, 12, size=count), rng.integers(3, 9, size=count)
        np.save(os.path.join(shard_dir, f"{phase}_img.npy"),
                rng.normal(size=(int(img_len.sum()), d)).astype(np.float32))
        np.save(os.path.join(shard_dir, f"{phase}_txt.npy"),
                rng.normal(size=(int(txt_len.sum()), d)).astype(np.float32))
        np.save(os.path.join(shard_dir, f"{phase}_img_offsets.npy"), np.cumsum([0, *img_len]))
        np.save(os.path.join(shard_dir, f"{phase}_txt_offsets.npy"), np.cumsum([0, *txt_len]))
        np.save(os.path.join(shard_dir, f"{phase}_labels.npy"), np.arange(count) % 2)


def _write_food101(root, rng, size, n=(8, 4, 4)):
    """A Food-101 tree with BERT's special ids and ``size`` x ``size`` P6 images."""
    os.makedirs(root)
    words = ["the", "soup", "is", "very", "good", "noodle", "broth", "spicy", "taco"]
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
                          + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    for split, count in zip(("train", "dev", "test"), n):
        with open(os.path.join(root, f"{split}.jsonl"), "w") as f:
            for i in range(count):
                img = f"{split}_{i}.ppm"
                write_ppm(os.path.join(root, img), rng.integers(0, 256, (size, size, 3), np.uint8))
                f.write(json.dumps({"label": ("pho", "ramen")[i % 2], "img": img,
                                    "text": " ".join(rng.choice(words, size=int(rng.integers(2, 20))))})
                        + "\n")


def _argv(framework, tmp_path, *extra):
    common = ["--framework", framework, "--device", "cpu", "--save_path", str(tmp_path / "run"),
              "--bf16", "--lr", "1e-4", *extra]
    if framework == "flava":
        return common + ["--batch_size", "8", "--model_type", "MIMO-shuffle-instance",
                         "--multimodal_num_hidden_layers", "1"]
    return common + ["--dataset", "food101", "--tiny", "--batch_size", "4",
                     "--gradient_accumulation_steps", "2", "--freeze_img", "0",
                     "--freeze_txt", "0"]


@pytest.mark.parametrize("framework", ["flava", "mmbt"])
def test_train_cli_bf16_on_the_cpu_one_epoch_then_resume(framework, tmp_path, monkeypatch):
    """``--bf16 --device cpu``: one epoch runs every attention call in bf16;
    history.csv has a finite row; the checkpoint's parameters, buffers,
    optimizer moments (and MMBT's accumulated gradients) are fp32; a
    ``--resume`` continues to epoch 2 from it."""
    data = tmp_path / "data"
    monkeypatch.setenv("DATA_DIR", str(data))
    rng = np.random.default_rng(8)
    if framework == "flava":
        _write_shards(str(data / "hateful-meme-dataset"), rng)
    else:
        _write_food101(str(data / "food101"), rng, 256)
    calls = []
    module, fn = (TT, "attention_qkv_packed") if framework == "flava" else (
        TB, "attention_heads_last")
    real = getattr(module, fn)
    monkeypatch.setattr(module, fn, lambda *a, **k: calls.append(a[0].dtype) or real(*a, **k))
    port_train.main(_argv(framework, tmp_path, "--n_epochs", "1"))
    run = tmp_path / "run"
    hist = load_history(str(run))
    assert hist["epoch"] == [1] and np.isfinite(hist["loss"]).all()
    assert calls and set(calls) == {torch.bfloat16}
    model, opt = load_weights(str(run / "model_last_epoch.pt"))
    floats = [t for t in model.values() if t.is_floating_point()]
    for tree in (opt["opt_state"]["mu"], opt["opt_state"]["nu"], opt.get("accum_grads", {})):
        floats += list(tree.values())
    assert floats and all(t.dtype == torch.float32 for t in floats)
    port_train.main(_argv(framework, tmp_path, "--n_epochs", "2", "--resume"))
    assert load_history(str(run))["epoch"] == [1, 2]


def test_train_cli_bf16_leaves_vilt_in_fp32(tmp_path, monkeypatch, caplog):
    """``--bf16 --framework vilt`` is taken and ignored, as in the root CLI
    (its vilt branch passes no dtype): a warning says so, and one micro-step
    of the CLI's setup runs its attention on fp32 activations."""
    data = tmp_path / "data"
    monkeypatch.setenv("DATA_DIR", str(data))
    _write_food101(str(data / "food101"), np.random.default_rng(9), 384, n=(4, 4, 4))
    argv = ["--framework", "vilt", "--dataset", "food101", "--tiny", "--device", "cpu",
            "--save_path", str(tmp_path / "run"), "--batch_size", "4", "--bf16"]
    args = port_train.add_conditional_args(port_train.build_parser().parse_args(argv))
    with caplog.at_level(logging.WARNING, logger=port_train.__name__):
        train, _, _, setup = port_train._vilt_setup(args, torch.device("cpu"))
    assert "--bf16 ignored for --framework vilt" in caplog.text
    calls = []
    real = TV.attention_qkv_packed
    monkeypatch.setattr(TV, "attention_qkv_packed",
                        lambda *a, **k: calls.append(a[0].dtype) or real(*a, **k))
    x, y = to_device(next(iter(train)), "cpu")
    logs = train_step(setup.bundle, setup.optimizer, x, y, torch.Generator().manual_seed(0),
                      accumulator=setup.accumulator)
    assert np.isfinite(float(logs["loss"]))
    assert calls and set(calls) == {torch.float32}
