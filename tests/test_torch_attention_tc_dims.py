"""The bf16 attention at Dh 128 and 32 against the JAX package's K1, on the CPU.

On the card these head dims run the tensor-core sources
``csrc/attention_{fwd,bwd}_tc_{128,32}.cu`` (FLAVA fusion at 6 and 24 heads
under ``--bf16``, and the tiny BERT's Dh 32), held there to the port's plain
versions; here the port runs those plain versions. The JAX package runs these
head dims on its packed kernel K1 (``_sdpa_packed_fwd_impl``,
``_sdpa_packed_bwd_impl``; Dh 128 one head a 128-lane block, Dh 32 four), in
interpret mode, with the calls counted. Inputs are drawn with numpy from a
seed and handed to both sides in bf16.

Tolerances, the card's bf16 gates: logits within 2e-2 absolute (|logits| <
2, where a bf16 step is 2^-7; both sum in fp32 and round to bf16 at other
points); dq | dk | dv within 3e-2 x max(1, max|ref|) (both round P and dS to
bf16 before their products and sum in fp32, in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.models.fusion import FlavaFusionTransformer as JaxFusion
from multimodal_uncertainty_tpu.ops import attention as JA
from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
from multimodal_uncertainty_tpu_torch.models.jax_import import fusion_state_dict_from_jax
from multimodal_uncertainty_tpu_torch.ops import attention as TA

LAYERS = 2
WIDTHS = dict(num_classes=5, image_hidden_size=64, text_hidden_size=48, out_dim=2,
              multimodal_hidden_size=128, multimodal_num_hidden_layers=LAYERS)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if isinstance(a, jax.Array) else (
        a.detach().float().numpy())


def _count(monkeypatch, names) -> list:
    """Record (name, first argument's shape) of each call of the JAX
    package's attention functions ``names``."""
    calls = []
    for name in names:
        real = getattr(JA, name)

        def counting(*args, _real=real, _name=name, **kwargs):
            calls.append((_name, args[0].shape))
            return _real(*args, **kwargs)

        monkeypatch.setattr(JA, name, counting)
    return calls


@pytest.mark.parametrize("heads", [1, 4])
def test_fusion_bf16_logits_match_jax_k1_at_dh_128_and_32(heads, monkeypatch):
    """The ``mimo`` fusion at ``multimodal_hidden_size=128`` with 1 and 4
    heads (Dh 128 and 32) in bf16 against the JAX module with
    ``dtype=jnp.bfloat16`` and ``attn_impl="pallas_interpret"``: one K1 call
    (``_sdpa_packed_fwd_impl``) a layer at the packed width 3 x 128, none on
    the heads-first K6; logits within 2e-2 absolute."""
    calls = _count(monkeypatch, ("_sdpa_packed_fwd_impl", "_sdpa_pallas_fwd_impl"))
    kw = {**WIDTHS, "multimodal_num_attention_heads": heads}
    rng = np.random.default_rng(128 + heads)
    img = rng.normal(size=(3, 24, 64)).astype(np.float32)
    txt = rng.normal(size=(3, 16, 48)).astype(np.float32)
    txt_mask = np.arange(16)[None] < rng.integers(2, 17, size=3)[:, None]
    jmodel = JaxFusion(attn_impl="pallas_interpret", dtype=jnp.bfloat16, **kw)
    variables = jmodel.init({"params": jax.random.key(heads)}, (img, txt), train=False)
    calls.clear()
    ref = jmodel.apply(variables, (jnp.asarray(img), jnp.asarray(txt)), train=False,
                       txt_mask=jnp.asarray(txt_mask))
    assert calls == [("_sdpa_packed_fwd_impl", calls[0][1])] * LAYERS, calls
    assert calls[0][1][-1] == 3 * 128, calls
    model = FlavaFusionTransformer(dtype=torch.bfloat16, **kw).eval()
    model.load_state_dict(fusion_state_dict_from_jax(variables["params"]), strict=True)
    with torch.inference_mode():
        out = model((torch.from_numpy(img), torch.from_numpy(txt)),
                    txt_mask=torch.from_numpy(txt_mask))
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-2, rtol=0)


@pytest.mark.parametrize("dh", [128, 32])
def test_bf16_packed_grads_match_jax_k1_bwd_at_dh_128_and_32(dh, monkeypatch):
    """dq | dk | dv of the port's packed entry point in bf16 (its plain
    backward, which the tensor-core backward of ``attention_bwd_tc_{dh}.cu``
    is held to on the card) against the JAX package's K1 backward
    (``_sdpa_packed_bwd_impl``, one call, in interpret mode) at D = 256 (2 /
    8 heads), B=4, S=40, with a ragged key mask (holes, one sample fully
    masked): within 3e-2 x max(1, max|ref|) of each of the three."""
    calls = _count(monkeypatch, ("_sdpa_packed_bwd_impl",))
    b, s, d = 4, 40, 256
    rng = np.random.default_rng(dh)
    qkv = rng.normal(size=(b, s, 3 * d)).astype(np.float32)
    g = rng.normal(size=(b, s, d)).astype(np.float32)
    mask = np.arange(s)[None, :] < rng.integers(s // 2, s + 1, size=b)[:, None]
    mask &= rng.random((b, s)) > 0.2
    mask[:, 0] = True
    mask[3] = False
    n_head = d // dh
    jqkv = jnp.asarray(qkv).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: JA.attention_qkv_packed(t, jnp.asarray(mask), n_head=n_head,
                                                       impl="pallas_interpret"), jqkv)
    ref = _f32(vjp(jnp.asarray(g).astype(jnp.bfloat16))[0])
    assert [name for name, _ in calls] == ["_sdpa_packed_bwd_impl"], calls

    x = torch.from_numpy(qkv).bfloat16().requires_grad_()
    TA.attention_qkv_packed(x, torch.from_numpy(mask), n_head=n_head).backward(
        torch.from_numpy(g).bfloat16())
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == (b, s, 3 * d)
    got = _f32(x.grad)
    for i, name in enumerate("qkv"):
        want = ref[..., i * d:(i + 1) * d]
        np.testing.assert_allclose(got[..., i * d:(i + 1) * d], want,
                                   atol=3e-2 * max(1.0, np.abs(want).max()), rtol=0,
                                   err_msg=f"d{name}")
