"""The port's ViLT (model, weight converter, dataset) against the JAX package's, on the CPU.

A tiny ViLT (64 wide, 2 layers, 2 heads of 32, 384x384 images, 32x32 patches)
is initialised by the JAX package, its weights cross over through
``vilt_state_dict_from_jax``, and both models get the same numpy batches:
full pixel masks (where HF's position interpolation is the identity), a
top-left 256x320 rectangle, a rectangle that cuts patches, an all-zero mask
(the ``ablate="image"`` probe: h_i = w_i = 0), no mask at all (the
broadcast branch), and NHWC, NCHW and (B, 1, C, H, W) pixels. The JAX side
runs its XLA attention; the port its plain attention (the CUDA kernels run
only on the card).

Tolerance: logits within 1e-5 (fp32 through 2 blocks, the same math summed
in another order). The dataset and collate function are held to the JAX
package's exactly, on a tree of P6 images (one of which needs a resize).
"""
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu.data import vilt_data as JD
from multimodal_uncertainty_tpu.models.vilt import ViltConfig as JaxConfig
from multimodal_uncertainty_tpu.models.vilt import ViltForImagesAndTextClassification as JaxVilt
from multimodal_uncertainty_tpu_torch.data import vilt_data as TD
from multimodal_uncertainty_tpu_torch.data.images import write_ppm
from multimodal_uncertainty_tpu_torch.models.jax_import import vilt_state_dict_from_jax
from multimodal_uncertainty_tpu_torch.models.vilt import ViltConfig
from multimodal_uncertainty_tpu_torch.models.vilt import ViltForImagesAndTextClassification

TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, num_labels=5, image_size=384)
B, LT, IMG = 4, 16, 384


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JaxConfig.b32(), **TINY)
    jmodel = JaxVilt(config=jcfg, attn_impl="xla")
    sample = {"input_ids": jnp.zeros((2, LT), jnp.int32),
              "attention_mask": jnp.ones((2, LT), jnp.int32),
              "token_type_ids": jnp.zeros((2, LT), jnp.int32),
              "pixel_values": jnp.zeros((2, IMG, IMG, 3), jnp.float32),
              "pixel_mask": jnp.ones((2, IMG, IMG), jnp.int32)}
    variables = jmodel.init({"params": jax.random.key(0)}, sample, train=False)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables["params"])
    tmodel = ViltForImagesAndTextClassification(
        dataclasses.replace(ViltConfig.b32(), **TINY))
    tmodel.load_state_dict(vilt_state_dict_from_jax({"params": params}), strict=True)
    return jmodel, {"params": params}, tmodel.eval()


def _batch(seed=0, n=B, lt=LT):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, lt + 1, size=n)
    lengths[0] = lt
    mask = (np.arange(lt)[None] < lengths[:, None]).astype(np.int64)
    ids = rng.integers(0, TINY["vocab_size"], size=(n, lt)) * mask
    return {
        "input_ids": ids.astype(np.int64),
        "attention_mask": mask,
        "token_type_ids": np.zeros((n, lt), np.int64),
        "pixel_values": rng.normal(size=(n, IMG, IMG, 3)).astype(np.float32),
    }


def _rect(n, h, w):
    m = np.zeros((n, IMG, IMG), np.int64)
    m[:, :h, :w] = 1
    return m


def _logits(models, batch):
    jmodel, variables, tmodel = models
    ref = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    with torch.inference_mode():
        out = tmodel({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    return np.asarray(ref.logits), out.logits.numpy()


def test_state_dict_maps_one_to_one(models):
    _, variables, tmodel = models
    sd = vilt_state_dict_from_jax(variables)
    own = tmodel.state_dict()
    assert set(sd) == set(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in own)
    assert "vilt.block.1.qkv.weight" in own and "cls_ln.weight" in own
    assert own["vilt.patch_embed.weight"].shape == (64, 3, 32, 32)  # OIHW


@pytest.mark.parametrize("case", ["full", "rect_256x320", "rect_cuts_patches", "zero", "mixed",
                                  "none"])
def test_logits_match_jax_under_pixel_masks(models, case):
    batch = _batch(1)
    if case == "full":
        batch["pixel_mask"] = np.ones((B, IMG, IMG), np.int64)
    elif case == "rect_256x320":
        batch["pixel_mask"] = _rect(B, 256, 320)
    elif case == "rect_cuts_patches":
        batch["pixel_mask"] = _rect(B, 200, 330)
    elif case == "zero":
        batch["pixel_mask"] = np.zeros((B, IMG, IMG), np.int64)
    elif case == "mixed":
        batch["pixel_mask"] = np.stack([np.ones((IMG, IMG), np.int64), _rect(1, 256, 320)[0],
                                        np.zeros((IMG, IMG), np.int64), _rect(1, 64, 384)[0]])
    ref, out = _logits(models, batch)
    assert out.shape == (B, TINY["num_labels"]) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout", ["nchw", "n1chw"])
def test_logits_match_jax_for_each_pixel_layout(models, layout):
    batch = _batch(2)
    batch["pixel_mask"] = _rect(B, 256, 320)
    ref_nhwc, _ = _logits(models, batch)
    pv = np.ascontiguousarray(batch["pixel_values"].transpose(0, 3, 1, 2))
    batch["pixel_values"] = pv if layout == "nchw" else pv[:, None]
    ref, out = _logits(models, batch)
    np.testing.assert_allclose(ref, ref_nhwc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_full_mask_interpolation_is_the_identity(models):
    """With a full 384 mask the bilinear positions equal the table (the broadcast branch)."""
    _, _, tmodel = models
    keep = torch.ones(3, 12, 12, dtype=torch.bool)
    interp = tmodel.vilt._patch_positions(keep, 12, 12, interpolate=True)
    table = tmodel.vilt._patch_positions(keep, 12, 12, interpolate=False)
    torch.testing.assert_close(interp, table, atol=1e-6, rtol=0)


def test_loss_and_missing_token_types_follow_jax(models):
    batch = _batch(3)
    batch["pixel_mask"] = np.ones((B, IMG, IMG), np.int64)
    del batch["token_type_ids"]
    labels = np.array([0, 4, 2, 1])
    jmodel, variables, tmodel = models
    ref = jmodel.apply(variables, {**{k: jnp.asarray(v) for k, v in batch.items()},
                                   "labels": jnp.asarray(labels)}, train=False)
    out = tmodel({**{k: torch.from_numpy(v) for k, v in batch.items()},
                  "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(ref.logits), atol=1e-5)
    assert abs(float(out.loss.detach()) - float(ref.loss)) <= 1e-5 * abs(float(ref.loss))


def test_text_past_the_position_table_raises(models):
    batch = _batch(4, lt=48)
    with pytest.raises(ValueError, match="position table"):
        models[2]({k: torch.from_numpy(v) for k, v in batch.items()})


def _write_tree(root, rng):
    """A tiny Food-101-style tree: 3 labels, a vocabulary with BERT's special
    ids, P6 images (384x384, and one 400x500 that needs the resize)."""
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                     "[MASK]"]
    vocab += ["the", "soup", "cake", "##s", "red", "green", "pasta", ",", "."]
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    texts = ["The red soup.", "green cakes, pasta", "unknownword soup " * 12, "cake"]
    for split, n in (("train", 4), ("dev", 2), ("test", 2)):
        with open(os.path.join(root, f"{split}.jsonl"), "w") as f:
            for i in range(n):
                shape = (400, 500, 3) if (split, i) == ("train", 1) else (384, 384, 3)
                img = f"{split}_{i}.ppm"
                write_ppm(os.path.join(root, img), rng.integers(0, 256, shape, np.uint8))
                f.write(json.dumps({"label": ["a", "b", "c"][i % 3], "text": texts[i % 4],
                                    "img": img}) + "\n")


def test_dataset_and_collate_match_jax(tmp_path):
    pytest.importorskip("PIL")  # the JAX dataset opens every image with PIL
    _write_tree(str(tmp_path), np.random.default_rng(0))
    args = types.SimpleNamespace(labels=["a", "b", "c"], error_cases_remover=False,
                                 vocab_file=None, batch_size=3, seed=7, sample_size=None,
                                 n_workers=0)
    jl = JD.get_dataset_vilt(args, str(tmp_path))
    tl = TD.get_dataset_vilt(args, str(tmp_path))
    for j_loader, t_loader in zip(jl, tl):
        j_batches, t_batches = list(j_loader.iter_epoch(1)), list(t_loader.iter_epoch(1))
        assert len(j_batches) == len(t_batches) > 0
        for (jx, jy), (tx, ty) in zip(j_batches, t_batches):
            np.testing.assert_array_equal(ty, jy)
            assert set(tx) == set(jx)
            for k in jx:
                assert tx[k].dtype == jx[k].dtype, k
                np.testing.assert_array_equal(tx[k], jx[k], err_msg=k)
    ids = tl[0].dataset[2]["input_ids"]
    assert ids[0] == 101 and 102 in ids and len(ids) == 40  # [CLS] ... [SEP], cut to 40
