"""Model setup (port of ``zoo.py::setup_flava``, :175-259, ``setup_mmbt``,
:313-476, and ``setup_vilt``, :484-563).

``build_flava`` builds the fusion model for serving; ``setup_flava`` builds
it for training with its bundle, its AdamW optimizer and the cosine-warmup
schedule. ``build_mmbt`` builds MMBT (BERT + ResNet) for serving;
``setup_mmbt`` for training, with BertAdam, the plateau scheduler, gradient
accumulation and the freeze schedule. ``build_vilt`` / ``setup_vilt`` do the
same for ViLT-B/32 (AdamW at a constant rate, the plateau scheduler,
gradient accumulation). ``setup_fashionmnist`` (port of :91-168) builds the
FashionMNIST round's MIMO ResNet (SGD, the plateau on val_loss) or MIMO
transformer (BertAdam, the plateau on val_acc), fp32.

``dtype`` (``train --bf16``: bf16 for FLAVA and MMBT) is the compute dtype
of ``setup_flava`` and ``setup_mmbt``, as the JAX package's ``dtype=``:
activations run in it, while parameters, the optimizer's state, BatchNorm
statistics and checkpoints stay fp32, and the loss widens the logits to fp32.

``fast_dw`` (``train --fast_dw``) sets every ``Linear``'s flag: in training,
those whose widths are multiples of 128 compute their weight gradient with
the dW kernel (``ops/dw.py``), as the JAX package's ``pallas_dw`` switch does
around its train-mode apply. ``remat`` (``train --remat``; FLAVA and MMBT, as
the JAX package's setups) rematerialises the transformer blocks, BERT layers
and ResNet bottlenecks in training (``models/remat.py``). ``diversity`` /
``diversity_coef`` (``--diversity``; FLAVA and FashionMNIST) add the ensemble-
diversity term to the step's loss (``ops/diversity.py``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Mapping, Optional, Sequence

import torch

from multimodal_uncertainty_tpu_torch.data.images import (
    FOOD101_MEAN,
    FOOD101_STD,
    normalize_on_device,
)
from multimodal_uncertainty_tpu_torch.device import resolve_device
from multimodal_uncertainty_tpu_torch.models import model_configure
from multimodal_uncertainty_tpu_torch.models.bert import BertConfig
from multimodal_uncertainty_tpu_torch.models.fusion import FlavaFusionTransformer
from multimodal_uncertainty_tpu_torch.models.layers import set_fast_dw
from multimodal_uncertainty_tpu_torch.models.mimo_resnet import MIMOResNet
from multimodal_uncertainty_tpu_torch.models.mimo_transformer import MIMOTransformer
from multimodal_uncertainty_tpu_torch.models.mmbt import MultimodalBertClf, mmbt_frozen_subtrees
from multimodal_uncertainty_tpu_torch.models.torch_import import (
    import_mmbt_pretrained,
    import_vilt_pretrained,
)
from multimodal_uncertainty_tpu_torch.models.vilt import (
    ViltConfig,
    ViltForImagesAndTextClassification,
)
from multimodal_uncertainty_tpu_torch.ops.data_forming import (
    MULTIVIEW_MODEL_TYPES,
    data_forming_func,
    data_forming_func_transformer,
)
from multimodal_uncertainty_tpu_torch.ops.losses import mimo_cross_entropy, plain_cross_entropy
from multimodal_uncertainty_tpu_torch.ops.metrics import accuracy
from multimodal_uncertainty_tpu_torch.training.optim import (
    AdamW,
    SGD,
    BertAdam,
    ReduceLROnPlateau,
    constant_schedule,
    cosine_warmup_schedule,
)
from multimodal_uncertainty_tpu_torch.training.steps import GradAccumulator, ModelBundle

MODEL_TYPES = ("Vanilla", "MIMO-shuffle-instance", "MultiHead")


def build_flava(
    model_type: str = "Vanilla",
    n_classes: int = 2,
    heads: int = 3,
    layers: int = 3,
    clstoken: bool = False,
    avg_pool: bool = False,
    *,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> FlavaFusionTransformer:
    """The fusion model at the JAX package's widths (768-wide FLAVA embeddings
    and fusion width), fp32, in eval mode on ``device`` (default ``cuda``).
    ``out_dim`` is 1 for Vanilla and 2 (the ensemble heads) otherwise. Weights
    are drawn on the CPU from ``generator``, then moved."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type {model_type!r} not in {MODEL_TYPES}")
    dev = resolve_device(device)
    model = FlavaFusionTransformer(
        out_dim=1 if model_type == "Vanilla" else 2,
        num_classes=n_classes,
        multimodal_num_attention_heads=heads,
        multimodal_num_hidden_layers=layers,
        avg_pool=avg_pool,
        cls_token=clstoken,
        generator=generator,
    )
    return model.to(dev).eval()


def build_mmbt(
    n_classes: int = 101,
    *,
    bert_config: Optional[BertConfig] = None,
    resnet_layers: Sequence[int] = (3, 8, 36, 3),
    num_image_embeds: int = 3,
    vocab_size: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> MultimodalBertClf:
    """MMBT, by default BERT-base + ResNet-152 with 3 image embeddings, fp32,
    in eval mode on ``device`` (default ``cuda``). ``vocab_size`` overrides
    the BERT config's. Weights are drawn on the CPU from ``generator``, then
    moved; it is also the template a checkpoint is restored into."""
    dev = resolve_device(device)
    cfg = bert_config or BertConfig.base()
    if vocab_size is not None and vocab_size != cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    model = MultimodalBertClf(cfg, n_classes, num_image_embeds,
                              resnet_layers=tuple(resnet_layers), generator=generator)
    return model.to(dev).eval()


def build_vilt(
    n_classes: int = 101,
    *,
    vilt_config: Optional[ViltConfig] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> ViltForImagesAndTextClassification:
    """ViLT, by default ViLT-B/32 (768 wide, 12 layers of 12 heads of 64, FFN
    3072, 384x384 images in 32x32 patches) with ``n_classes`` labels, fp32,
    in eval mode on ``device`` (default ``cuda``). Weights are drawn on the
    CPU from ``generator``, then moved; it is also the template a checkpoint
    is restored into."""
    dev = resolve_device(device)
    cfg = vilt_config or dataclasses.replace(ViltConfig.b32(), num_labels=n_classes)
    return ViltForImagesAndTextClassification(cfg, generator=generator).to(dev).eval()


def _seeded(generator: Optional[torch.Generator], device: torch.device, run: Callable):
    """``run(dropout_generator)`` with a seed drawn from the step's generator:
    the attention masks come from a device generator of that seed, the other
    dropouts from torch's default generators, seeded for the call and
    restored after it, so a rerun from the same generator draws the same."""
    step_seed = 0 if generator is None else int(
        torch.randint(0, 2**62, (1,), generator=generator))
    forked = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=forked):
        torch.manual_seed(step_seed)
        return run(torch.Generator(device).manual_seed(step_seed))


def _seeded_dropout(model, x, *, train: bool, generator: Optional[torch.Generator] = None):
    """The apply_fn of a model whose only randomness is ``nn.Dropout`` (FLAVA
    fusion and the MIMO transformer with ``dropout > 0``): in training its
    dropouts draw from a seed taken from the step's generator, so a step is a
    function of (seed, epoch, batch) and a resumed run repeats its masks."""
    if not train:
        return model(x)
    return _seeded(generator, next(model.parameters()).device, lambda _: model(x))


@dataclasses.dataclass
class Setup:
    model: torch.nn.Module
    bundle: ModelBundle
    optimizer: object  # AdamW (fusion, ViLT), BertAdam (MMBT, MIMO transformer) or SGD
    schedule: Callable[[int], float]
    plateau: Optional[ReduceLROnPlateau] = None  # stepped every epoch on scheduler_metric
    accumulator: Optional[GradAccumulator] = None
    scheduler_metric: str = "val_acc"
    size_fn: Optional[Callable] = None  # a batch's weight in the means; None is len(y)

    @property
    def step(self) -> int:
        """Train (micro-)steps taken."""
        return self.accumulator.step if self.accumulator is not None else self.optimizer.step


def setup_flava(
    *,
    model_type: str = "Vanilla",
    n_classes: int = 2,
    lr: float = 1e-4,
    wd: float = 0.001,
    n_epochs: int = 100,
    steps_per_epoch: int = 100,
    multimodal_num_attention_heads: int = 3,
    multimodal_num_hidden_layers: int = 3,
    dropout: float = 0.0,
    clstoken: bool = False,
    avg_pool: bool = False,
    image_hidden_size: int = 768,
    text_hidden_size: int = 768,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    fast_dw: bool = False,
    remat: bool = False,
    diversity: str = "none",
    diversity_coef: float = 0.0,
    device=None,
) -> Setup:
    """The fusion model (fp32 weights drawn from ``seed`` on the CPU, then
    moved to ``device``, default ``cuda``; activations in ``dtype``), with
    AdamW (betas (0.9, 0.98), eps 1e-9, decay ``wd`` on every parameter)
    under the HF cosine schedule with 3 epochs of warmup, stepped every batch
    (``train.py:196-208``). ``fast_dw``: training-mode Linears take the dW
    kernel. ``remat``: the encoder's blocks are rematerialised in training.
    ``diversity`` / ``diversity_coef``: the step adds that diversity term
    (``ops/diversity.py``). With ``dropout > 0`` the dropouts draw from the
    step's generator."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type {model_type!r} not in {MODEL_TYPES}")
    dev = resolve_device(device)
    model = FlavaFusionTransformer(
        out_dim=1 if model_type == "Vanilla" else 2,
        num_classes=n_classes,
        image_hidden_size=image_hidden_size,
        text_hidden_size=text_hidden_size,
        multimodal_num_attention_heads=multimodal_num_attention_heads,
        multimodal_num_hidden_layers=multimodal_num_hidden_layers,
        drop=dropout,
        avg_pool=avg_pool,
        cls_token=clstoken,
        dtype=dtype,
        remat=remat,
        generator=torch.Generator().manual_seed(seed),
    ).to(dev)
    set_fast_dw(model, fast_dw)
    schedule = cosine_warmup_schedule(lr, warmup_steps=steps_per_epoch * 3,
                                      total_steps=steps_per_epoch * n_epochs)
    optimizer = AdamW(model.named_parameters(), schedule, b1=0.9, b2=0.98, eps=1e-9,
                      weight_decay=wd)
    bundle = ModelBundle(
        model=model,
        loss_fn=mimo_cross_entropy,
        data_forming=lambda gen, x, y, phase: data_forming_func_transformer(
            x, y, phase=phase, model_type=model_type, generator=gen),
        metric_fns=(("acc", partial(accuracy, dummy_dim=True)),),
        apply_fn=_seeded_dropout if dropout else None,
        diversity_kind=diversity,
        diversity_coef=diversity_coef,
    )
    return Setup(model, bundle, optimizer, schedule)


def setup_mmbt(
    *,
    n_classes: int,
    lr: float = 5e-5,
    warmup: float = 0.1,
    total_steps: float = 1000.0,
    lr_patience: int = 2,
    lr_factor: float = 0.5,
    num_image_embeds: int = 3,
    bert_config: Optional[BertConfig] = None,
    resnet_layers: Sequence[int] = (3, 8, 36, 3),
    img_embed_pool_type: str = "avg",
    dropout: float = 0.1,
    gradient_accumulation_steps: int = 40,
    vocab_size: Optional[int] = None,
    modality: str = "both",
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    fast_dw: bool = False,
    pretrained_bert_sd: Optional[Mapping[str, torch.Tensor]] = None,
    pretrained_resnet_sd: Optional[Mapping[str, torch.Tensor]] = None,
    remat: bool = False,
    device=None,
) -> Setup:
    """MMBT for training (the JAX package's ``setup_mmbt``, reference
    ``train.py:132-162``): the model (fp32 weights drawn from ``seed`` on the
    CPU, then moved to ``device``, default ``cuda``; activations in ``dtype``,
    None is fp32), BertAdam under the
    warmup-linear schedule over ``total_steps``, ReduceLROnPlateau on val_acc
    (mode max), true gradient accumulation over
    ``gradient_accumulation_steps`` micro-batches, and the freeze schedule
    of the image encoder and the BERT encoder.

    The bundle's step takes the loader's ``(text, segment, mask, imgs)``
    batch in the model's (txt, mask, segment, img) order, normalises uint8
    images on the device, and hides the image or the text under
    ``modality`` ``image`` / ``text`` (the unimodal baselines). Its dropouts
    draw from a seed taken from the step's generator: BERT's attention
    masks from a device generator, the other dropouts from torch's default
    generators, seeded inside the step and restored after it. ``fast_dw``:
    training-mode Linears take the dW kernel (a frozen one computes no dW,
    so it launches none). ``pretrained_bert_sd`` / ``pretrained_resnet_sd``:
    torch state dicts of BERT and torchvision's ResNet copied into the model
    on the CPU, before it moves and the optimizer is built
    (``models/torch_import.py``). ``remat``: each ResNet bottleneck and BERT
    layer is rematerialised in training."""
    if modality not in ("both", "image", "text"):
        raise ValueError(f"modality must be both, image or text, got {modality!r}")
    dev = resolve_device(device)
    cfg = bert_config or BertConfig.base()
    if vocab_size is not None and vocab_size != cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=vocab_size)
    model = MultimodalBertClf(cfg, n_classes, num_image_embeds, img_embed_pool_type, dropout,
                              resnet_layers=tuple(resnet_layers), dtype=dtype, remat=remat,
                              generator=torch.Generator().manual_seed(seed))
    if pretrained_bert_sd is not None or pretrained_resnet_sd is not None:
        import_mmbt_pretrained(model, pretrained_bert_sd, pretrained_resnet_sd)
    model = model.to(dev)
    set_fast_dw(model, fast_dw)
    optimizer = BertAdam(model.named_parameters(), lr, warmup, float(total_steps))
    n_img_tok = num_image_embeds + 2

    def modality_mask(bsz: int, txt_len: int, device) -> Optional[torch.Tensor]:
        if modality == "both":
            return None
        keep = torch.zeros((bsz, n_img_tok + txt_len), dtype=torch.bool, device=device)
        if modality == "image":
            keep[:, :n_img_tok] = True
        else:  # the image segment's [CLS] and the text
            keep[:, 0] = True
            keep[:, n_img_tok:] = True
        return keep

    def apply_fn(model, x, *, train: bool, generator: Optional[torch.Generator] = None):
        txt, mask, segment, img = x  # the loader's (text, segment, mask, imgs)
        if img.dtype == torch.uint8:
            img = normalize_on_device(img, FOOD101_MEAN, FOOD101_STD)
        x = (txt, mask, segment, img)
        keep = modality_mask(txt.shape[0], txt.shape[1], txt.device)
        if not train:
            return model(x, seq_keep_mask=keep)
        return _seeded(generator, txt.device,
                       lambda gen: model(x, seq_keep_mask=keep, dropout_generator=gen))

    bundle = ModelBundle(
        model=model,
        loss_fn=model.compute_loss,
        metric_fns=(("acc", partial(accuracy, dummy_dim=False)),),
        apply_fn=apply_fn,
        frozen_fn=mmbt_frozen_subtrees,
    )
    return Setup(model, bundle, optimizer, optimizer.schedule,
                 plateau=ReduceLROnPlateau(mode="max", patience=lr_patience, factor=lr_factor),
                 accumulator=GradAccumulator(gradient_accumulation_steps,
                                             model.named_parameters()))


def setup_vilt(
    *,
    n_classes: int,
    lr: float = 3e-5,
    lr_patience: int = 2,
    lr_factor: float = 0.5,
    vilt_config: Optional[ViltConfig] = None,
    image_size: int = 384,
    gradient_accumulation_steps: int = 1,
    seed: int = 0,
    fast_dw: bool = False,
    pretrained_vilt_sd: Optional[Mapping[str, torch.Tensor]] = None,
    device=None,
) -> Setup:
    """ViLT for training (the JAX package's ``setup_vilt``, reference
    ``train.py:164-182``): the model (ViLT-B/32 with ``n_classes`` labels
    unless ``vilt_config`` is given; fp32, weights drawn from ``seed`` on the
    CPU, then moved to ``device``, default ``cuda``), AdamW at a constant
    ``lr`` with torch's defaults and weight decay 0.01 on every parameter,
    ReduceLROnPlateau on val_acc (mode max), and true gradient accumulation
    when ``gradient_accumulation_steps > 1``. ``fast_dw``: training-mode
    Linears take the dW kernel. ``pretrained_vilt_sd``: an HF ViLT state dict
    copied into the model on the CPU, before it moves and the optimizer is
    built (a dict without a classification head leaves the head random).

    The bundle's step takes the loader's processor dict, normalises uint8
    pixels on the device ((x / 255 - 0.5) / 0.5), and returns the logits; its
    attention-probability dropout draws from a seed taken from the step's
    generator."""
    dev = resolve_device(device)
    cfg = vilt_config or dataclasses.replace(ViltConfig.b32(), num_labels=n_classes,
                                             image_size=image_size)
    model = ViltForImagesAndTextClassification(cfg, generator=torch.Generator().manual_seed(seed))
    if pretrained_vilt_sd is not None:
        import_vilt_pretrained(model, pretrained_vilt_sd)
    model = model.to(dev)
    set_fast_dw(model, fast_dw)
    schedule = constant_schedule(lr)
    optimizer = AdamW(model.named_parameters(), schedule, weight_decay=0.01)

    def apply_fn(model, x, *, train: bool, generator: Optional[torch.Generator] = None):
        x = dict(x)
        pv = x["pixel_values"]
        if pv.dtype == torch.uint8:
            x["pixel_values"] = (pv.float() / 255.0 - 0.5) / 0.5
        if not train:
            return model(x).logits
        return _seeded(generator, pv.device,
                       lambda gen: model(x, dropout_generator=gen).logits)

    bundle = ModelBundle(
        model=model,
        loss_fn=plain_cross_entropy,
        metric_fns=(("acc", partial(accuracy, dummy_dim=False)),),
        apply_fn=apply_fn,
    )
    accumulator = (GradAccumulator(gradient_accumulation_steps, model.named_parameters())
                   if gradient_accumulation_steps > 1 else None)
    return Setup(model, bundle, optimizer, schedule,
                 plateau=ReduceLROnPlateau(mode="max", patience=lr_patience, factor=lr_factor),
                 accumulator=accumulator)


def setup_fashionmnist(
    *,
    model_type: str = "Vanilla",
    transformer: bool = False,
    lr: float = 0.1,
    wd: float = 0.001,
    momentum: float = 0.9,
    warmup: float = 0.1,
    total_steps: Optional[int] = None,
    multimodal_num_attention_heads: int = 3,
    multimodal_num_hidden_layers: int = 3,
    dropout: float = 0.0,
    lr_patience: int = 10,
    diversity: str = "none",
    diversity_coef: float = 0.0,
    seed: int = 0,
    device=None,
) -> Setup:
    """The FashionMNIST round (the JAX package's ``setup_fashionmnist``,
    reference ``train_fashionmnist.py``), fp32, weights drawn from ``seed`` on
    the CPU, then moved to ``device`` (default ``cuda``):

    - ``transformer`` (MultiHead or MIMO-shuffle-instance only): the MIMO
      transformer (768 wide, 196-pixel view tokens), BertAdam under the
      warmup-linear schedule over ``total_steps``, the plateau on val_acc
      (mode max, factor 0.5, patience 10);
    - otherwise the MIMO ResNet, SGD (``momentum``, coupled decay ``wd``) at
      the constant ``lr``, the plateau on val_loss (mode min, factor 0.1,
      patience ``lr_patience``, threshold 1e-4).

    ``model_configure`` gives the ensemble's input and output widths; the
    bundle forms batches with ``data_forming_func`` (weight-sharing folds
    the views into the batch in every phase, so its ``size_fn`` counts
    ``len(y) * 4``) and reports ``accuracy(dummy_dim=True)``; its step adds the
    ``diversity`` term (``ops/diversity.py``) at ``diversity_coef``. The
    transformer's dropouts (``dropout > 0``) draw from the step's generator."""
    if model_type not in MULTIVIEW_MODEL_TYPES:
        raise ValueError(f"model_type {model_type!r} not in {MULTIVIEW_MODEL_TYPES}")
    emb_dim, out_dim = model_configure[model_type]
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    if transformer:
        if model_type not in ("MultiHead", "MIMO-shuffle-instance"):
            raise ValueError(f"the MIMO transformer takes MultiHead or MIMO-shuffle-instance, "
                             f"not {model_type!r}")
        model = MIMOTransformer(out_dim=out_dim, num_classes=10, hidden_size=768,
                                image_dim=14 * 14,
                                multimodal_num_hidden_layers=multimodal_num_hidden_layers,
                                multimodal_num_attention_heads=multimodal_num_attention_heads,
                                drop=dropout, generator=generator).to(dev)
        optimizer = BertAdam(model.named_parameters(), lr, warmup, float(total_steps or 1))
        schedule = optimizer.schedule
        plateau = ReduceLROnPlateau(mode="max", patience=10, factor=0.5)
        scheduler_metric = "val_acc"
    else:
        model = MIMOResNet(num_channels=1, emb_dim=emb_dim, out_dim=out_dim, num_classes=10,
                           generator=generator).to(dev)
        schedule = constant_schedule(lr)
        optimizer = SGD(model.named_parameters(), schedule, momentum=momentum, weight_decay=wd)
        plateau = ReduceLROnPlateau(mode="min", factor=0.1, patience=lr_patience, threshold=1e-4)
        scheduler_metric = "val_loss"
    bundle = ModelBundle(
        model=model,
        loss_fn=model.compute_loss,
        data_forming=lambda gen, x, y, phase: data_forming_func(
            x, y, phase=phase, model_type=model_type, generator=gen),
        metric_fns=(("acc", partial(accuracy, dummy_dim=True)),),
        apply_fn=_seeded_dropout if transformer and dropout else None,
        diversity_kind=diversity,
        diversity_coef=diversity_coef,
    )
    size_fn = ((lambda x, y: len(y) * 4) if model_type == "single-model-weight-sharing"
               else None)
    return Setup(model, bundle, optimizer, schedule, plateau=plateau,
                 scheduler_metric=scheduler_metric, size_fn=size_fn)
