"""``data/loaders.py::prefetch_to_device`` and ``train --device_prefetch``
on the CPU (the pinned buffers and the side stream are held on the card in
``tests/test_torch_gpu.py``).

The prefetcher is the port of the JAX package's ``DevicePrefetcher``
(``data/loaders.py:195-236``): the same batches in the same order, a
producer thread that a consumer stopping early joins, a loader's exception
handed to the consumer. The trainer's ``move_batches`` takes it for batches
of ``PREFETCH_MIN_BYTES`` or more and ``steps.to_device`` one batch at a time
below; two CPU epochs of the MMBT train CLI with and without
``--device_prefetch``, and with the prefetcher forced, write the same history
(wall-clock columns aside).
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu_torch import train as port_train
from multimodal_uncertainty_tpu_torch.data.images import write_ppm
from multimodal_uncertainty_tpu_torch.data.loaders import (
    MapLoader,
    flat_batch,
    prefetch_to_device,
)
from multimodal_uncertainty_tpu_torch.training.loop import load_history
from multimodal_uncertainty_tpu_torch.training import trainer as port_trainer
from multimodal_uncertainty_tpu_torch.training.steps import to_device


def _batches(n=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = (rng.integers(0, 9, (4, 8 + i)), rng.random((4, 3, 3)).astype(np.float32),
             rng.integers(0, 256, (4, 2, 2, 3), dtype=np.uint8))
        if i % 2:  # ViLT's dict batches
            x = {"input_ids": x[0], "pixel_values": x[1], "pixel_mask": x[2] > 9}
        out.append((x, rng.integers(0, 3, 4)))
    return out


_flat = flat_batch


def test_yields_the_loaders_batches_in_order():
    batches = _batches()
    got = list(prefetch_to_device(batches, "cpu"))
    assert len(got) == len(batches)
    for g, want in zip(got, batches):
        assert type(g[0]) is type(want[0])
        for t, a in zip(_flat(g), _flat(want)):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), a)

    loader = MapLoader(list(range(10)), 3, lambda rows: ((np.asarray(rows),), np.asarray(rows)),
                       shuffle=True, seed=4)
    for (x, y), (xa, ya) in zip(prefetch_to_device(loader.iter_epoch(2), "cpu"),
                                loader.iter_epoch(2)):
        np.testing.assert_array_equal(x[0].numpy(), xa[0])


def test_a_consumer_that_stops_early_joins_the_thread():
    before = set(threading.enumerate())
    it = prefetch_to_device(_batches(8), "cpu")
    next(it)
    assert len(set(threading.enumerate()) - before) == 1  # the producer
    it.close()
    assert set(threading.enumerate()) - before == set()


def test_a_loader_exception_reaches_the_consumer():
    def failing():
        yield _batches(1)[0]
        raise ValueError("a corrupt image")

    before = set(threading.enumerate())
    it = prefetch_to_device(failing(), "cpu")
    next(it)
    with pytest.raises(ValueError, match="a corrupt image"):
        next(it)
    assert set(threading.enumerate()) - before == set()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", 0):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(prefetch_to_device(_batches(1), device))


def test_the_trainer_prefetches_batches_of_prefetch_min_bytes_or_more(monkeypatch):
    """``move_batches`` reads the first batch's bytes: at or above
    ``PREFETCH_MIN_BYTES`` every batch goes through the prefetcher, below it
    through ``steps.to_device`` on the consumer's thread; both yield the
    loader's batches in order, and an empty loader yields nothing."""
    batches = _batches()
    first = sum(a.nbytes for a in _flat(batches[0]))
    routes = []

    def counting(batches, device):
        routes.append("prefetch")
        yield from prefetch_to_device(batches, device)

    monkeypatch.setattr(port_trainer, "prefetch_to_device", counting)
    for threshold, want in ((first, ["prefetch"]), (first + 1, [])):
        monkeypatch.setattr(port_trainer, "PREFETCH_MIN_BYTES", threshold)
        routes.clear()
        got = list(port_trainer.move_batches(iter(batches), "cpu"))
        assert routes == want and len(got) == len(batches)
        for g, b in zip(got, batches):
            for t, a in zip(_flat(g), _flat(b)):
                np.testing.assert_array_equal(t.numpy(), a)
    assert list(port_trainer.move_batches([], "cpu")) == [] and routes == []


def _write_tree(root, rng, n=(8, 4, 4), labels=("pho", "ramen", "tacos")):
    """A Food-101 tree of 256x256 P6 images and a vocabulary with BERT's ids."""
    os.makedirs(os.path.join(root, "images"))
    words = [f"w{i}" for i in range(18)]
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(["[PAD]"] + [f"[unused{i}]" for i in range(99)]
                          + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    for split, count in zip(("train", "dev", "test"), n):
        with open(os.path.join(root, f"{split}.jsonl"), "w") as f:
            for i in range(count):
                name = f"images/{split}_{i}.ppm"
                write_ppm(os.path.join(root, name), rng.integers(0, 256, (256, 256, 3), np.uint8))
                f.write(json.dumps({"label": labels[i % len(labels)], "img": name, "text": " ".join(
                    rng.choice(words, size=int(rng.integers(2, 40))))}) + "\n")


def test_mmbt_train_cli_writes_the_same_history_with_device_prefetch(tmp_path, monkeypatch):
    """Two epochs (encoders frozen in the first, accumulation 2, dropout on
    the attention probabilities) with and without ``--device_prefetch`` (the
    tiny model's batches go one at a time through ``steps.to_device``), and
    with the prefetcher forced (``PREFETCH_MIN_BYTES`` 0): every history
    column but the wall-clock ones equal."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_tree(str(tmp_path / "data" / "food101"), np.random.default_rng(9))
    hist, moved = {}, {"plain": 0, "prefetch": 0}

    def counting(route, mover):
        def wrapped(*args):
            moved[route] += 1
            return mover(*args)
        return wrapped

    monkeypatch.setattr(port_trainer._steps, "to_device", counting("plain", to_device))
    monkeypatch.setattr(port_trainer, "prefetch_to_device",
                        counting("prefetch", prefetch_to_device))
    counts = {}
    for name, extra in (("flag", ["--device_prefetch"]), ("default", []), ("prefetch", [])):
        if name == "prefetch":
            monkeypatch.setattr(port_trainer, "PREFETCH_MIN_BYTES", 0)
        before = dict(moved)
        port_train.main([
            "--framework", "mmbt", "--dataset", "food101", "--tiny", "--device", "cpu",
            "--save_path", str(tmp_path / name), "--batch_size", "4",
            "--gradient_accumulation_steps", "2", "--freeze_img", "2", "--freeze_txt", "2",
            "--n_epochs", "2", "--lr", "1e-4", "--attention_probs_dropout", "0.1", *extra])
        hist[name] = load_history(str(tmp_path / name))
        counts[name] = {k: moved[k] - before[k] for k in moved}
    # train, dev and test loops of both epochs: 2 + 1 + 1 batches an epoch, one prefetcher a loop
    assert counts == {"flag": {"plain": 8, "prefetch": 0}, "default": {"plain": 8, "prefetch": 0},
                      "prefetch": {"plain": 0, "prefetch": 6}}
    assert hist["default"]["epoch"] == [1, 2]
    for col in hist["default"]:
        if col not in ("time", "epoch_begin_time"):
            assert hist["flag"][col] == hist["default"][col] == hist["prefetch"][col], col
