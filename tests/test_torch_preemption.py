"""Preemption and mid-epoch checkpoints in the port (ports of
``tests/test_preemption.py``'s cases), on the CPU.

The property is exactness: a run stopped mid-epoch (``model_midtrain.pt``)
and resumed in a fresh trainer ends with the same parameters, BatchNorm
statistics, optimizer state and history.csv as an uninterrupted run, bit for
bit. It needs the whole train state in the file, loaders that re-derive an
epoch's order from (seed, epoch) and start at any batch, step randomness that
is a function of (seed, epoch, batch), and the epoch's running sums carried
over (added batch by batch in float64, so the means are equal bit for bit
too). Also: the SIGTERM handler of both CLIs, the asynchronous checkpoint
writer, and the prefetcher's thread on a preempted epoch.
"""
import os
import shutil
import signal
import threading

import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu_torch import train as port_train
from multimodal_uncertainty_tpu_torch import train_fashionmnist
from multimodal_uncertainty_tpu_torch.data.fmnist import get_fmnist
from multimodal_uncertainty_tpu_torch.data.loaders import ArrayLoader, MapLoader
from multimodal_uncertainty_tpu_torch.models.bert import BertConfig
from multimodal_uncertainty_tpu_torch.training import checkpoint, steps
from multimodal_uncertainty_tpu_torch.training import trainer as trainer_module
from multimodal_uncertainty_tpu_torch.training.callbacks import Callback
from multimodal_uncertainty_tpu_torch.training.loop import (
    construct_default_callbacks,
    load_history,
    resume_midtrain_state,
)
from multimodal_uncertainty_tpu_torch.training.preemption import PreemptionGuard
from multimodal_uncertainty_tpu_torch.training.trainer import Trainer
from multimodal_uncertainty_tpu_torch.utils import traces
from multimodal_uncertainty_tpu_torch.zoo import setup_fashionmnist, setup_mmbt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test processes share a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_array_loader_iter_epoch_deterministic():
    x, y = np.arange(20).reshape(20, 1), np.arange(20)
    ld = ArrayLoader([x, y], batch_size=4, shuffle=True, seed=3)
    a = [b[1].tolist() for b in ld.iter_epoch(5)]
    assert a == [b[1].tolist() for b in ld.iter_epoch(5)]  # a function of the epoch
    assert a != [b[1].tolist() for b in ld.iter_epoch(6)]
    assert [b[1].tolist() for b in ld.iter_epoch(5, start_batch=2)] == a[2:]
    ld2 = ArrayLoader([x, y], batch_size=4, shuffle=True, seed=3)
    assert [b[1].tolist() for b in ld2] == [b[1].tolist() for b in ld.iter_epoch(0)]


def test_map_loader_iter_epoch_deterministic():
    class DS:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return i

    ld = MapLoader(DS(), 3, collate_fn=list, shuffle=True, seed=1, prefetch=0)
    a = list(ld.iter_epoch(2))
    assert a == list(ld.iter_epoch(2))
    assert list(ld.iter_epoch(2, start_batch=1)) == a[1:]
    threaded = MapLoader(DS(), 3, collate_fn=list, shuffle=True, seed=1, prefetch=2)
    assert list(threaded.iter_epoch(2, start_batch=3)) == a[3:]


def test_sigterm_sets_guard_and_uninstall_restores():
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard().install(signals=(signal.SIGTERM,))
    try:
        assert not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered
        guard.clear()
        assert not guard.triggered
        guard.request()
        assert guard.triggered
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before


class _TriggerAt(Callback):
    """Requests preemption after the given (epoch, batch) boundary."""

    def __init__(self, guard, epoch, batch):
        self.guard, self.epoch_at, self.batch_at, self._epoch = guard, epoch, batch, None

    def on_epoch_begin(self, epoch, logs):
        self._epoch = epoch

    def on_batch_end(self, batch, logs):
        if self._epoch == self.epoch_at and batch == self.batch_at:
            self.guard.request()


def _fmnist_run(save_dir, H, extra_callbacks=()):
    train, valid, _ = get_fmnist(batch_size=16, synthetic=True, synthetic_n=64, seed=7)
    setup = setup_fashionmnist(model_type="MultiHead", lr=0.05, seed=1, device="cpu")
    callbacks = construct_default_callbacks(H, str(save_dir)) + list(extra_callbacks)
    trainer = Trainer(setup.bundle, setup.optimizer, seed=2, plateau=setup.plateau,
                      size_fn=setup.size_fn, verbose=False)
    kw = dict(valid_generator=valid, test_generator=valid, steps_per_epoch=len(train),
              validation_steps=len(valid), test_steps=len(valid), epochs=3,
              callbacks=callbacks, scheduler_metric=setup.scheduler_metric)
    return trainer, setup, train, kw


def _state(trainer, setup):
    opt = setup.optimizer.state_dict()
    return {**{f"model.{k}": v for k, v in setup.model.state_dict().items()},
            **{f"opt.{k}": v for k, v in _flat(opt).items()},
            "lr_scale": torch.tensor(setup.optimizer.lr_scale)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: torch.as_tensor(tree)}


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _assert_same_history(dir_a, dir_b, n):
    ha, hb = load_history(str(dir_a)), load_history(str(dir_b))
    assert len(ha["epoch"]) == len(hb["epoch"]) == n
    for col in ha:
        if "time" not in col:
            assert ha[col] == hb[col], col


def _preempt_then_resume(tmp_path, epoch, batch, uninterrupted=True, **resume_kw):
    """Run A uninterrupted (unless not ``uninterrupted``); run B preempted
    after (epoch, batch), then resumed from its model_midtrain.pt in a fresh
    trainer. Returns the two final states, the two directories and the mid
    blob."""
    dir_a, dir_b = tmp_path / "a", tmp_path / "b"
    dir_a.mkdir()
    dir_b.mkdir()
    a = None
    if uninterrupted:
        tr_a, setup_a, train, kw = _fmnist_run(dir_a, {})
        tr_a.train_loop(train, **kw)
        a = _state(tr_a, setup_a)

    guard = PreemptionGuard()
    mid_path = str(dir_b / "model_midtrain.pt")
    tr_b, _, train_b, kw_b = _fmnist_run(dir_b, {}, [_TriggerAt(guard, epoch, batch)])
    tr_b.train_loop(train_b, **kw_b, preemption=guard, midtrain_path=mid_path)
    assert tr_b.preempted and os.path.exists(mid_path)
    assert load_history(str(dir_b))["epoch"] == list(range(1, epoch))

    tr_c, setup_c, train_c, kw_c = _fmnist_run(dir_b, load_history(str(dir_b)))
    mid = resume_midtrain_state(setup_c.model, setup_c.optimizer, mid_path,
                                plateau=setup_c.plateau)
    tr_c.train_loop(train_c, **{**kw_c, **resume_kw}, epoch_start=epoch, resume_mid=mid,
                    midtrain_path=mid_path)
    assert not tr_c.preempted
    return a, _state(tr_c, setup_c), dir_a, dir_b, mid


def test_midepoch_preempt_resume_is_exact(tmp_path):
    """Preempted at epoch 2 batch 2 of 3 epochs: the resumed run's
    parameters, BatchNorm statistics, SGD momentum, plateau scale and
    history.csv equal the uninterrupted run's bit for bit; the completed
    epoch removed the mid-epoch file."""
    a, c, dir_a, dir_b, mid = _preempt_then_resume(tmp_path, 2, 2)
    assert (int(mid["epoch"]), int(mid["next_batch"])) == (2, 2)
    assert set(mid) == {"epoch", "next_batch", "loss_sum", "metric_sums", "size_sum",
                        "acc100_counter"}
    _assert_same(a, c)
    _assert_same_history(dir_a, dir_b, 3)
    checkpoint.flush_pending_writes()
    assert not os.path.exists(dir_b / "model_midtrain.pt")


def test_preempt_at_last_batch_resumes_through_evals(tmp_path):
    """The signal on an epoch's last batch: the train phase is complete, so
    the file has next_batch = the epoch's steps, epoch 2's history row is
    not written, and the resumed run runs only that epoch's evals and
    callbacks before epoch 3, bit for bit as the uninterrupted run."""
    a, c, dir_a, dir_b, mid = _preempt_then_resume(tmp_path, 2, 4)
    assert int(mid["next_batch"]) == 4  # 64 samples at batch 16
    _assert_same(a, c)
    _assert_same_history(dir_a, dir_b, 3)


def test_resume_into_profiled_epoch_with_no_batches_left(tmp_path):
    """Resumed into the profiled epoch with no batch left: the profiler
    starts and stops around an empty loop, the run completes and the trace
    is written (and readable)."""
    prof = tmp_path / "trace"
    _, _, _, dir_b, _ = _preempt_then_resume(tmp_path, 2, 4, uninterrupted=False,
                                             profile_dir=str(prof), profile_epoch=2)
    assert load_history(str(dir_b))["epoch"] == [1, 2, 3]
    assert os.path.exists(prof / "epoch_2.pt.trace.json.gz")
    events, _ = traces.load_events(str(prof))
    assert all(e.get("name") != "train_step" for e in events)  # no train batch in it


def test_periodic_midtrain_checkpoint(tmp_path):
    """``checkpoint_every_steps`` writes the file during the epoch (a
    resumable one, batch 2's); the epoch's end removes it."""
    mid_path = str(tmp_path / "model_midtrain.pt")
    seen = []

    class _Watch(Callback):
        def on_batch_end(self, batch, logs):
            if batch == 3:
                checkpoint.flush_pending_writes()
                seen.append(os.path.exists(mid_path)
                            and int(checkpoint.load_weights(mid_path)[1]["mid"]["next_batch"]))

    tr, _, train, kw = _fmnist_run(tmp_path, {}, [_Watch()])
    tr.train_loop(train, **{**kw, "epochs": 2}, midtrain_path=mid_path, checkpoint_every_steps=2)
    assert seen == [2, 2]
    assert not os.path.exists(mid_path)  # the loop flushed its queue: removed after each epoch


def test_resume_midtrain_rejects_plain_checkpoint(tmp_path):
    tr, setup, train, kw = _fmnist_run(tmp_path, {})
    tr.train_loop(train, **{**kw, "epochs": 1})
    fresh = setup_fashionmnist(model_type="MultiHead", lr=0.05, seed=5, device="cpu")
    before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    with pytest.raises(ValueError, match="not a mid-epoch checkpoint"):
        resume_midtrain_state(fresh.model, fresh.optimizer, str(tmp_path / "model_last_epoch.pt"))
    _assert_same(before, fresh.model.state_dict())  # refused before the model was touched


class _ListLoader:
    """A fixed list of batches with ``iter_epoch`` (no shuffle)."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def iter_epoch(self, epoch, start_batch=0):
        return iter(self.batches[start_batch:])


def test_midepoch_preempt_resume_exact_with_accumulation(tmp_path):
    """Preempted inside an open gradient-accumulation window of the tiny
    MMBT (BatchNorm, BertAdam, attention-probability dropout 0.1 on its
    explicit generator) while the freeze schedule switches between epochs:
    the accumulated gradients, the micro-step count, BertAdam's moments and
    per-parameter steps, the BatchNorm statistics and the dropout masks all
    carry over, and the resumed run equals the uninterrupted one bit for
    bit."""
    cfg = BertConfig(vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=64, max_position_embeddings=64,
                     attention_probs_dropout_prob=0.1)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(4):
        mask = np.ones((8, 6), np.int64)
        batches.append(((rng.integers(104, 200, size=(8, 6)), mask, mask.copy(),
                         rng.integers(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)),
                        rng.integers(0, 5, size=8)))
    train = _ListLoader(batches)

    def run(trigger=None, mid_path=None, mid=None, epoch_start=1):
        setup = setup_mmbt(n_classes=5, bert_config=cfg, resnet_layers=(1, 1, 1, 1),
                           gradient_accumulation_steps=2, lr=1e-3, warmup=0.0, seed=0,
                           device="cpu")
        if mid_path is not None and mid is None and trigger is None:
            mid = resume_midtrain_state(setup.model, setup.optimizer, mid_path,
                                        accumulator=setup.accumulator, plateau=setup.plateau)
        tr = Trainer(setup.bundle, setup.optimizer, seed=5, plateau=None,
                     accumulator=setup.accumulator, verbose=False)
        guard = PreemptionGuard()
        tr.train_loop(train, steps_per_epoch=4, epochs=2, freeze_img=2, freeze_txt=0,
                      callbacks=[] if trigger is None else [_TriggerAt(guard, *trigger)],
                      preemption=guard, midtrain_path=mid_path, resume_mid=mid,
                      epoch_start=epoch_start)
        return tr, setup, mid

    tr_a, setup_a, _ = run()
    mid_path = str(tmp_path / "model_midtrain.pt")
    tr_b, _, _ = run(trigger=(2, 3), mid_path=mid_path)
    assert tr_b.preempted
    _, opt = checkpoint.load_weights(mid_path)
    assert int(opt["mid"]["next_batch"]) == 3 and int(opt["step"]) == 7
    assert sum(float(g.abs().sum()) for g in opt["accum_grads"].values()) > 0  # window open
    tr_c, setup_c, mid = run(mid_path=mid_path, epoch_start=2)
    assert int(mid["epoch"]) == 2
    _assert_same(_state(tr_a, setup_a), _state(tr_c, setup_c))
    _assert_same({k: v for k, v in setup_a.accumulator.grads.items()},
                 {k: v for k, v in setup_c.accumulator.grads.items()})
    assert setup_a.accumulator.step == setup_c.accumulator.step == 8


def test_preempted_epoch_stops_the_prefetcher_thread(tmp_path, monkeypatch):
    """The batches through the prefetcher (its threshold at 0 bytes): a
    preempted epoch closes it, so no loader thread outlives the loop."""
    monkeypatch.setattr(trainer_module, "PREFETCH_MIN_BYTES", 0)
    guard = PreemptionGuard()
    tr, _, train, kw = _fmnist_run(tmp_path, {}, [_TriggerAt(guard, 1, 1)])
    before = set(threading.enumerate())
    tr.train_loop(train, **kw, preemption=guard, midtrain_path=str(tmp_path / "m.pt"))
    assert tr.preempted
    left = [t for t in threading.enumerate() if t not in before and t.is_alive()
            and not t.name.startswith("checkpoint-writer")]
    assert left == []


def test_async_checkpoint_writes_own_copies_in_order(tmp_path):
    """``save_weights`` returns before the file is written, with a copy of
    its own: an in-place update right after it does not reach the file.
    ``enqueue_after_writes`` runs after the writes queued before it, and
    ``load_weights`` waits for a queued write of its file."""
    p = torch.nn.Parameter(torch.ones(1000))
    path = str(tmp_path / "w.pt")
    checkpoint.save_weights({"p": p}, {"step": torch.tensor(1)}, path)
    with torch.no_grad():
        p.add_(1.0)
    order = []
    checkpoint.enqueue_after_writes(lambda: order.append(os.path.exists(path)))
    model_sd, opt = checkpoint.load_weights(path)
    assert torch.equal(model_sd["p"], torch.ones(1000)) and int(opt["step"]) == 1
    checkpoint.flush_pending_writes()
    assert order == [True]
    checkpoint.save_weights({"p": p}, None, path, async_write=False)
    assert torch.equal(torch.load(path, weights_only=True)["model"]["p"], p.detach())


def _signal_at(monkeypatch, step_no):
    """SIGTERM this process from inside the ``step_no``-th train step, as a
    scheduler would mid-run."""
    real, calls = steps.train_step, []

    def stepping(*args, **kwargs):
        calls.append(1)
        if len(calls) == step_no:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*args, **kwargs)

    monkeypatch.setattr(steps, "train_step", stepping)
    return lambda: monkeypatch.setattr(steps, "train_step", real)


def test_fashionmnist_cli_sigterm_then_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    """``train_fashionmnist`` takes SIGTERM in its 6th step (epoch 2, batch 2
    of 4): it returns with ``model_midtrain.pt`` and out.log; ``--resume``
    continues from batch 3 and ends where an uninterrupted run ends, bit for
    bit (weights, history)."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    argv = ["--device", "cpu", "--synthetic", "--sample_size", "64", "--batch_size", "16",
            "--model_type", "MultiHead", "--n_epochs", "4", "--lr", "0.05"]
    whole = train_fashionmnist.main(argv + ["--save_path", str(tmp_path / "whole")])
    restore = _signal_at(monkeypatch, 6)
    cut = train_fashionmnist.main(argv + ["--save_path", str(tmp_path / "cut")])
    restore()
    assert cut.preempted and os.path.exists(tmp_path / "cut" / "model_midtrain.pt")
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL  # the CLI put it back
    resumed = train_fashionmnist.main(argv + ["--save_path", str(tmp_path / "cut"), "--resume"])
    assert not resumed.preempted
    _assert_same(whole.bundle.model.state_dict(), resumed.bundle.model.state_dict())
    _assert_same_history(tmp_path / "whole", tmp_path / "cut", 3)
    log = (tmp_path / "cut" / "out.log").read_text()
    assert "Preempted at epoch 2 batch 2" in log and "Epoch 3/3" in log and "\r" not in log


def test_flava_cli_sigterm_with_periodic_checkpoints_then_resume(tmp_path, monkeypatch):
    """The FLAVA train CLI with ``--checkpoint_every_steps 2``: SIGTERM in
    step 2 stops it at that boundary; ``--resume`` continues epoch 1 at
    batch 3 and the run ends equal to an uninterrupted one bit for bit. A
    mid-epoch file of an epoch that history.csv has finished is stale and
    ignored."""
    from tests.test_torch_training import _cli, _write_shards

    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    _write_shards(str(tmp_path / "data" / "hateful-meme-dataset"))
    args = ["--device", "cpu", "--n_epochs", "2", "--checkpoint_every_steps", "2"]
    whole = port_train.main(_cli(tmp_path / "w", *args)).bundle.model.state_dict()
    whole_history = load_history(str(tmp_path / "w" / "run"))
    shutil.rmtree(tmp_path / "w")  # 768-wide checkpoints: keep the test's disk use small
    restore = _signal_at(monkeypatch, 2)
    cut = port_train.main(_cli(tmp_path / "c", *args))
    restore()
    run = tmp_path / "c" / "run"
    assert cut.preempted
    mid = checkpoint.load_weights(str(run / "model_midtrain.pt"))[1]["mid"]
    assert (int(mid["epoch"]), int(mid["next_batch"])) == (1, 2)
    resumed = port_train.main(_cli(tmp_path / "c", *args, "--resume"))
    _assert_same(whole, resumed.bundle.model.state_dict())
    history = load_history(str(run))
    assert history["epoch"] == whole_history["epoch"] == [1, 2]
    for col in history:
        if "time" not in col:
            assert history[col] == whole_history[col], col
    assert not os.path.exists(run / "model_midtrain.pt")

    stale = checkpoint.load_weights(str(run / "model_last_epoch.pt"))
    stale[1]["mid"] = mid  # epoch 1's, which history.csv has finished
    checkpoint.save_weights(stale[0], stale[1], str(run / "model_midtrain.pt"))
    again = port_train.main(_cli(tmp_path / "c", "--device", "cpu", "--n_epochs", "3",
                                 "--resume"))
    assert load_history(str(run))["epoch"] == [1, 2, 3] and not again.preempted
    shutil.rmtree(run)
