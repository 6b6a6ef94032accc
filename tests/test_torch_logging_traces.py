"""``out.log`` (``utils/logging_utils.py``) and the trace reader
(``utils/traces.py``) of the port (ports of ``tests/test_logging_utils.py``
and ``tests/test_trace_report.py``), on the CPU.

The trace tests read small hand-written traces in ``torch.profiler``'s Chrome
format: the card's process (``pid`` 0, named ``GPU 0``) with ``kernel`` /
``gpu_memcpy`` events on stream tracks and ``gpu_user_annotation`` ranges,
the host's process with ``cpu_op``, ``python_function`` and
``user_annotation`` events, and the profiler's own ``Trace`` span.
"""
import gzip
import json
import sys

import pytest
import torch

from multimodal_uncertainty_tpu_torch import train_fashionmnist
from multimodal_uncertainty_tpu_torch.utils import traces
from multimodal_uncertainty_tpu_torch.utils.logging_utils import TeeLog


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test processes share a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tee_captures_both_streams_and_restores(tmp_path, capsys):
    log = tmp_path / "out.log"
    out0, err0 = sys.stdout, sys.stderr
    with TeeLog(str(log)):
        print("to stdout")
        print("to stderr", file=sys.stderr)
        assert sys.stdout is not out0
    assert sys.stdout is out0 and sys.stderr is err0
    text = log.read_text()
    assert "to stdout" in text and "to stderr" in text
    cap = capsys.readouterr()  # a tee: the console saw everything too
    assert "to stdout" in cap.out and "to stderr" in cap.err


def test_tee_collapses_progress_repaints(tmp_path):
    log = tmp_path / "out.log"
    with TeeLog(str(log)):
        for i in range(50):
            sys.stdout.write(f"\rEpoch 1/1 Step {i}/49: loss 1.0")
        sys.stdout.write("\n")
        sys.stdout.write("\rval Step 1/2\rval Step 2/2\nEpoch 1/1 done\npartial")
    assert log.read_text().splitlines() == ["Epoch 1/1 Step 49/49: loss 1.0", "val Step 2/2",
                                            "Epoch 1/1 done", "partial"]


def test_tee_install_is_idempotent_and_appends(tmp_path):
    log = tmp_path / "out.log"
    t = TeeLog(str(log)).install()
    t.install()
    print("first run")
    t.uninstall()
    t.uninstall()
    with TeeLog(str(log)):
        print("second run")
    assert log.read_text().splitlines() == ["first run", "second run"]


def test_train_cli_writes_out_log_and_profile_trace(tmp_path, monkeypatch):
    """``train_fashionmnist --profile_dir --profile_epoch 1`` mirrors its
    console into save_path/out.log (final states only) and writes a
    ``torch.profiler`` trace of epoch 1's train batches that the reader takes:
    one ``train_step`` range a batch, and a busy time."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    save, prof = tmp_path / "run", tmp_path / "trace"
    train_fashionmnist.main(["--device", "cpu", "--synthetic", "--model_type", "MultiHead",
                             "--save_path", str(save), "--sample_size", "32", "--n_epochs", "2",
                             "--batch_size", "16", "--lr", "0.05", "--profile_dir", str(prof),
                             "--profile_epoch", "1"])
    text = (save / "out.log").read_text()
    assert "Epoch 1/1" in text and "Namespace(" in text and "\r" not in text
    events, pid_names = traces.load_events(str(prof))
    progs = traces.program_times(events, traces.device_pids(pid_names, events))
    assert progs["train_step"][1] == 2  # 32 samples at batch 16
    assert traces.step_program(progs)[0] == "train_step"
    assert traces.device_busy_ms(str(prof)) > 0


def _write_trace(tmp_path, events, name="run.pt.trace.json.gz"):
    d = tmp_path / "trace"
    d.mkdir(exist_ok=True)
    payload = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 4242, "tid": 0, "args": {"labels": "CPU"}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": "Spans",
         "tid": "PyTorch Profiler", "ts": -50, "dur": 10000},
        {"ph": "s", "cat": "ac2g", "name": "flow", "pid": 4242, "tid": 1, "ts": 0, "id": 1},
        *events,
    ]}
    with gzip.open(d / name, "wt") as fh:
        json.dump(payload, fh)
    return str(d)


def _kernel(name, ts, dur, tid=7, cat="kernel", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def test_self_time_subtracts_nested_children(tmp_path):
    """A range [0, 100] over kernels [10, 40] and [50, 70] on one stream: the
    kernels keep their time, the range is not an operation, the busy union is
    the kernels' 50 µs."""
    events = [_kernel("train_step", 0, 100, cat="gpu_user_annotation"),
              _kernel("attention_fwd_256_kernel", 10, 30),
              _kernel("ampere_sgemm", 50, 20)]
    td = _write_trace(tmp_path, events)
    ev, names = traces.load_events(td)
    assert traces.device_pids(names, ev) == {0}
    agg, busy = traces.self_times(ev, {0})
    assert agg == {"attention_fwd_256_kernel": (30.0, 1), "ampere_sgemm": (20.0, 1)}
    assert busy == pytest.approx(50.0)
    assert traces.device_busy_ms(td) == pytest.approx(0.05)
    nested = [{"ph": "X", "cat": "cpu_op", "name": "aten::matmul", "pid": 4242, "tid": 1,
               "ts": 0, "dur": 100},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242, "tid": 1, "ts": 10,
               "dur": 30}]
    agg, busy = traces.self_times(nested, {4242})
    assert agg == {"aten::matmul": (70.0, 1), "aten::mm": (30.0, 1)} and busy == 100.0


def test_host_frames_and_ranges_excluded_and_union_across_streams(tmp_path):
    events = [{"ph": "X", "cat": "python_function", "name": "train.py(12): step", "pid": 4242,
               "tid": 1, "ts": 0, "dur": 1000},
              {"ph": "X", "cat": "user_annotation", "name": "train_step", "pid": 4242, "tid": 1,
               "ts": 0, "dur": 900},
              _kernel("conv", 0, 60, tid=7), _kernel("dot", 40, 60, tid=8),
              _kernel("Memcpy HtoD (Pinned -> Device)", 120, 10, tid=9, cat="gpu_memcpy",
                      bytes=4096),
              _kernel("train_step", 0, 130, tid=7, cat="gpu_user_annotation"),
              _kernel("train_step", 200, 70, tid=7, cat="gpu_user_annotation"),
              _kernel("eval_step", 300, 10, tid=7, cat="gpu_user_annotation")]
    td = _write_trace(tmp_path, events)
    ev, names = traces.load_events(td)
    agg, busy = traces.self_times(ev, {0})
    assert set(agg) == {"conv", "dot", "Memcpy HtoD (Pinned -> Device)"}
    assert busy == pytest.approx(110.0)  # [0, 100] across two streams, and the copy
    assert traces.category_times(ev, {0}) == {"kernel": (120.0, 0), "gpu_memcpy": (10.0, 4096)}
    progs = traces.program_times(ev, {0})
    assert progs == {"train_step": (200.0, 2), "eval_step": (10.0, 1)}
    assert traces.step_program(progs) == ("train_step", pytest.approx(0.1))
    assert traces.step_program({"forward": (5.0, 1)}) is None
    host_agg, _ = traces.self_times(ev, {4242})
    assert host_agg == {}  # only frames and ranges there


def test_cpu_trace_reads_every_process_and_missing_dir_raises(tmp_path):
    td = tmp_path / "cpu"
    td.mkdir()
    payload = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 7, "tid": 0, "args": {"name": "python"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 7, "tid": 1, "ts": 0, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 7, "tid": 2, "ts": 3, "dur": 5},
    ]}
    (td / "x.pt.trace.json").write_text(json.dumps(payload))
    ev, names = traces.load_events(str(td))
    assert traces.device_pids(names, ev) == {7}
    assert traces.device_busy_ms(str(td)) == pytest.approx(0.008)
    assert traces.union_us([(5, 9), (0, 3), (2, 4)]) == 8.0
    with pytest.raises(FileNotFoundError, match="profile_epoch"):
        traces.load_events(str(tmp_path / "nothing"))
