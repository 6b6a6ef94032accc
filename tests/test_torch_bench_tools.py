"""The port's two microbenchmarks, ``tools/bench_flash.py`` and
``tools/bench_dw.py`` of ``multimodal_uncertainty_tpu_torch``, run end to end
on the CPU (``--device cpu``, the plain route) at toy sizes: their rows,
their inputs and their failure rules. Their times mean nothing here; the
card's numbers come from ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from multimodal_uncertainty_tpu_torch.ops import attention as A
from multimodal_uncertainty_tpu_torch.tools import bench_attention, bench_dw, bench_flash

FLASH_ARGS = ["--d", "128", "--dh", "64", "--tokens", "512", "--seqs", "128,256,200",
              "--iters", "1", "--device", "cpu"]
FLASH_ROWS = ("plain_fwd", "flash_fwd", "plain_train", "flash_train")


def _timed(entry):
    return isinstance(entry, dict) and entry["ms"] > 0 and entry["tf_s"] > 0


def test_bench_flash_rows(capsys):
    """One row per S with B * S held at --tokens (B = max(1, tokens // S)),
    H = D / Dh, and a time for each of the four rows; one JSON line each."""
    rows = bench_flash.main(FLASH_ARGS)
    assert [(r["S"], r["B"], r["H"], r["Dh"]) for r in rows] == [
        (128, 4, 2, 64), (256, 2, 2, 64), (200, 2, 2, 64)]
    for r in rows:
        assert all(_timed(r[label]) for label in FLASH_ROWS), r
        for label in FLASH_ROWS:  # the kernels' counters move only on the card
            assert r[label]["launches"] == {"attention_fwd_cuda": 0, "attention_bwd_cuda": 0}
    assert len(capsys.readouterr().out.strip().splitlines()) == 3


def test_bench_flash_defaults_are_the_jax_tools():
    args = bench_flash.parse_args([])
    assert (args.iters, args.dh, args.d, args.tokens, args.seqs, args.device) == (
        10, 64, 768, 16384, "512,1024,2048,4096,8192,16384", None)


def test_bench_flash_inputs_and_mask(monkeypatch):
    """The flash rows get bf16 q, k, v of (B, S, D) and the JAX tool's mask:
    the first half of the batch has its last fifth of keys masked."""
    seen = []
    flash = A.attention_flash

    def spy(q, k, v, key_mask, *, n_head):
        seen.append((q.dtype, tuple(q.shape), key_mask.clone(), n_head))
        return flash(q, k, v, key_mask, n_head=n_head)

    monkeypatch.setattr(A, "attention_flash", spy)
    bench_flash.main(["--d", "128", "--dh", "64", "--tokens", "1024", "--seqs", "256",
                      "--iters", "1", "--device", "cpu"])
    dtype, shape, mask, n_head = seen[0]
    assert (dtype, shape, n_head) == (torch.bfloat16, (4, 256, 128), 2)
    want = np.ones((4, 256), bool)
    want[:2, 204:] = False
    assert np.array_equal(mask.numpy(), want)


def test_bench_flash_records_a_plain_failure_and_raises_a_flash_one(monkeypatch):
    """A plain row that fails (out of memory at long S on the card) is
    recorded in its row and the run goes on; a flash row's failure ends it."""
    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 12.00 GiB")

    monkeypatch.setattr(bench_flash, "_plain", oom)  # the plain rows only
    rows = bench_flash.main(FLASH_ARGS[:-4] + ["--seqs", "128", "--iters", "1", "--device",
                                                "cpu"])
    assert rows[0]["plain_fwd"].startswith("OutOfMemoryError: CUDA out of memory")
    assert rows[0]["plain_train"].startswith("OutOfMemoryError")
    assert _timed(rows[0]["flash_fwd"]) and _timed(rows[0]["flash_train"])

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(A, "attention_flash", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bench_flash.main(FLASH_ARGS)


def test_bench_dw_rows(monkeypatch):
    """The four rows, timed; the kernel row goes through ``weight_grad`` (the
    plain dW on the CPU), once for the warm-up and --iters times."""
    calls = []
    weight_grad = bench_dw.weight_grad

    def counting(x, dy):
        calls.append((x.dtype, tuple(x.shape), tuple(dy.shape)))
        return weight_grad(x, dy)

    monkeypatch.setattr(bench_dw, "weight_grad", counting)
    rows = bench_dw.main(["--k", "512", "--din", "128", "--dout", "256", "--iters", "2",
                          "--device", "cpu"])
    assert list(rows) == ["fwd_ref", "plain", "plain_pre_t", "kernel"]
    assert all(_timed(r) for r in rows.values())
    assert calls == [(torch.bfloat16, (512, 128), (512, 256))] * 3


def test_bench_dw_defaults_are_the_jax_tools():
    args = bench_dw.parse_args([])
    assert (args.k, args.din, args.dout, args.iters, args.device) == (70144, 768, 3072, 30, None)


def test_bench_dw_yardsticks_compute_the_kernels_product():
    """``plain`` is x^T dy and the kernel row's dW is its transpose, torch's
    (Dout, Din) weight layout; both in fp32."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32)).bfloat16()
    plain = bench_dw.mm_f32(x.t(), dy)
    assert plain.dtype == torch.float32 and plain.shape == (128, 256)
    torch.testing.assert_close(bench_dw.weight_grad(x, dy), plain.t(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("tool", [bench_flash, bench_dw, bench_attention])
def test_tools_run_on_the_card_by_default(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


NO_LAUNCHES = {"attention_fwd_cuda": 0, "attention_fwd_dropout_cuda": 0, "attention_bwd_cuda": 0,
               "attention_bwd_dropout_cuda": 0}


def test_bench_attention_rows(capsys):
    """One JSON line a row, each timed beside the library call with its
    bound; the counters (all launches, the bf16 and the split-fp32
    tensor-core routes') move only on the card."""
    rows = bench_attention.main(["--rows", "fwd:bfloat16:2:40:64:k4,bwd:float32:3:33:384:ragged,"
                                 "bwd:bfloat16:1:17:768:none,bwd_dropout:float32:2:21:64:ragged,"
                                 "fwd_dropout:float32:2:21:64:ragged",
                                 "--iters", "1", "--device", "cpu"])
    assert [(r["pass"], r["dtype"], r["B"], r["S"], r["Dh"], r["H"]) for r in rows] == [
        ("fwd", "bfloat16", 2, 40, 64, 12), ("bwd", "float32", 3, 33, 384, 2),
        ("bwd", "bfloat16", 1, 17, 768, 1), ("bwd_dropout", "float32", 2, 21, 64, 12),
        ("fwd_dropout", "float32", 2, 21, 64, 12)]
    for r in rows:
        assert r["ms"] > 0 and r["library_ms"] > 0 and r["bound_ms"] > 0 and r["device"] == "cpu"
        assert r["launches"] == r["launches_tc"] == r["launches_tc32"] == NO_LAUNCHES
    assert len(capsys.readouterr().out.strip().splitlines()) == 5


def test_bench_attention_fwd_dropout_row_runs_the_plain_dropout_forward(monkeypatch):
    """A ``fwd_dropout`` row on the CPU times ``attention_probs_dropout`` at
    rate 0.1 with the keep mask drawn from ``manual_seed(S)`` (uint8 (B, H, S,
    S)), beside SDPA with ``dropout_p``; its bytes count the keep mask."""
    seen = []
    real = A.attention_probs_dropout

    def spy(q, k, v, key_mask=None, *, n_head, rate, keep=None):
        seen.append((rate, keep.dtype, tuple(keep.shape), n_head))
        return real(q, k, v, key_mask, n_head=n_head, rate=rate, keep=keep)

    monkeypatch.setattr(A, "attention_probs_dropout", spy)
    (r,) = bench_attention.main(["--rows", "fwd_dropout:float32:2:21:96:none", "--iters", "1",
                                 "--device", "cpu"])
    assert seen and set(seen) == {(0.1, torch.uint8, (2, 8, 21, 21), 8)}
    flops, nbytes = 4 * 2 * 21 * 21 * 768, 4 * 2 * 21 * 768 * 4 + 2 * 8 * 21 * 4 + 2 * 8 * 21 * 21
    assert r["fma_bound_ms"] == pytest.approx(max(flops / 67e12, nbytes / 3.35e12) * 1e3)
    assert r["tc32_bound_ms"] == pytest.approx(max(3 * flops / 495e12, nbytes / 3.35e12) * 1e3)
    assert r["bound_ms"] == pytest.approx(r["tc32_bound_ms"])


@pytest.mark.parametrize("dh,split", [(64, True), (192, True), (256, False), (768, False)])
def test_bench_attention_fp32_forward_row_takes_the_bound_of_its_route(dh, split):
    """An fp32 ``fwd`` row carries both bounds, and its ``bound_ms`` is that of
    the kernel ``fwd_source`` routes it to: the split-fp32 one at Dh 24-192,
    the FMA units' one at Dh 256-768 (micro-tiles and clusters)."""
    (r,) = bench_attention.main(["--rows", f"fwd:float32:1:128:{dh}:none", "--iters", "1",
                                 "--device", "cpu"])
    assert A.fwd_source(torch.float32, dh, False).startswith("attention_fwd_tc32") == split
    assert r["tc32_bound_ms"] < r["fma_bound_ms"]
    assert r["bound_ms"] == pytest.approx(r["tc32_bound_ms" if split else "fma_bound_ms"])


def test_bench_attention_defaults_are_the_redesigned_rows():
    parsed = [bench_attention.parse_row(r) for r in bench_attention.parse_args([]).rows.split(",")]
    rows = [r for r in parsed if r["pass"] not in ("dw", "ln")]
    assert {(r["dtype"], r["K"], r["Din"], r["Dout"]) for r in parsed if r["pass"] == "dw"} >= {
        (torch.float32, 5920, din, dout)
        for din, dout in ((768, 3072), (3072, 768), (768, 2304), (768, 768))}
    assert {(r["dtype"], r["rows"], r["D"]) for r in parsed if r["pass"] == "ln"} == {
        (dtype, rows, 768) for dtype in (torch.float32, torch.bfloat16) for rows in (10240, 40960)}
    assert {(r["pass"], r["dtype"], r["S"], r["Dh"]) for r in rows} >= {
        ("fwd", torch.bfloat16, 16384, 64), ("fwd", torch.bfloat16, 165, 64),
        ("bwd", torch.float32, 320, 768), ("bwd", torch.float32, 320, 384),
        ("bwd", torch.bfloat16, 320, 768), ("bwd", torch.bfloat16, 320, 384),
        ("fwd", torch.float32, 320, 768), ("fwd", torch.float32, 320, 384),
        ("fwd", torch.bfloat16, 320, 768), ("fwd", torch.bfloat16, 320, 384),
        ("bwd", torch.float32, 320, 256), ("bwd", torch.bfloat16, 320, 256),
        ("bwd", torch.float32, 736, 256), ("step", torch.float32, 320, 256),
        ("fwd", torch.float32, 320, 256), ("fwd", torch.bfloat16, 320, 256),
        ("bwd", torch.float32, 165, 64), ("bwd", torch.float32, 185, 64),
        ("bwd_dropout", torch.float32, 165, 64),
        ("bwd", torch.float32, 320, 24), ("bwd", torch.float32, 320, 48),
        ("bwd", torch.float32, 320, 96), ("bwd", torch.float32, 320, 192),
        ("bwd", torch.bfloat16, 320, 96)}
    shapes = {(r["pass"], r["dtype"], r["B"], r["S"], r["Dh"], r["mask"]) for r in rows}
    # the split-fp32 forward's rows: MMBT's S=165 and 517 (with dropout too), ViLT's S=185,
    # FLAVA's S=320 at the other head dims of 24-192
    assert {("fwd", torch.float32, 32, s, 64, "ragged") for s in (165, 517, 185)} | {
        ("fwd_dropout", torch.float32, 32, 165, 64, "ragged")} | {
        ("fwd", torch.float32, 32, 320, dh, "ragged") for dh in (24, 48, 96, 128, 192)} <= shapes
    # the fp32 dW at K = 32-128 on its route and on both kernels
    kernels = {(r["K"], r["Din"], r["Dout"], r.get("kernel")) for r in parsed
               if r["pass"] == "dw" and r["dtype"] == torch.float32}
    assert {(k, 768, 768, kernel) for k in (32, 64, 96, 128)
            for kernel in (None, "tc32", "simt")} <= kernels
    assert {("bwd", torch.float32, 32, 165, 64, "ragged"), ("bwd", torch.float32, 32, 185, 64,
            "ragged"), ("fwd", torch.bfloat16, 32, 320, 256, "ragged")} <= shapes
    assert {("bwd", dtype, 128, 320, dh, "none") for dtype, dh in (
        (torch.float32, 24), (torch.float32, 48), (torch.float32, 96), (torch.float32, 192),
        (torch.bfloat16, 96))} <= shapes
    # the bf16 backward on the tensor cores: K6's shape at 8 heads, FLAVA's long text at 3, MMBT's
    # Dh=64, and the bf16 train step they serve
    assert {("bwd", torch.bfloat16, 32, 320, 96, "none"), ("bwd", torch.bfloat16, 128, 736, 256,
            "none"), ("bwd", torch.bfloat16, 32, 165, 64, "ragged"),
            ("step", torch.bfloat16, 128, 320, 256, "none")} <= shapes
    # the bf16 forward on the tensor cores at Dh 256 (FLAVA's --bf16 training at S = 320 and
    # 736) and 96 (8 heads), the bf16 step at S = 736, and the bf16 rows still on the FMA units
    # at Dh 24, 48 and 192 in both directions
    assert {("fwd", torch.bfloat16, 128, s, 256, "none") for s in (320, 736)} | {
        ("fwd", torch.bfloat16, 32, 320, 96, "ragged"), ("fwd", torch.bfloat16, 128, 320, 96,
                                                          "none"),
        ("step", torch.bfloat16, 128, 736, 256, "none")} <= shapes
    assert {("fwd", torch.bfloat16, 32, 320, dh, "ragged") for dh in (24, 48, 192)} | {
        ("bwd", torch.bfloat16, 128, 320, dh, "none") for dh in (24, 48, 192)} <= shapes
    assert bench_attention.parse_row("dw:float32:32:768:768:simt") == {
        "pass": "dw", "dtype": torch.float32, "K": 32, "Din": 768, "Dout": 768,
        "kernel": "simt"}
    for bad in ("fwd:float32:1:8:100:none", "step:float32:2:228:256:ragged",
                "step:float32:2:200:256:none", "dropout:float32:2:20:64:none",
                "dw:float32:64:100:128", "dw:float16:64:128:128", "ln:float32:8", "ln:int8:8:64",
                "dw:float32:32:768:768:simt32", "dw:bfloat16:32:768:768:tc32",
                "ln:float32:8:64:simt"):
        with pytest.raises(ValueError, match="bad row"):
            bench_attention.parse_row(bad)


def test_bench_attention_step_row(capsys):
    """A ``step`` row times one FLAVA train step (3 layers, here 3 heads of
    256 at batch 2, 224 image and 4 text tokens) with no library call or
    bound; on the CPU no kernel counter moves."""
    (r,) = bench_attention.main(["--rows", "step:float32:2:228:256:none", "--iters", "1",
                                 "--device", "cpu"])
    assert (r["pass"], r["B"], r["S"], r["H"], r["device"]) == ("step", 2, 228, 3, "cpu")
    assert r["ms"] > 0 and r["library_ms"] is None and r["bound_ms"] is None
    assert r["launches"] == r["launches_tc"] == r["launches_tc32"] == NO_LAUNCHES
    assert len(capsys.readouterr().out.strip().splitlines()) == 1


def test_bench_attention_bf16_step_row_builds_the_bf16_model(monkeypatch, capsys):
    """A ``step:bfloat16`` row builds FLAVA with bf16 activations, as the train
    CLI's ``--bf16`` does, and feeds it bf16 features."""
    from multimodal_uncertainty_tpu_torch import zoo
    from multimodal_uncertainty_tpu_torch.training import steps

    seen = {}
    real_setup, real_step = zoo.setup_flava, steps.train_step

    def setup(**kw):
        seen["dtype"] = kw.get("dtype")
        return real_setup(**kw)

    def step(bundle, optimizer, x, y, generator):
        seen["x"] = tuple(t.dtype for t in x)
        return real_step(bundle, optimizer, x, y, generator)

    monkeypatch.setattr(zoo, "setup_flava", setup)
    monkeypatch.setattr(steps, "train_step", step)
    (r,) = bench_attention.main(["--rows", "step:bfloat16:2:228:256:none", "--iters", "1",
                                 "--device", "cpu"])
    assert (r["pass"], r["dtype"], r["device"]) == ("step", "bfloat16", "cpu")
    assert seen == {"dtype": torch.bfloat16, "x": (torch.bfloat16, torch.bfloat16)}
    capsys.readouterr()


def test_bench_attention_dw_and_ln_rows(capsys):
    """``dw`` and ``ln`` rows: one JSON line each, timed beside ``torch.matmul``
    / ``F.layer_norm`` with the bounds (an fp32 dW row both of its own, the
    split-fp32 kernel's the tighter); on the CPU the routes are the plain
    versions and no counter moves."""
    rows = bench_attention.main(["--rows", "dw:float32:300:128:256,dw:bfloat16:64:256:128,"
                                 "ln:float32:300:64,ln:bfloat16:40:768", "--iters", "1",
                                 "--device", "cpu"])
    assert [(r["pass"], r["dtype"]) for r in rows] == [
        ("dw", "float32"), ("dw", "bfloat16"), ("ln", "float32"), ("ln", "bfloat16")]
    assert (rows[0]["K"], rows[0]["Din"], rows[0]["Dout"]) == (300, 128, 256)
    assert (rows[2]["rows"], rows[2]["D"]) == (300, 64)
    for r in rows:
        assert r["ms"] > 0 and r["library_ms"] > 0 and r["bound_ms"] > 0 and r["device"] == "cpu"
        assert set(r["launches"].values()) == {0}
    fp32 = rows[0]
    flops, nbytes = 2 * 300 * 128 * 256, 300 * (128 + 256) * 4 + 128 * 256 * 4
    assert fp32["fma_bound_ms"] == pytest.approx(max(flops / 67e12, nbytes / 3.35e12) * 1e3)
    assert fp32["tc32_bound_ms"] == pytest.approx(max(3 * flops / 495e12, nbytes / 3.35e12) * 1e3)
    assert fp32["bound_ms"] == pytest.approx(fp32["tc32_bound_ms"])
    assert fp32["tc32_bound_ms"] < fp32["fma_bound_ms"]
    assert "fma_bound_ms" not in rows[1]
    assert rows[3]["bound_by"] == "bytes" and rows[3]["bound_ms"] == pytest.approx(
        (2 * 40 * 768 * 2 + 2 * 768 * 4) / 3.35e12 * 1e3)
    assert len(capsys.readouterr().out.strip().splitlines()) == 4


def test_bench_attention_masks():
    """k4: sample 0's last fifth of keys masked; ragged: a kept prefix of at
    least half the keys; none: no mask."""
    m = bench_attention.key_mask("k4", 2, 10, "cpu")
    assert m[0].tolist() == [True] * 8 + [False] * 2 and bool(m[1].all())
    r = bench_attention.key_mask("ragged", 4, 9, "cpu")
    for row in r.tolist():
        n = sum(row)
        assert n >= 5 and row == [True] * n + [False] * (9 - n)
    assert bench_attention.key_mask("none", 2, 10, "cpu") is None


def test_bench_attention_defaults_race_the_bf16_dw_kernels():
    """The default rows hold bf16 dW at the ``--bf16 --fast_dw`` paths' shapes
    on their routes, both bf16 kernels at K = 32-256 (768 x 768) and MMBT's
    K = 96 (2048 x 768), and FLAVA's bf16 train step with ``--fast_dw``; a dW
    row's kernel field names a kernel of its dtype."""
    parsed = [bench_attention.parse_row(r) for r in bench_attention.parse_args([]).rows.split(",")]
    bf16 = {(r["K"], r["Din"], r["Dout"], r.get("kernel")) for r in parsed
            if r["pass"] == "dw" and r["dtype"] == torch.bfloat16}
    assert {(10240, 768, 3072, None), (10240, 3072, 768, None), (10240, 768, 768, None),
            (10240, 768, 2304, None), (5280, 768, 3072, None), (5280, 3072, 768, None),
            (40960, 768, 3072, None), (32, 768, 768, None), (96, 2048, 768, None),
            (70144, 768, 3072, None)} <= bf16
    assert {(k, 768, 768, kernel) for k in (32, 64, 96, 128, 192, 256)
            for kernel in ("tc", "mma")} | {(96, 2048, 768, "tc"), (96, 2048, 768, "mma")} <= bf16
    assert {"pass": "step", "dtype": torch.bfloat16, "B": 128, "S": 320, "Dh": 256,
            "mask": "fast_dw"} in parsed
    assert bench_attention.parse_row("dw:bfloat16:32:768:768:mma")["kernel"] == "mma"
    for bad in ("dw:bfloat16:32:768:768:simt", "dw:float32:32:768:768:mma",
                "dw:float32:32:768:768:tc", "fwd:float32:2:20:64:fast_dw"):
        with pytest.raises(ValueError, match="bad row"):
            bench_attention.parse_row(bad)


@pytest.mark.parametrize("dh", [128, 32])
def test_bench_attention_defaults_time_the_bf16_attention_at_dh_128_and_32(dh):
    """The default rows time the bf16 attention at Dh 128 and 32 (FLAVA at 6
    and 24 heads under ``--bf16``, on their tensor-core sources): the forward
    and the backward at B=128, S=320 without a mask and at B=32, S=320 with
    the ragged one, the train step at B=128, S=320, and at Dh 32 K5 (dropout
    forward and backward at MMBT's B=32, S=165, ragged)."""
    parsed = [bench_attention.parse_row(r) for r in bench_attention.parse_args([]).rows.split(",")]
    bf16 = {(r["pass"], r["B"], r["S"], r["mask"]) for r in parsed
            if r["pass"] not in ("dw", "ln") and r["dtype"] == torch.bfloat16 and r["Dh"] == dh}
    want = {(which, b, 320, mask) for which in ("fwd", "bwd")
            for b, mask in ((128, "none"), (32, "ragged"))} | {("step", 128, 320, "none")}
    if dh == 32:
        want |= {("fwd_dropout", 32, 165, "ragged"), ("bwd_dropout", 32, 165, "ragged")}
    assert want <= bf16, want - bf16


def test_bench_attention_fast_dw_step_row_takes_the_dw_route(monkeypatch, capsys):
    """A ``step:...:fast_dw`` row sets ``--fast_dw`` on the model, so each
    Linear of widths multiple of 128 computes its dW on ``ops/dw.py``'s
    route (the plain version on the CPU); it reports the dW kernels' device
    ms only on the card."""
    from multimodal_uncertainty_tpu_torch.ops import dw

    calls = []
    real = dw.weight_grad
    monkeypatch.setattr(dw, "weight_grad", lambda x, g: calls.append(x.shape) or real(x, g))
    (r,) = bench_attention.main(["--rows", "step:float32:2:228:256:fast_dw", "--iters", "1",
                                 "--device", "cpu"])
    assert (r["pass"], r["mask"], r["device"]) == ("step", "fast_dw", "cpu")
    assert r["dw_device_ms"] is None and calls
    capsys.readouterr()
