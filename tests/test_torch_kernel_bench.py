"""The port's kernel bench entry point (``repro_torch.launch.kernel_bench``)
on the CPU: its smoke run passes its own checks and writes the JSON shape
of the JAX bench's committed output, ``BENCH_kernels.json`` (the same
top-level keys, row names and decode-step contexts); it asks for the card
by default and raises without one; its H100 bound is the one stated for
the long-context ITPP shape.
"""
import json
import pathlib

import pytest
import torch

from repro_torch.launch import kernel_bench

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_smoke_on_cpu_writes_the_jax_bench_shape(tmp_path, capsys):
    path = tmp_path / "kernels.json"
    out = kernel_bench.main(["--smoke", "--device", "cpu", "--json",
                             str(path)])
    assert "# kernel_bench OK" in capsys.readouterr().out
    got = json.loads(path.read_text())
    want = json.loads((ROOT / "BENCH_kernels.json").read_text())
    assert sorted(got) == sorted(want)
    assert [r["name"] for r in got["rows"]] == [r["name"]
                                                for r in want["rows"]]
    assert sorted(got["maxerr"]) == sorted(want["maxerr"])
    assert sorted(got["decode_step"]) == sorted(want["decode_step"])
    for c, row in got["decode_step"].items():
        assert sorted(row) == sorted(want["decode_step"][c])
        assert row["maxerr"] < 1e-3
    assert all(e < 1e-2 for e in got["maxerr"].values())
    assert all("device=cpu" in r["derived"] for r in got["rows"])
    # every kernel section called its wrapper (on a card: one launch each)
    assert all(out["calls"][k] > 0 for k in kernel_bench.KERNELS)


def test_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        kernel_bench.main(["--smoke"])


def test_failed_check_exits_non_zero(monkeypatch):
    """A maxerr at or over the JAX bench's limit raises, after the JSON is
    written."""
    run = kernel_bench.run

    def bad_run(emit, dev, *, smoke=False):
        out = run(emit, dev, smoke=smoke)
        out["flash_decode"] = 0.5
        return out
    monkeypatch.setattr(kernel_bench, "run", bad_run)
    with pytest.raises(RuntimeError, match="flash_decode maxerr"):
        kernel_bench.main(["--smoke", "--device", "cpu"])


def test_h100_bound_of_the_long_context_itpp_shape():
    """B8 KVH8 G4 D64 over T = 32768 fp32 tokens: 1.07 GB of K/V, about
    0.32 ms at 3.35 TB/s (the partials and q add well under 1%)."""
    q = torch.empty(8, 8, 4, 64)
    us = kernel_bench.attention_bound_us(8 * 32768, q, 16, 4)
    assert 1e6 * 2 * 8 * 32768 * 8 * 64 * 4 / 3.35e12 == pytest.approx(
        320.5, rel=1e-3)
    assert us == pytest.approx(320.5, rel=1e-2)
