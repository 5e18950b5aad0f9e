"""The plain reference against ``repro_torch`` on tiny configs on the CPU,
and whole runs of each part of a mix, and of the parts together, coming
out correct."""
from __future__ import annotations

import time

import pytest
import torch

from conftest import TINY_DENSE, tiny_cell
from harness import reference as R
from harness.bench import model_config, run
from harness.weights import derived, make_params


@pytest.mark.parametrize("config", [TINY_DENSE,
                                    dict(TINY_DENSE, act="gelu")],
                         ids=["swiglu", "gelu"])
def test_reference_matches_the_port_forward(config, cpu_threads):
    """Logits at every position of a 70-token sequence within 1e-4 of the
    largest: the reference's own equations against the port's
    full-sequence forward, on the same weights."""
    from repro_torch.models import model as MDL
    c = derived(config)
    params = make_params(config, 7, "cpu")
    toks = torch.randint(0, c["vocab_size"], (70,),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), R.precision(False, "cpu"):
        ref = R.forward_for(c)(c, params, toks, 0, None)
        port, _ = MDL.forward(model_config(config), params, toks[None])
    scale = float(ref.abs().max())
    assert float((ref - port[0]).abs().max()) <= 1e-4 * scale


def test_dense_reference_with_a_context_in_front(cpu_threads):
    """The adopted form: context K/V handed in front of the new tokens
    equals computing the whole sequence (K already rotated)."""
    c = derived(TINY_DENSE)
    params = make_params(TINY_DENSE, 9, "cpu")
    toks = torch.randint(0, 256, (40,),
                         generator=torch.Generator().manual_seed(4))
    ks, vs = [], []
    x = params["embed"][toks[:30]]
    pos = torch.arange(30)
    for lp in params["layers"]:
        h = R.rms(x, lp["ln1"], c["norm_eps"])
        ks.append(R.rope(R.mm(h, lp["attn"]["wk"]).view(30, 2, 16), pos,
                         c["rope_theta"]))
        vs.append(R.mm(h, lp["attn"]["wv"]).view(30, 2, 16))
        x = R.attn_block(c, lp, x, pos)
    with torch.no_grad():
        fwd = R.forward_for(c)
        whole = fwd(c, params, toks, 0, None)
        tail = fwd(c, params, toks[30:], 30,
                   (torch.stack(ks), torch.stack(vs)))
    assert float((whole[30:] - tail).abs().max()) <= \
        1e-5 * float(whole.abs().max())


@pytest.mark.parametrize("traced", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("kind", ["adopted", "open", "closed", "mixed"])
def test_whole_run_on_the_cpu_is_correct(kind, traced, cpu_threads):
    """A run of each part of a mix, and of the parts together, at tiny
    widths: the reference agrees with
    what the engine served; an untraced run reads every end-to-end metric,
    a traced one the per-layer metrics that a CPU trace holds (none that
    needs device time: on the CPU those find nothing and are left out)."""
    cell = tiny_cell(kind, sample=8)
    res = run(cell, 2 ** 31 + 17, 2.0, traced, t_start=time.perf_counter(),
              device="cpu")
    assert res["correct"], res["checks"]
    assert res["checks"]["logit_gap"]["value"] <= 1e-4
    assert res["checks"]["positions"]["value"] >= 10
    assert res["failed"] == 0 and res["attempted"] > 0
    names = {m.name for m in cell.metrics_for(traced)}
    if traced:
        device = {m.name for m in cell.metrics if m.source == "device_trace"}
        assert set(res["metrics"]) == names - device
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert 1.9 < res["device"]["window_s"] < 2.5
    else:
        assert set(res["metrics"]) == names
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]


def test_rate_sweep_reads_each_rate(cpu_threads):
    """``sweep.sweep`` runs the open part at each rate it is given: as many
    requests due as the rate asks for in the window, and the tails read."""
    from sweep import sweep
    rows = list(sweep(tiny_cell("open"), [4, 12], 1.0, 2 ** 31 + 29,
                      device="cpu"))
    assert [r["rate"] for r in rows] == [4.0, 12.0]
    assert [r["due"] for r in rows] == [4, 12]
    assert all(r["ttft_p95_ms"] > 0 and r["answered"] <= r["due"]
               for r in rows)
