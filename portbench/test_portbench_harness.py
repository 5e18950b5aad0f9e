"""The harness's own arithmetic and plumbing, on the CPU: cells found by
name from new files alone, the tails, the work counts against hand
counts, the traffic's fixed sets, and the look for forbidden modules."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import HERE, TINY_DENSE
from harness import counts as C
from harness.bench import forbidden_loaded
from harness.spec import resolve
from harness.traffic import Traffic, quantile_set
from harness.weights import derived
from harness.window import Track, Window


def test_new_cell_found_from_new_files_alone(tmp_path):
    """A config, a mix, a cell and a metric added as files and entries are
    resolved by name; every file that was there is left byte-identical."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "https://example.org",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "test", "moves": "decode_tok_s",
                               "workloads": ["tiny-cell"]})
    bench["end_to_end"][0]["workloads"].append("tiny-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = root / "portbench"
    (pb / "configs" / "tiny.json").write_text(json.dumps(TINY_DENSE))
    (pb / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"adopted": {"requests": 2, "max_new": 4,
                     "context": {"dist": "uniform", "lo": 8, "hi": 9}}}))
    (pb / "cells" / "tiny-cell.json").write_text(json.dumps(
        {"engine": {"n_slots": 2}, "check": {}}))
    (pb / "metrics" / "new_metric.py").write_text(
        "def read(w):\n    return 42.0\n")
    cell = resolve("tiny-cell", root)
    assert cell.config["name"] == "tiny-dense"
    assert list(cell.traffic) == ["adopted"]
    assert cell.cell["engine"] == {"n_slots": 2}
    names = {m.name: m for m in cell.metrics}
    assert names["new_metric"].read(None) == 42.0
    assert {"decode_tok_s", "setup_s"} <= {m.name for m in
                                           cell.metrics_for(False)}
    assert "k1_roofline.decode" not in names
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
    with pytest.raises(KeyError):
        resolve("no-such-cell", root)


COMMITTED = [w["name"] for w in json.loads(
    (HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_cells_resolve(name):
    """Every cell of ``BENCHMARK.json`` resolves with a reader for each of
    its metrics and reports setup_s and one more end-to-end metric."""
    cell = resolve(name, HERE.parent)
    e2e = {m.name for m in cell.metrics_for(False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.metrics_for(True)


def _window(tracks, t_open=100.0, seconds=10.0):
    return Window(seconds, t_open, t_open + seconds, TINY_DENSE,
                  tracks=tracks)


def test_ttft_tail_counts_requests_still_waiting():
    """TTFT runs from the scheduled arrival; a request due in the window
    with no first token by the close counts the time it has waited; the
    95th percentile is over all of them, not over chunks."""
    t0, close = 100.0, 110.0
    tracks = [Track(i, 8, 4, due_t=t0 + i * 0.1, first_t=t0 + i * 0.1 + 0.05)
              for i in range(19)]
    tracks.append(Track(19, 8, 4, due_t=t0 + 6.0))
    w = _window(tracks, t0)
    tt = w.ttfts()
    assert len(tt) == 20
    assert tt[-1] == pytest.approx(close - (t0 + 6.0))
    assert tt[:19] == pytest.approx([0.05] * 19)
    assert np.percentile(tt, 95) == pytest.approx(0.05 + 0.05 * (4.0 - 0.05))


def test_tpot_over_requests_with_two_tokens():
    tr = [Track(0, 8, 9, first_t=1.0, last_t=3.0, n=9, n_close=9),
          Track(1, 8, 9, first_t=1.0, last_t=1.0, n=1, n_close=1),
          Track(2, 8, 9, first_t=2.0, last_t=2.5, n=3, n_close=3)]
    w = _window(tr)
    assert sorted(w.tpots()) == pytest.approx([0.25, 0.25])


def test_decode_spans_and_context_sums():
    """The decode token of output index j ran at context prompt + j;
    index 0 (prefill's or the handover's) is not a decode token."""
    tr = [Track(0, 100, 50, n_open=5, n_close=9),
          Track(1, 10, 50, n_open=0, n_close=3)]
    w = _window(tr)
    assert sum(b - a for _, a, b in w.decode_spans()) == 4 + 2
    ctxs = [105, 106, 107, 108, 11, 12]
    assert w.sum_over_ctx(lambda c: 3.0 * c + 1.0) == pytest.approx(
        sum(3.0 * c + 1.0 for c in ctxs))


def test_counts_against_hand_counts():
    c = TINY_DENSE      # D 64, H 4, KVH 2, dh 16, F 128, V 256, 2 layers
    per_layer = 64 * (64 + 2 * 32) + 64 * 64 + 3 * 64 * 128
    assert C.matmul_params(c) == (2 * per_layer, 64 * 256)
    assert C.weight_bytes(c) == 4 * (2 * per_layer + 64 * 256)
    assert C.kv_bytes(c, 10) == 2 * 4 * 10 * 32 * 2
    assert C.decode_flops(c, 10) == 2 * (2 * per_layer + 64 * 256) \
        + 4 * 10 * 64 * 2
    assert C.prefill_flops(c, 5) == 2 * 2 * per_layer * 5 + 2 * 64 * 256 \
        + 2 * 5 * 6 * 64 * 2
    nbytes, flops = C.k1_work(c, 10)
    assert nbytes == C.kv_bytes(c, 10) + 2 * 4 * 64 * 2
    assert flops == 4 * 10 * 64 * 2
    gelu = dict(c, act="gelu", vocab_size=300)   # two MLP matrices; V 512
    mp = 64 * (64 + 2 * 32) + 64 * 64 + 2 * 64 * 128
    assert C.matmul_params(gelu) == (2 * mp, 64 * 512)
    assert C.bound_s(3.35e12, 1.0, 1e12) == pytest.approx(1.0)


CHAT = {"arrival": {"process": "gamma", "shape": 0.5, "rate_per_s": 10.0},
        "prompt": {"dist": "lognormal", "median": 512, "sigma": 1.0,
                   "lo": 64, "hi": 3072},
        "output": {"dist": "lognormal", "median": 96, "sigma": 0.8,
                   "lo": 16, "hi": 512}, "set_seed": 2401}
CLOSED = {"clients": 8, "prompt": {"dist": "uniform", "lo": 128, "hi": 512},
          "output": {"dist": "uniform", "lo": 1024, "hi": 3072},
          "stagger_first": True}


def test_traffic_same_set_other_order():
    """Two seeds ask for the same set of sizes and gaps in another order."""
    a = Traffic({"closed": CLOSED}, 11, 32000)
    b = Traffic({"closed": CLOSED}, 2 ** 31 + 12, 32000)
    for x, y in zip(a._pool("closed"), b._pool("closed")):
        assert sorted(x) == sorted(y) and list(x) != list(y)
    ra = Traffic({"open": CHAT}, 11, 32000).arrivals(30.0)
    rb = Traffic({"open": CHAT}, 2 ** 31 + 12, 32000).arrivals(30.0)
    assert all(0 <= r.prompt.min() and r.prompt.max() < 32000 for r in ra)
    assert len(ra) == len(rb) == 300
    assert sorted(r.arrival for r in ra)[-1] < 30.0
    assert np.diff([r.arrival for r in ra]).mean() == pytest.approx(
        np.diff([r.arrival for r in rb]).mean(), rel=0.2)
    q = quantile_set({"dist": "uniform", "lo": 20480, "hi": 36864}, 16)
    assert q.min() >= 20480 and q.max() <= 36864 and len(set(q)) == 16
    long_ = json.loads((HERE / "traffic" / "decode_long.json").read_text())
    ra = Traffic(long_, 5, 64000).adopted()
    rb = Traffic(long_, 6, 64000).adopted()
    assert sorted(len(r.prompt) for r in ra) == \
        sorted(len(r.prompt) for r in rb)
    assert [len(r.prompt) for r in ra] != [len(r.prompt) for r in rb]


def test_stratified_order_spreads_sizes_over_every_stretch():
    """An open loop's stratified order: the window's sizes are the same set
    for every seed, and every quarter of the arrivals holds them in their
    proportions (its mean prompt within 10% of the whole set's)."""
    sets = []
    for seed in (3, 2 ** 31 + 4):
        reqs = Traffic({"open": CHAT}, seed, 32000).arrivals(40.0)
        lens = np.asarray([len(r.prompt) for r in reqs])
        outs = np.asarray([r.max_new for r in reqs])
        sets.append((sorted(lens), sorted(outs), list(lens)))
        for part in np.array_split(np.arange(len(reqs)), 4):
            assert abs(lens[part].mean() / lens.mean() - 1) < 0.1
            assert abs(outs[part].mean() / outs.mean() - 1) < 0.1
    assert sets[0][:2] == sets[1][:2] and sets[0][2] != sets[1][2]


def test_parts_of_a_mix_run_side_by_side_behind_shared_prefixes():
    """A mix of adopted rows, a closed loop and open arrivals behind 3
    shared prefixes: each part's requests come from its own sets, every
    submitted prompt starts with one of the prefixes (each used, lengths
    the same set for every seed), adopted contexts carry none, and every
    prompt is kept for the check under its request's id."""
    mix = {"adopted": {"requests": 4, "max_new": 8, "context": {
               "dist": "uniform", "lo": 100, "hi": 200}},
           "closed": CLOSED, "open": CHAT,
           "prefix": {"groups": 3, "length": {"dist": "uniform",
                                              "lo": 1000, "hi": 4000}}}
    pre_lens = []
    for seed in (21, 2 ** 31 + 22):
        t = Traffic(mix, seed, 64000)
        assert t.parts == ["adopted", "closed", "open"]
        reqs = t.adopted() + t.first_wave() + t.arrivals(2.0)
        assert [r.part for r in reqs] == \
            ["adopted"] * 4 + ["closed"] * 8 + ["open"] * 20
        assert len({r.rid for r in reqs}) == len(reqs)
        pre = t._prefixes()
        pre_lens.append(sorted(len(p) for p in pre))
        used = set()
        for r in reqs:
            assert t.prompts[r.rid] is r.prompt
            if r.part == "adopted":
                assert 100 <= len(r.prompt) <= 200
                continue
            g = [i for i, p in enumerate(pre)
                 if np.array_equal(r.prompt[:len(p)], p)]
            assert len(g) == 1
            used.add(g[0])
            rest = len(r.prompt) - len(pre[g[0]])
            src = CLOSED if r.part == "closed" else CHAT
            assert src["prompt"]["lo"] <= rest <= src["prompt"]["hi"]
        assert used == {0, 1, 2}
    assert pre_lens[0] == pre_lens[1]
    with pytest.raises(ValueError):
        Traffic({"prefix": mix["prefix"]}, 1, 100)


def test_forbidden_modules_compared_by_whole_top_level_name(monkeypatch):
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]:
        monkeypatch.delitem(sys.modules, name)
    assert forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert forbidden_loaded() == ["jaxlib", "repro"]


def test_benchmark_sources_import_no_jax_or_repro():
    """No file under portbench imports jax, jaxlib, flax or repro (whole
    top-level names); the reference imports nothing of the program."""
    import ast
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "repro"), \
                    (path, m)
                if path.name == "reference.py":
                    assert top != "repro_torch", (path, m)


def test_run_without_a_card_exits_2_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "yi34b-decode-long", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_derived_widths_of_the_configs():
    yi = derived(json.loads((HERE / "configs" / "yi34b-200k-stage8.json")
                            .read_text()))
    assert (yi["q_dim"], yi["kv_dim"], yi["n_attn"]) == (7168, 1024, 8)
    assert C.weight_bytes(yi) == 4 * (8 * (7168 * (7168 + 2048) + 7168 * 7168
                                           + 3 * 7168 * 20480)
                                      + 7168 * 64000)
    assert C.kv_bytes(yi, 1) == 64 * 1024
