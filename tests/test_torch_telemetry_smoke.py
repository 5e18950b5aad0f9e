"""The port's observability smoke (``repro_torch.launch.telemetry_smoke``,
the counterpart of ``benchmarks/telemetry_smoke.py``) on the CPU: one
in-process serve with the metrics endpoint, the trace and the request log
on; exit 0 and its three artifacts. Without ``--device cpu`` it asks for
the card and raises here."""
import json

import pytest
import torch

from repro_torch.launch import telemetry_smoke
from repro_torch.telemetry import parse_exposition, validate_trace


def test_telemetry_smoke_cpu(tmp_path):
    assert telemetry_smoke.main(["--device", "cpu", "--requests", "4",
                                 "--outdir", str(tmp_path)]) == 0
    samples = parse_exposition((tmp_path / "metrics.txt").read_text())
    assert samples["repro_requests_finished_total"] == 4
    info = validate_trace(json.loads((tmp_path / "trace.json").read_text()))
    assert info["slices"] > 0
    recs = [json.loads(line) for line in
            (tmp_path / "records.jsonl").read_text().splitlines() if line]
    assert len(recs) == 4 and all(r["finished"] for r in recs)
    assert sum(r["tokens"] for r in recs) == \
        samples["repro_request_tokens_total"]


def test_telemetry_smoke_asks_for_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        telemetry_smoke.main(["--requests", "1", "--outdir", str(tmp_path)])
