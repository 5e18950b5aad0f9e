"""The correctness check fails a broken program: a run on the CPU at tiny
widths (the look for a card skipped, everything else as on the card) with
the timed path broken underneath must come out ``correct: false``. One
case per fault a one-chip serving cell can have; the exchange between
chips does not exist on one chip."""
from __future__ import annotations

import time

import pytest
import torch

from conftest import tiny_cell
from harness.bench import run


def _token_altered(monkeypatch):
    """A served token altered where it is produced (the decode sampler)."""
    from repro_torch.serving import engine as E
    make = E.make_scan_sampler

    def broken(*a, **k):
        fn = make(*a, **k)

        def sample(gen, logits, *rest):
            return (fn(gen, logits, *rest) + 1) % logits.shape[-1]
        if getattr(fn, "takes_run", False):
            sample.takes_run = True
        return sample
    monkeypatch.setattr(E, "make_scan_sampler", broken)


def _state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: the new tokens' K/V
    go to the trash page."""
    from repro_torch.kernels import ops
    targets = ops.write_targets

    def trash(bt, ctx, run, *, page_size, n_pages, ring_width=0):
        npage, noff = targets(bt, ctx, run, page_size=page_size,
                              n_pages=n_pages, ring_width=ring_width)
        return torch.full_like(npage, n_pages), noff
    monkeypatch.setattr(ops, "write_targets", trash)


def _half_batch(monkeypatch):
    """Half of the batch left out: the last half of the rows get the first
    rows' logits instead of their own."""
    from repro_torch.models import model as MDL
    step = MDL.decode_step

    def half(*a, **k):
        logits, state = step(*a, **k)
        B = logits.shape[0]
        h = B // 2
        return torch.cat([logits[:B - h], logits[:h]]), state
    monkeypatch.setattr(MDL, "decode_step", half)


FAULTS = {"token_altered": _token_altered,
          "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


@pytest.mark.parametrize("kind", ["adopted", "open", "closed", "mixed"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(kind, fault, monkeypatch, cpu_threads):
    cell = tiny_cell(kind, sample=16)
    FAULTS[fault](monkeypatch)
    res = run(cell, 2 ** 31 + 23, 1.0, False, t_start=time.perf_counter(),
              device="cpu")
    assert res["checks"]["positions"]["value"] >= 10
    assert not res["correct"], res["checks"]
