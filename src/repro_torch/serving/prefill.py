"""Prefill strategies for the serving engine.

Port of ``repro/serving/prefill.py`` for attention-only stacks and the
zamba2 hybrid:

* ``slot`` — one batch-1 ``prefill`` per admitted request (the recompute
  reference path); a hybrid's prefill starts from fresh rows and its
  result is merged into the slot's rows;
* ``batched`` — length-bucketed batched prefill: the requests admitted in a
  tick are grouped into padded-length buckets, one ``prefill`` call per
  bucket (``last_idx`` picks each request's true last position,
  ``valid_len`` keeps pad positions out of the pool);
* ``chunked`` — DCS-style interleave: prompts are cut into fixed-size
  chunks and ONE batched ``prefill_chunk`` call per engine tick covers
  every prefilling slot (vector ``ctx_start``), between decode steps.

Batched and chunked prefill reset the admitted slots' recurrent rows
(``engine._begin_prefill_group``) and thread the group's rows through each
call as an explicit carry (gather -> prefill -> scatter).

``max_horizon`` is the cap a prefiller puts on the fused decode horizon
this tick: chunked prefill caps it to 1 while chunks stream. Resumes at a
depth (prefix-cache hits, recurrent snapshots: ``prefill_suffix``) wait
for the KV-cache hierarchy (ROADMAP queue A.7).
"""
from __future__ import annotations

import numpy as np

from repro_torch.models import model as MDL


def _suffix_bucket(n: int, cap: int) -> int:
    b = 8
    while b < n and b < cap:
        b *= 2
    return b if b >= n else -(-n // cap) * cap


def decode_table_bucket(live_pages: int, width: int) -> int:
    """Decode block-table width the engine dispatches for a live-page
    high-water mark: the prefill pow2 bucket with a 16-page floor, capped
    at the full table width."""
    return min(width, _suffix_bucket(max(16, live_pages), width))


def _group_tables(eng, slots, span: int) -> np.ndarray:
    """Stacked Va2Pa rows for a prefill group, sliced to the pages the
    group's context spans (pow2-bucketed) — the chunk path gathers every
    block-table slot per layer."""
    bts = np.stack([eng.batcher.block_table_row(slot) for slot in slots])
    need = -(-span // eng.ecfg.page_size) + 1
    return bts[:, :min(_suffix_bucket(need, need), bts.shape[1])]


def _fresh(req) -> None:
    """Every admission prefills from position 0: resumes at a depth
    (``prefill_suffix`` in ``repro``) come with the prefix cache."""
    if req.cached_len:
        raise NotImplementedError(
            "suffix prefill (prefix-cache hits / snapshot resume) is "
            "ROADMAP queue A.7")


class SlotPrefiller:
    """Per-request whole-prompt prefill — the recompute reference path."""
    name = "slot"
    max_horizon = None                 # never caps the fused decode horizon

    def __init__(self, engine):
        self.eng = engine

    @property
    def busy(self) -> bool:
        return False

    def run(self, admitted, active):
        eng = self.eng
        for slot, req in admitted:
            _fresh(req)
            req.generated = 1          # prefill emits the first token
            prompt, emit = eng._prompt_seq(req)
            bt = eng.batcher.block_table_row(slot)
            state1 = {"pool": eng.state["pool"]}
            if eng.has_rstate:
                state1.update(MDL.init_rstate(eng.cfg, 1, device=eng.device))
            eng.timing.prefill_calls += 1
            logits, state1 = MDL.prefill(
                eng.cfg, eng.params, state1, eng._tensor(prompt[None]),
                eng._tensor(np.asarray(bt)[None]), rt=eng.rt)
            if eng.has_rstate:
                MDL.scatter_rstate(eng.state, [slot],
                                   MDL.rstate_entries(state1))
            eng._emit_first(slot, req,
                            int(eng._first_tokens(logits[:1], [emit])[0]),
                            emit)
        return active


class BatchedPrefiller:
    """Length-bucketed batched prefill: every bucket is one call."""
    name = "batched"
    max_horizon = None

    def __init__(self, engine):
        self.eng = engine

    @property
    def busy(self) -> bool:
        return False

    def _bucket(self, n: int) -> int:
        return _suffix_bucket(n, max(8, self.eng.ecfg.max_prefill))

    def run(self, admitted, active):
        eng = self.eng
        groups: dict[int, list] = {}
        eng._begin_prefill_group(admitted)
        for slot, req in admitted:
            _fresh(req)
            seq, emit = eng._prompt_seq(req)
            groups.setdefault(self._bucket(len(seq)), []).append(
                (slot, req, seq, emit))
        for blen in sorted(groups):
            grp = groups[blen]
            toks = np.zeros((len(grp), blen), np.int32)
            lens = np.zeros((len(grp),), np.int32)
            for i, (_, _, seq, _) in enumerate(grp):
                toks[i, :len(seq)] = seq
                lens[i] = len(seq)
            slots = [slot for slot, *_ in grp]
            bts = np.stack([eng.batcher.block_table_row(slot)
                            for slot in slots])
            eng.timing.prefill_calls += 1
            logits, gstate = MDL.prefill(
                eng.cfg, eng.params, eng._group_prefill_state(slots),
                eng._tensor(toks), eng._tensor(bts),
                last_idx=eng._tensor(lens - 1), valid_len=eng._tensor(lens),
                rt=eng.rt)
            eng._merge_group_state(slots, gstate)
            first = eng._first_tokens(logits, [e for *_, e in grp])
            for i, (slot, req, _, emit) in enumerate(grp):
                req.generated = 1
                eng._emit_first(slot, req, int(first[i]), emit)
        return active


class ChunkedPrefiller:
    """Fixed-size chunk per prefilling slot per tick, interleaved with
    decode — ONE batched ``prefill_chunk`` call covers every streaming slot
    (vector chunk cursors). Slots finishing their last chunk join this
    tick's decode batch."""
    name = "chunked"

    def __init__(self, engine):
        self.eng = engine
        self._pos: dict[int, int] = {}      # slot -> next ctx_start

    @property
    def busy(self) -> bool:
        return bool(self._pos)

    @property
    def max_horizon(self):
        """One decode step per tick while chunks stream (DCS granularity);
        uncapped once every prompt is through."""
        return 1 if self._pos else None

    def run(self, admitted, active):
        eng = self.eng
        eng._begin_prefill_group(admitted)
        for slot, req in admitted:
            _fresh(req)
            self._pos[slot] = 0
        if not self._pos:
            return active
        C = max(1, eng.ecfg.prefill_chunk)
        completed = []
        grp = []                            # (slot, req, prompt, emit, valid)
        for slot in sorted(self._pos):
            req = eng.batcher.slots[slot]
            if req is None or req.prefill_done:
                # slot freed or preempted out from under a mid-prefill
                # request; its re-admission re-registers from chunk 0
                del self._pos[slot]
                continue
            prompt, emit = eng._prompt_seq(req)
            grp.append((slot, req, prompt, emit,
                        min(C, len(prompt) - self._pos[slot])))
        if grp:
            toks = np.zeros((len(grp), C), np.int32)
            starts = np.zeros((len(grp),), np.int32)
            lens = np.zeros((len(grp),), np.int32)
            for i, (slot, _, prompt, _, valid) in enumerate(grp):
                start = self._pos[slot]
                toks[i, :valid] = prompt[start:start + valid]
                starts[i] = start
                lens[i] = valid
            slots = [slot for slot, *_ in grp]
            # attention reads nothing past the processed context, so the
            # table slice tracks the deepest cursor, not the full prompts
            bts = _group_tables(eng, slots, int((starts + lens).max()))
            eng.timing.prefill_calls += 1
            logits, gstate = MDL.prefill_chunk(
                eng.cfg, eng.params, eng._group_prefill_state(slots),
                eng._tensor(toks), eng._tensor(bts), eng._tensor(starts),
                last_idx=eng._tensor(lens - 1), valid_len=eng._tensor(lens),
                rt=eng.rt)
            eng._merge_group_state(slots, gstate)
            fin = [(i, slot, req, emit)
                   for i, (slot, req, prompt, emit, valid) in enumerate(grp)
                   if starts[i] + valid >= len(prompt)]
            first = (eng._first_tokens(logits[[i for i, *_ in fin]],
                                       [e for *_, e in fin]) if fin else [])
            for j, (i, slot, req, emit) in enumerate(fin):
                del self._pos[slot]
                req.generated = 1
                req.kv_written = True
                if eng.batcher.mark_prefill_done(slot):
                    eng._emit_first(slot, req, int(first[j]), emit)
                    completed.append(slot)
                # else: pool exhausted at the finish line — the batcher
                # preempted and requeued the bare prompt
            for i, (slot, _, _, _, valid) in enumerate(grp):
                if slot in self._pos:
                    self._pos[slot] += valid
        return sorted(set(active) | set(completed)) if completed else active


def make_prefiller(mode: str, engine):
    """'slot' | 'batched' | 'chunked'."""
    if mode == "batched":
        return BatchedPrefiller(engine)
    if mode == "chunked":
        return ChunkedPrefiller(engine)
    if mode != "slot":
        raise ValueError(f"unknown prefill mode {mode!r}")
    return SlotPrefiller(engine)
