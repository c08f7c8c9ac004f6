"""Cascade-as-drafter speculative decoding (port of
``repro.serve.speculative``).

A deferred request used to throw the fast tier's whole generation away.
But the fast tier's members agreed on (a prefix of) it, and agreement is
the paper's signal of correctness, so those tokens are a good draft: the
deferral carries the winning member's generation (``Request.draft``), and
the receiving tier scores every draft position in one chunked-prefill pass
instead of one decode step a token.

* **Verify inputs.**  For a prompt of length P and draft d_0..d_{T-1}, the
  verify chunk is ``[prompt[P-1], d_0, .., d_{T-1}]`` at positions
  ``P-1 .. P-1+T``: feeding the token before each draft position gives the
  model's own next-token choice there.  The pass runs through
  ``api.prefill_into_slot_logits_members`` (paged twin:
  ``..._paged_logits_members``) in the ``prompt_chunks`` buckets chunked
  admission already uses, each bucket one captured program.
* **Acceptance.**  ``choices[e, j]`` is member e's token at draft position
  j.  ``n_acc`` is the longest prefix where every member's choice matches
  the draft; position ``n_acc`` emits each member's own choice.  One pass
  emits ``n_acc + 1`` tokens, each what the member's decode would emit.
* **Rollback.**  Rejected draft tokens wrote K/V rows past ``P-1+n_acc``.
  Dense slots need nothing: the position mask hides them and decode writes
  a row before attending to it.  Paged slots unmap the pages wholly past
  the kept span (``PagePool.truncate``); verify wrote only private
  extension pages (``PagePool.extend``), so rollback is copy-on-write safe.
* **Sampling (T > 0).**  Decode draws token (e, p) on (slot key, p, e)
  (``serve/sampling.py``), a pure function of key, position and member;
  ``verify_choices`` draws the verify chunk's tokens on the same triples,
  so speculative and plain serving emit the same tokens at any
  temperature.

Families: attention caches only (``api.supports_draft_verify``).  A
constant-state tier cannot roll rejected tokens out of its recurrent
state, so a draft arriving there is dropped and admission is plain.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.serve import sampling


@dataclasses.dataclass(frozen=True)
class DraftPlan:
    """One slot's verify pass, fixed at admission.

    ``tokens`` (T_use+1,) — the verify chunk ``[prompt[-1], d_0..d_{T_use-1}]``;
    ``draft`` (T_use,) — the draft positions being scored;
    ``start`` — absolute position of ``tokens[0]`` (= P-1)."""

    tokens: np.ndarray
    draft: np.ndarray
    start: int


def plan_draft(prompt_tokens: np.ndarray, draft: np.ndarray, max_new_tokens: int,
               max_seq: int) -> Optional[DraftPlan]:
    """Clamp a draft to what the slot can verify, or None.

    ``T_use <= max_new_tokens - 1``: the pass emits ``n_acc + 1`` tokens,
    so a full-length draft would overshoot the budget by one.
    ``T_use <= max_seq - P``: draft rows live at positions P..P+T_use-1
    below the slot wall.  Below one verifiable token (``max_new_tokens ==
    1``: the first emission is never drafted) there is nothing to verify."""
    P = int(len(prompt_tokens))
    T_use = min(int(len(draft)), max_new_tokens - 1, max_seq - P)
    if T_use < 1:
        return None
    draft = np.asarray(draft[:T_use], np.int32)
    tokens = np.concatenate([np.asarray(prompt_tokens[-1:], np.int32), draft])
    return DraftPlan(tokens=tokens, draft=draft, start=P - 1)


def accepted_prefix(choices: np.ndarray, draft: np.ndarray) -> int:
    """Longest prefix where every member's choice equals the draft:
    choices (E, >=T), draft (T,) -> n_acc in [0, T].  A position is
    accepted only if all member trajectories would have produced the draft
    token there, which keeps each member's emitted sequence its own
    decode's."""
    T = int(draft.shape[0])
    ok = (choices[:, :T] == draft[None, :]).all(axis=0)
    return T if ok.all() else int(np.argmin(ok))


def verify_choices(logits: torch.Tensor, slot_key, start, temperature: float,
                   member_offset: int = 0) -> torch.Tensor:
    """Member choices (E, C) int32 for the verify chunk's logits (E, C, V):
    token (e, j) draws on (slot key, start + j, member_offset + e), exactly
    what the decode step draws for that slot at that position; the argmax at
    ``temperature <= 0``.  ``slot_key`` and ``start`` are ints or (1,)
    device tensors (a captured chunk's staged inputs)."""
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    C, dev = logits.shape[1], logits.device
    keys = torch.as_tensor(slot_key, device=dev).to(torch.int64).reshape(-1).expand(C)
    pos = torch.as_tensor(start, device=dev).to(torch.int64).reshape(-1) + torch.arange(C, device=dev)
    return sampling.sample(logits, keys, pos, temperature, member_offset)
