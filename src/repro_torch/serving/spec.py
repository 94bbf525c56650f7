"""Prompt-lookup speculative drafting: a model-free n-gram proposer.

Speculative decoding amortizes one pipelined forward pass over several
tokens — the serving analogue of the paper's multi-stage MAC pipelining,
where throughput comes from keeping the array busy per pass, not from
more passes. The classic scheme needs a second (small) draft model; the
**prompt-lookup** variant (PLD) replaces it with an n-gram index over the
sequence's own history (prompt + generated tokens): when the tail of the
history has occurred before, propose the tokens that followed it last
time. Repetition-heavy workloads — code editing, extraction, RAG with
quoted context, and the degenerate loops small models fall into — hand
this drafter long correct continuations for free; on novel text it simply
proposes nothing and the engine decodes one token per pass as before.

Correctness never depends on the drafter: the engine verifies every
proposal against the target model in a single multi-token forward pass
(``models/lm.lm_paged_verify``) and keeps only the longest accepted
prefix, so a bad proposal costs wasted window compute, never a wrong
token (``docs/SERVING.md`` — speculative decoding).

The index is incremental and O(ngrams) per appended token: ``start`` a
sequence with its prompt, ``extend`` it with each *emitted* token
(rejected draft tokens must never enter the history), ``propose`` reads
the index, ``drop`` frees the sequence. Host-side and deterministic —
nothing here touches the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PromptLookupDrafter"]

#: draft-window length the engine uses when the caller doesn't pass one;
#: REPRO_SPEC_K=N overrides (serving/engine.py reads it).
DEFAULT_SPEC_K = 4


@dataclasses.dataclass
class _SeqState:
    history: list           # prompt + emitted tokens, in order
    # per n: n-gram tuple -> position right after its latest *interior*
    # occurrence (the continuation start). The gram ending at the current
    # tail is indexed only once its continuation token exists, so a
    # lookup can never point past the end of the history.
    index: dict


class PromptLookupDrafter:
    """Per-sequence n-gram index over prompt + output.

    ``ngram_max`` down to ``ngram_min`` are tried in order at proposal
    time — longer grams give higher-precision matches, the 1-gram floor
    catches the constant runs that dominate greedy decode on repetitive
    text. Ties between occurrences resolve to the **latest** one (the
    index keeps one continuation per gram), which tracks locally
    repeating structure better than the first occurrence would.
    """

    def __init__(self, *, ngram_max: int = 3, ngram_min: int = 1):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"({ngram_min}, {ngram_max})")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self._seqs: dict[int, _SeqState] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self, seq_id: int, prompt) -> None:
        """Begin tracking a sequence; index every n-gram of its prompt."""
        if seq_id in self._seqs:
            raise KeyError(f"seq {seq_id} already tracked")
        st = _SeqState(history=[],
                       index={n: {} for n in range(self.ngram_min,
                                                   self.ngram_max + 1)})
        self._seqs[seq_id] = st
        for t in np.asarray(prompt).tolist():
            self._append(st, int(t))

    def extend(self, seq_id: int, token: int) -> None:
        """Append one *emitted* token (accepted draft, correction or bonus
        — never a rejected draft) and index the grams it completes."""
        self._append(self._seqs[seq_id], int(token))

    def drop(self, seq_id: int) -> None:
        """Forget a finished sequence (missing ids are fine — the dense
        fallback paths never start one)."""
        self._seqs.pop(seq_id, None)

    def _append(self, st: _SeqState, token: int) -> None:
        # the grams ENDING at the previous tail become interior (their
        # continuation — this token — now exists), so index them now;
        # `pos` is where the continuation starts, always < len(history)
        pos = len(st.history)
        for n in range(self.ngram_min, self.ngram_max + 1):
            if pos >= n:
                st.index[n][tuple(st.history[pos - n:pos])] = pos
        st.history.append(token)

    # -- proposal ------------------------------------------------------------

    def propose(self, seq_id: int, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing the sequence's tail, from
        the latest earlier occurrence of the longest matching tail
        n-gram. Empty when the tail is novel (or ``k < 1``) — the engine
        then runs a plain single-token window."""
        if k < 1:
            return []
        st = self._seqs[seq_id]
        hist = st.history
        for n in range(self.ngram_max, self.ngram_min - 1, -1):
            if len(hist) < n:
                continue
            pos = st.index[n].get(tuple(hist[len(hist) - n:]))
            if pos is not None:
                return hist[pos:pos + k]
        return []
