"""Token-level scheduling state for the continuous-batching engine.

Single-shot serving schedules *requests*; autoregressive serving must
schedule *tokens*: every engine iteration decides which sequences sit
in the fixed ``max_seqs`` decode batch, admits waiting prompts into
free slots (prefill), and retires finished ones — sequences enter and
leave mid-flight, the batch never drains to a barrier.

States::

    WAITING --admit(prefill)--> RUNNING --stop/len--> FINISHED
       ^                          |
       +------ preempt (KV OOM) --+          RUNNING --drain--> EVICTED

Preemption is restart-based: a sequence evicted for KV pressure goes
back to the FRONT of the waiting queue with its prompt extended by
everything it generated so far. Greedy decoding is deterministic, and
sampled decoding keys its PRNG on (seed, absolute position) — so
re-prefilling that longer prompt resumes the exact token stream
either way; no KV is saved, only block budget (the standard vLLM
recompute policy).

The scheduler is pure host-side bookkeeping (which sequence holds
which slot); KV block accounting lives in
:class:`~.kv_cache.BlockAllocator`, and the engine owns the loop.
"""
from __future__ import annotations

import collections
import itertools
import time

__all__ = ["Sequence", "Scheduler",
           "WAITING", "RUNNING", "FINISHED", "EVICTED"]

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"
EVICTED = "evicted"

_seq_ids = itertools.count(1)


class Sequence:
    """One decode request's full lifecycle state."""

    __slots__ = ("seq_id", "prompt", "orig_prompt_len", "generated",
                 "max_new_tokens", "stop_token", "state", "slot",
                 "block_ids", "seq_len", "last_token", "t_submit",
                 "t_first_token", "admit_index", "preemptions",
                 "future", "span", "finish_reason", "deadline",
                 "cancelled", "tenant", "sampling", "draft_len",
                 "prefill_started", "prefix_hashes",
                 "cache_hit_tokens", "adapter", "adapter_handle")

    def __init__(self, prompt_tokens, max_new_tokens, stop_token=None,
                 deadline=None, tenant=None, sampling=None,
                 adapter=None):
        self.seq_id = next(_seq_ids)
        self.prompt = [int(t) for t in prompt_tokens]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.orig_prompt_len = len(self.prompt)
        self.generated = []
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        self.stop_token = stop_token
        self.state = WAITING
        self.slot = None
        self.block_ids = []       # KV blocks currently owned
        self.seq_len = 0          # tokens whose KV sits in the cache
        self.last_token = None    # next decode input
        self.t_submit = time.monotonic()
        self.t_first_token = None
        self.admit_index = None   # admission order; evict newest first
        self.preemptions = 0
        self.future = None        # attached by LLMServer
        self.span = None          # tracer hand-off span (LLMServer)
        self.finish_reason = None
        # absolute monotonic end-to-end deadline (None = unbounded):
        # expired-while-waiting sequences are failed before any
        # prefill; expired-while-running ones are evicted with their
        # partial tokens (typed DeadlineExceededError either way)
        self.deadline = deadline
        # set by LLMServer.cancel() (generate-timeout path); the
        # engine releases the sequence's KV blocks and slot at the
        # next lifecycle scan
        self.cancelled = False
        # optional tenant attribution label (None = untagged); the
        # server's outcome paths record it on mxtpu_llm_tenant_*
        self.tenant = tenant
        # per-sequence sampling knobs (None = greedy); the engine
        # batches them into traced vectors — a temperature change can
        # never recompile the decode program
        if sampling is None:
            from .sampling import GREEDY
            sampling = GREEDY
        self.sampling = sampling
        # committed-token KV entries in the DRAFT cache (speculative
        # decoding); mirrors seq_len during prefill, rolls back with
        # rejected drafts
        self.draft_len = 0
        # set by the engine when this admission's first prefill chunk
        # has been planned (the poison-injection site fires exactly
        # once per admission, even when a prefix-cache hit makes the
        # first chunk start mid-prompt)
        self.prefill_started = False
        # chained per-block content hashes of the prompt's FULL blocks
        # (computed at admission for the prefix-cache lookup, reused
        # at registration time)
        self.prefix_hashes = None
        # prompt tokens served from the prefix cache THIS admission —
        # prefill work the sequence never paid (credited on
        # mxtpu_llm_prefill_tokens_saved_total)
        self.cache_hit_tokens = 0
        # LoRA adapter name this request decodes under (None = base
        # model); the engine resolves it to an AdapterHandle at
        # admission, pinning one published version for the sequence's
        # whole life — preemption deliberately KEEPS the handle, so
        # re-prefill after a mid-flight republish stays bit-identical
        self.adapter = adapter
        self.adapter_handle = None

    def expired(self, now=None):
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    @property
    def num_generated(self):
        """Tokens generated past the ORIGINAL prompt — preemption folds
        earlier generations into the working prompt, and they must keep
        counting against ``max_new_tokens``."""
        return (len(self.prompt) - self.orig_prompt_len
                + len(self.generated))

    @property
    def done(self):
        if self.num_generated >= self.max_new_tokens:
            return True
        return (self.stop_token is not None and self.generated
                and self.generated[-1] == self.stop_token)

    def output_tokens(self):
        """Everything generated after the ORIGINAL prompt (preemption
        folds earlier generations into the working prompt; the user
        never sees that implementation detail)."""
        all_toks = self.prompt + self.generated
        return all_toks[self.orig_prompt_len:]

    def __repr__(self):
        return (f"<Sequence {self.seq_id} {self.state} "
                f"prompt={len(self.prompt)} gen={self.num_generated}"
                f"/{self.max_new_tokens}>")


class Scheduler:
    """Slot + queue bookkeeping for one engine."""

    def __init__(self, max_seqs):
        if max_seqs < 1:
            raise ValueError(f"max_seqs must be >= 1, got {max_seqs}")
        self.max_seqs = int(max_seqs)
        self.waiting = collections.deque()
        self.slots = [None] * self.max_seqs
        self._admit_counter = itertools.count()

    # ------------------------------------------------------- queues --
    def add(self, seq):
        if seq.state != WAITING:
            raise ValueError(f"cannot enqueue {seq!r}")
        self.waiting.append(seq)

    @property
    def num_waiting(self):
        return len(self.waiting)

    def running(self):
        return [s for s in self.slots if s is not None]

    @property
    def num_running(self):
        return sum(1 for s in self.slots if s is not None)

    def has_work(self):
        return bool(self.waiting) or self.num_running > 0

    # ---------------------------------------------------- admission --
    def free_slot(self):
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def peek_waiting(self):
        return self.waiting[0] if self.waiting else None

    def place(self, seq, slot):
        """WAITING (head of queue) -> RUNNING in ``slot``."""
        if self.waiting and self.waiting[0] is seq:
            self.waiting.popleft()
        if self.slots[slot] is not None:
            raise ValueError(f"slot {slot} occupied")
        seq.state = RUNNING
        seq.slot = slot
        seq.admit_index = next(self._admit_counter)
        self.slots[slot] = seq

    # ----------------------------------------------------- retiring --
    def release(self, seq, state, reason=None):
        """Drop ``seq`` from its slot into a terminal state."""
        if seq.slot is not None:
            self.slots[seq.slot] = None
            seq.slot = None
        seq.state = state
        seq.finish_reason = reason

    def preempt(self, seq):
        """KV-pressure eviction: fold the generation into the prompt
        and requeue at the FRONT (it was making progress; it resumes
        first). Folded tokens re-prefill as FORCED tokens; the
        position-keyed sampling PRNG makes the resumed stream
        bit-identical for greedy AND sampled sequences."""
        if seq.slot is not None:
            self.slots[seq.slot] = None
            seq.slot = None
        seq.prompt = seq.prompt + seq.generated
        seq.generated = []
        seq.seq_len = 0
        seq.draft_len = 0
        seq.last_token = None
        # re-admission re-runs the prefix lookup over the folded
        # prompt (its own registered blocks usually hit, making the
        # resume cheap) and re-arms the once-per-admission sites
        seq.prefill_started = False
        seq.prefix_hashes = None
        seq.cache_hit_tokens = 0
        seq.state = WAITING
        seq.preemptions += 1
        self.waiting.appendleft(seq)

    def pick_victim(self, exclude=()):
        """Newest-ARRIVED running sequence (it has accumulated the
        least work) — the recompute-preemption victim policy. Keyed on
        ``seq_id`` (arrival order), NOT ``admit_index``: re-admission
        after a preemption issues a fresh admit_index, and keying on
        that would make the oldest preempted sequence — the one
        carrying the most folded-in work — the prime victim again,
        thrashing full prefills under sustained KV pressure."""
        cands = [s for s in self.slots
                 if s is not None and s not in exclude]
        if not cands:
            return None
        return max(cands, key=lambda s: s.seq_id)
