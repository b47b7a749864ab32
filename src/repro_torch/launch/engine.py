"""Continuous-batching serving engine over the paged KV cache (PyTorch).

Counterpart of ``repro/launch/engine.py``; the host logic (allocator,
prefix registry, scheduling, lifecycle, audit) is numpy and ports line for
line.  Requests with arbitrary prompt lengths are admitted into a
fixed-shape decode batch as rows free up, decode one token per step on
their own positions / pages / scales, and are evicted the moment they
finish — their pages recycle to the next admission.  ``jax.jit`` becomes
eager calls on fixed shapes: the decode step always sees ``(batch_size,
1)`` tokens and the fixed-size paged cache; admission prefills see one
shape per (bucket, width, prefix length).

Page-table layout (see :func:`repro_torch.models.lm.init_paged_cache`)::

    pools       (num_pages + 1, Hkv, page_size, hd[/2])   per attn layer
                 (last page = TRASH: masked writes land there, never read)
    page_table  (batch_size, max_pages) int32: row b, entry l = physical
                 page of b's logical page l; -1 = none
    pos         (batch_size,) int32: next decode position; -1 = inactive
    states      (batch_size, ...) f32 per recurrent layer: the row's
                 RG-LRU / SSD state, updated by every decode step (inactive
                 rows too) and overwritten by the row's next admission

The engine owns the refcounted allocator (:class:`PageAllocator`) and host
mirrors of ``pos`` / ``page_table``, pushed into the device cache in place
whenever admission or eviction dirties them.

Request state machine (the reference's)::

    QUEUED -> PREFILLING -> RUNNING -> DONE
    victim preemption / NaN quarantine: back to QUEUED as a bit-exact
    recompute (re-prefill the prompt, replay the recorded tokens);
    > max_preemptions -> REJECTED; ttl/deadline -> TIMED_OUT;
    cancel -> CANCELLED; impossible -> REJECTED; shutdown -> PREEMPTED.

Recurrent stacks (RecurrentGemma, Mamba2) serve as in the reference: a
prefill scans each row's whole padded chunk from a zero state, so the
tokens equal the ring path's only where a prompt fills its bucket in one
chunk (ROADMAP queue 3), and prefix sharing is off (``sharing_enabled``).

Invariants kept from the reference: the chunked-prefill cut plan is a
pure function of (prompt length, prefix length, chunk size), so the token
budget changes only WHEN chunks run; prefix sharing aliases registered
prefix pages with copy-on-write at a partial boundary page; a preempted
request resumes bit-exactly; :meth:`PagedEngine.audit` cross-checks page
conservation, refcounts, host mirrors and the per-page scale pools.

Fault injection (:mod:`repro_torch.runtime.faults`): a ``fault_plan``
is polled once a step.  Stolen pages are held out of the allocator for a
few steps (admission then reclaims registry pins and preempts victims),
a forced-fallback step runs the plain ``torch`` backend in place of the
kernels, a stall sleeps inside the watchdog window, and a NaN row is
written into one active row's logits, which the engine quarantines.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed import partition
from repro_torch.kernels import dispatch
from repro_torch.models import lm
from repro_torch.runtime import faults as faults_mod
from repro_torch.runtime.watchdog import Watchdog


class Status:
    """Request lifecycle states (see the module docstring's diagram)."""
    QUEUED = "queued"
    PREFILLING = "prefilling"     # admitted, prompt chunks still landing
    RUNNING = "running"
    DONE = "done"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    REJECTED = "rejected"
    PREEMPTED = "preempted"       # terminal only via graceful shutdown


class PageAllocator:
    """Refcounted physical-page allocator (free list + per-page refcounts).

    Invariants (property-tested in ``tests/test_engine.py``, audited
    engine-wide by :meth:`PagedEngine.audit`):

    - a page is on the free list iff its refcount is 0;
    - :meth:`alloc` only hands out ref-0 pages, in FIFO free-list order
      (fresh, exclusively owned at ref 1);
    - :meth:`share` bumps refs of LIVE pages only — it can never resurrect
      a freed page; :meth:`release` decrements and recycles at exactly
      ref == 0;
    - conservation: ``len(free) + |{p: refs[p] > 0}| == num_pages``.

    Misuse (double free, sharing a dead page, over-allocation) raises
    instead of corrupting the pool.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self.refs = [0] * num_pages
        self.free = list(range(num_pages))

    @property
    def free_count(self) -> int:
        return len(self.free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self.free):
            raise RuntimeError(
                f"allocator: need {n} pages, only {len(self.free)} free")
        pages = [self.free.pop(0) for _ in range(n)]
        for p in pages:
            if self.refs[p] != 0:
                raise RuntimeError(f"allocator: free list held live page {p}")
            self.refs[p] = 1
        return pages

    def share(self, pages):
        for p in pages:
            if self.refs[p] <= 0:
                raise RuntimeError(f"allocator: sharing dead page {p}")
            self.refs[p] += 1

    def release(self, pages):
        for p in pages:
            if self.refs[p] <= 0:
                raise RuntimeError(f"allocator: double free of page {p}")
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self.free.append(p)

    def audit(self) -> list:
        """Allocator invariant violations (empty list == healthy)."""
        v = []
        live = {p for p in range(self.num_pages) if self.refs[p] > 0}
        free = set(self.free)
        if len(self.free) != len(free):
            v.append("free list holds duplicates")
        if live & free:
            v.append(f"pages both live and free: {sorted(live & free)}")
        if len(free | live) != self.num_pages:
            v.append(f"pages leaked: {len(free)} free + {len(live)} live "
                     f"!= {self.num_pages}")
        if any(r < 0 for r in self.refs):
            v.append("negative refcount")
        return v

    def check(self) -> bool:
        """Assert the allocator invariants (used by the property tests)."""
        violations = self.audit()
        assert not violations, "; ".join(violations)
        return True


@dataclasses.dataclass
class PrefixEntry:
    """One registered (pinned) shared prefix: key -> physical pages."""
    key: tuple
    length: int                           # tokens
    pages: list                           # ceil(length / page_size) phys ids
    partial_page: Optional[int]           # last page iff length % ps != 0
    hits: int = 0


@dataclasses.dataclass
class Request:
    """One serving request (prompt in, generated tokens out)."""
    rid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # Declared shared-prefix length in tokens (a cache breakpoint, like API
    # prompt caching): requests declaring byte-identical prefixes alias the
    # same physical pages.  0 = no sharing; clamped to len(prompt) - 1 so
    # the last prompt token always prefills as tail (its logits seed
    # generation).
    prefix_len: int = 0
    # Scheduling class: higher admits first and may preempt strictly lower
    # (equal only after `preempt_after_steps` of starvation).
    priority: int = 0
    # Queued-state expiry: wall seconds since first submit / engine steps
    # since the latest (re)queue.  None = never expires.
    deadline_s: Optional[float] = None
    ttl_steps: Optional[int] = None
    # filled by the engine:
    tokens: list = dataclasses.field(default_factory=list)
    status: str = Status.QUEUED
    admitted_step: int = -1
    finished_step: int = -1
    decode_s: float = 0.0                 # wall time while this row decoded
    error: Optional[str] = None           # set when the request failed
    preemptions: int = 0                  # times this request lost its row
    cancel_requested: bool = False
    # engine-internal bookkeeping:
    _arrival: int = -1                    # global FIFO order within priority
    _submit_step: int = -1                # latest (re)queue step (TTL clock)
    _submit_time: float = 0.0             # first submit wall time (deadline)
    _not_before_step: int = 0             # preemption backoff gate
    _replay: Optional[list] = None        # resume: tokens left to replay
    _resuming: bool = False               # admitted as a recompute
    _chunk_start: int = 0                 # first tail-chunk offset (= prefix)
    _chunk_pos: int = 0                   # next prompt offset to prefill

    def cancel(self):
        """Request cancellation; the engine honours it at its next step."""
        self.cancel_requested = True

    @property
    def done(self) -> bool:
        return self.finished_step >= 0

    @property
    def failed(self) -> bool:
        return self.error is not None

    @property
    def tok_per_s(self) -> float:
        return len(self.tokens) / max(self.decode_s, 1e-9)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets}")


class PagedEngine:
    """Continuous-batching engine; see module docstring for the policy."""

    def __init__(self, cfg: lm.LMConfig, params, *, batch_size: int = 4,
                 max_len: int = 256, page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_buckets=(64,),
                 prefill_chunk: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 max_preemptions: int = 3, preempt_after_steps: int = 8,
                 backoff_cap: int = 8, audit_every: int = 0,
                 audit_raises: bool = True,
                 watchdog: Optional[Watchdog] = None,
                 fault_plan: Optional["faults_mod.FaultPlan"] = None):
        partition.refuse("the paged engine (launch/engine.py)",
                         partition.PAGED)
        self.cfg, self.params = cfg, params
        self.batch_size, self.page_size = batch_size, page_size
        self.max_pages = -(-max_len // page_size)
        self.num_pages = num_pages if num_pages is not None \
            else batch_size * self.max_pages
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        # Chunked-prefill knobs (module docstring): chunk size is clamped
        # to the largest bucket and floored to a page multiple so every
        # internal chunk boundary is page-aligned (one scale grid per
        # physical page).  A budget without an explicit chunk size chunks
        # at the budget itself.
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget
        c = prefill_chunk if prefill_chunk is not None else (
            prefill_budget if prefill_budget is not None
            else self.prefill_buckets[-1])
        self.chunk_tokens = max(page_size,
                                min(c, self.prefill_buckets[-1])
                                // page_size * page_size)
        self.device = params["embed"]["emb_q" if "emb_q" in params["embed"]
                                      else "emb"].device
        self.cache = lm.init_paged_cache(cfg, batch_size, max_len,
                                         page_size=page_size,
                                         num_pages=self.num_pages,
                                         device=self.device)
        # Host-side allocator state (authoritative; device copies pushed
        # whenever admission/eviction dirties them).
        self.alloc = PageAllocator(self.num_pages)
        self.page_table = np.full((batch_size, self.max_pages), -1, np.int32)
        self.pos = np.full((batch_size,), -1, np.int32)
        self.row_req: list[Optional[Request]] = [None] * batch_size
        self.row_pages: list[list[int]] = [[] for _ in range(batch_size)]
        self.next_tok = np.zeros((batch_size,), np.int32)
        self.queue: list[Request] = []
        self.rejected: list[Request] = []
        self.cancelled: list[Request] = []
        self.expired: list[Request] = []
        self.preempted_out: list[Request] = []   # terminal via shutdown()
        self.step_count = 0
        self.prefill_calls = 0            # logical admission prefills
        self.prefill_chunks = 0           # ragged chunk launches (>= calls)
        self.prefill_tokens = 0           # real (unpadded) tokens prefilled
        self.prefix_prefills = 0          # chunk-1 (shared prefix) launches
        self.shared_prefix_hits = 0       # admissions served off the registry
        self.preempt_count = 0            # victim preemptions (incl. NaN)
        self.resume_count = 0             # recompute readmissions
        self.violations: list[str] = []   # audit / replay-divergence log
        # Failure-handling policy knobs (module docstring).
        self.max_preemptions = max_preemptions
        self.preempt_after_steps = preempt_after_steps
        self.backoff_cap = backoff_cap
        self.audit_every = audit_every
        self.audit_raises = audit_raises
        self.faults = fault_plan
        self._fault_held: list[tuple[int, list]] = []   # (release_step, pgs)
        self.watchdog = watchdog if watchdog is not None else Watchdog()
        self._wd_user_cb = self.watchdog.on_straggler
        self.watchdog.on_straggler = self._on_straggler
        self._arrival_seq = 0
        # Shared-prefix registry: token-block-hash chain -> pinned pages.
        # Insertion-ordered dict doubles as the LRU (reinserted on hit).
        self.prefix_registry: dict[tuple, PrefixEntry] = {}
        # CoW copies queued at admission, performed after this drain's
        # chunk-1 prefills (a same-drain sharer must not copy a boundary
        # page whose prefix codes have not been written yet).
        self._pending_cow: list[tuple[int, int]] = []
        self.sharing_enabled = all(k in ("attn", "local")
                                   for k in lm.block_kinds(cfg))
        self._dirty = True

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _admit_prefill(self, toks, lens, rows, page_table, prefix_len):
        """One ragged admission prefill launch (lm.admission_prefill)."""
        return lm.admission_prefill(
            self.params, {"tokens": self._tensor(toks),
                          "lengths": self._tensor(lens)},
            self.cfg, self.cache, self._tensor(rows),
            self._tensor(page_table), prefix_len=prefix_len)

    # -- allocator ---------------------------------------------------------

    @property
    def free_pages(self) -> list:
        """Ref-0 pages, FIFO order (the allocator's free list)."""
        return self.alloc.free

    def _pages_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)

    def _effective_prefix(self, req: Request) -> int:
        """The declared breakpoint, clamped so at least one token prefills
        as tail (its logits seed generation); 0 when sharing is off."""
        if not self.sharing_enabled or not req.prefix_len:
            return 0
        return max(0, min(int(req.prefix_len), len(req.prompt) - 1))

    # -- chunked prefill (module docstring: the cut plan is canonical) -----

    def _chunking(self) -> bool:
        """Whether a chunk size / token budget was configured."""
        return (self.prefill_chunk is not None
                or self.prefill_budget is not None)

    def _is_chunked(self, req: Request, plen: int) -> bool:
        """Whether this admission prefills through the PREFILLING path:
        always when chunking is configured (so the budget bounds ALL
        prefill work per step), otherwise only for tails the one-shot
        path cannot express (over the largest bucket)."""
        return self._chunking() or (len(req.prompt) - plen
                                    > self.prefill_buckets[-1])

    def _next_cut(self, cur: int, total: int) -> int:
        """Next chunk boundary after ``cur``: the following multiple of
        ``chunk_tokens`` (page-aligned by construction), clamped to
        ``total``.  A pure function of (cur, total, chunk_tokens) — the
        budget decides only WHICH STEP a chunk launches, never where its
        boundaries fall, so chunked prefill is scheduling-invariant."""
        c = self.chunk_tokens
        return min(total, (cur // c + 1) * c)

    def _prefix_key(self, toks) -> tuple:
        """Registry key: the chain of per-page token-block hashes."""
        t = np.ascontiguousarray(np.asarray(toks, np.int32))
        ps = self.page_size
        return tuple(hashlib.sha1(t[i:i + ps].tobytes()).hexdigest()
                     for i in range(0, len(t), ps))

    def _req_key(self, req: Request, plen: int) -> tuple:
        """This request's registry key, hashed once and cached on the
        request (``can_admit`` runs every drain for a blocked queue head —
        re-sha1-ing a long prefix per decode step would be pure waste)."""
        key = getattr(req, "_prefix_key_cache", None)
        if key is None:
            key = self._prefix_key(req.prompt[:plen])
            req._prefix_key_cache = key
        return key

    def _lookup_prefix(self, req: Request, plen: int):
        """Registered entry for this request's declared prefix, or None."""
        if not plen:
            return None
        entry = self.prefix_registry.get(self._req_key(req, plen))
        return entry if entry is not None and entry.length == plen else None

    def _fresh_pages_needed(self, req: Request) -> int:
        """Worst-case reservation, net of registered shared pages: a
        sharer allocates fresh pages only for its tail + generation (plus
        one CoW copy target when the boundary page is partial — already
        counted, since only FULL prefix pages are subtracted)."""
        need = self._pages_needed(req)
        plen = self._effective_prefix(req)
        entry = self._lookup_prefix(req, plen)
        if entry is not None:
            need -= plen // self.page_size
        return need

    def can_admit(self, req: Request) -> bool:
        need = self._pages_needed(req)
        # need <= max_pages: the request must also FIT one page-table row
        # (prompt + generation bounded by max_len), not just the free pool.
        return (None in self.row_req and need <= self.max_pages
                and self.alloc.free_count >= self._fresh_pages_needed(req))

    def submit(self, req: Request):
        req.status = Status.QUEUED
        req._arrival = self._arrival_seq
        self._arrival_seq += 1
        req._submit_step = self.step_count
        req._submit_time = time.monotonic()
        self.queue.append(req)

    def cancel(self, rid: int) -> bool:
        """Flag the queued or running request ``rid`` for cancellation."""
        for req in self.queue + [r for r in self.row_req if r is not None]:
            if req.rid == rid:
                req.cancel()
                return True
        return False

    # -- admission ---------------------------------------------------------

    def _cow_copy(self, src: int, dst: int):
        """Copy-on-write: duplicate physical page ``src`` (codes + per-page
        scales, every attention layer — ``lm.copy_page``) into the
        sharer-owned page ``dst`` before the first divergent write lands in
        it.  The donor's page — and therefore its subsequent tokens — are
        untouched."""
        self.cache = lm.copy_page(self.cache, src, dst)
        dispatch.STATS["cow_page_copies"] += 1

    def _admit(self, req: Request, row: int):
        """Host-side admission: reserve the worst-case page count into the
        row's table and claim the row.  The prompt itself prefills later in
        this drain (:meth:`_prefill_prefix` for a newly registered prefix,
        then :meth:`_prefill_group` for the tail, batched with every other
        admission of the same (prefix, bucket) group).

        A registry HIT aliases the entry's full pages (refcount bump) and
        CoW-copies a partial boundary page; a MISS with a declared prefix
        allocates fresh pages and REGISTERS them (the registry takes its
        own pinning ref, so the prefix outlives this request's eviction).

        A readmission after preemption (``req.preemptions > 0`` with
        recorded tokens) is the SAME admission — identical prompt, prefix
        declaration and bucket, hence bit-identical prefill — plus a
        replay queue of the already-generated tokens (see :meth:`step`).
        """
        need = self._pages_needed(req)
        plen = self._effective_prefix(req)
        entry = self._lookup_prefix(req, plen)
        if entry is not None:                           # ---- sharer
            full = plen // self.page_size
            shared = list(entry.pages[:full])
            fresh = self.alloc.alloc(need - full)
            self.alloc.share(shared)
            pages = shared + fresh
            if entry.partial_page is not None:
                # First divergent write will land inside the partially
                # filled boundary page: copy it into the sharer's own page
                # (deferred until after this drain's chunk-1 prefills).
                # The source takes a ref for the pendency window, so a
                # same-drain registry reclaim can neither free it nor let
                # another donor's chunk-1 overwrite it before the copy.
                self.alloc.share([entry.partial_page])
                self._pending_cow.append((entry.partial_page, pages[full]))
            entry.hits += 1
            self.shared_prefix_hits += 1
            key = entry.key                             # LRU: move to back
            self.prefix_registry[key] = self.prefix_registry.pop(key)
        else:
            pages = self.alloc.alloc(need)
            if plen:                                    # ---- donor
                npre = -(-plen // self.page_size)
                entry = PrefixEntry(
                    key=self._req_key(req, plen), length=plen,
                    pages=list(pages[:npre]),
                    partial_page=pages[npre - 1]
                    if plen % self.page_size else None)
                self.alloc.share(entry.pages)           # registry pin
                self.prefix_registry[entry.key] = entry
        self.row_pages[row] = pages
        self.page_table[row] = -1
        self.page_table[row, :need] = pages
        chunked = self._is_chunked(req, plen)
        # A chunked admission freezes its row (pos -1: the shared decode
        # step attends nothing, masked writes land in the TRASH page)
        # until the final chunk seeds generation (_launch_chunk).
        self.pos[row] = -1 if chunked else len(req.prompt)
        self.row_req[row] = req
        req.admitted_step = self.step_count
        req.status = Status.PREFILLING if chunked else Status.RUNNING
        req._chunk_start = plen
        req._chunk_pos = plen
        req._resuming = bool(req.preemptions and req.tokens)
        self._dirty = True

    def _reclaim_one(self, skip: Optional[tuple] = None) -> bool:
        """Release the LRU registry entry's pin (pages recycle once no
        running row still holds them).  ``skip`` protects the key the
        pending admission is about to hit."""
        for key in self.prefix_registry:
            if key != skip:
                entry = self.prefix_registry.pop(key)
                self.alloc.release(entry.pages)
                return True
        return False

    # -- failure handling --------------------------------------------------

    def _terminal(self, req: Request, status: str, error: Optional[str]):
        req.status = status
        if error is not None:
            req.error = error
        req.finished_step = self.step_count
        {Status.REJECTED: self.rejected,
         Status.CANCELLED: self.cancelled,
         Status.TIMED_OUT: self.expired,
         Status.PREEMPTED: self.preempted_out}[status].append(req)

    def _violation(self, msg: str):
        """Record an engine-invariant violation (never crashes serving)."""
        self.violations.append(msg)
        dispatch.STATS["audit_failures"] += 1

    def _release_row(self, row: int):
        """Return a row and its pages to the engine (no req bookkeeping)."""
        self.alloc.release(self.row_pages[row])
        self.row_pages[row] = []
        self.row_req[row] = None
        self.page_table[row] = -1
        self.pos[row] = -1
        self._dirty = True

    def _preempt_row(self, row: int, cause: str):
        """Evict a victim and re-enqueue it as a bit-exact recompute.

        Non-shared pages recycle immediately (shared prefix pages keep
        their registry pins and other holders' refs); the request keeps
        its recorded tokens and re-enters the queue behind an exponential
        backoff gate.  Past ``max_preemptions`` it is terminally REJECTED
        instead — preemption never thrashes forever.
        """
        req = self.row_req[row]
        self._release_row(row)
        req.preemptions += 1
        req._replay = None
        req._resuming = False
        self.preempt_count += 1
        dispatch.STATS["preemptions"] += 1
        if req.preemptions > self.max_preemptions:
            self._terminal(req, Status.REJECTED,
                           f"preempted {req.preemptions} times "
                           f"(last cause: {cause}); giving up")
            return
        req.status = Status.QUEUED
        req._submit_step = self.step_count          # starvation clock resets
        req._not_before_step = self.step_count + min(
            1 << (req.preemptions - 1), self.backoff_cap)
        self.queue.append(req)

    def _quarantine(self, row: int):
        """Non-finite logits in one row: discard the poisoned step and
        recompute the request on clean pages (same path as preemption —
        the recorded tokens predate the corruption, so the resume is
        bit-exact).  Neighbour rows are untouched."""
        dispatch.STATS["quarantined"] += 1
        self._preempt_row(row, "non-finite logits in the dequant epilogue")

    def _pick_victim(self, req: Request, admitted_now) -> Optional[int]:
        """Choose a row to preempt for ``req``: strictly lower priority
        always; equal priority only once ``req`` has starved for
        ``preempt_after_steps``.  Lowest priority first, then the
        youngest admission (least recompute waste).  Rows admitted in the
        current drain are never victims; a PREFILLING row from an earlier
        step may be — its chunk cursor resets on readmission, so the
        resume re-prefills bit-exactly from chunk 0."""
        starved = (self.step_count - req._submit_step
                   >= self.preempt_after_steps)
        best = None
        for row, vreq in enumerate(self.row_req):
            if vreq is None or id(vreq) in admitted_now or (
                    not vreq.tokens
                    and vreq.status != Status.PREFILLING):
                continue
            if vreq.priority < req.priority or (starved
                                                and vreq.priority
                                                <= req.priority):
                key = (vreq.priority, -vreq.admitted_step)
                if best is None or key < best[0]:
                    best = (key, row)
        return None if best is None else best[1]

    def _make_room(self, req: Request, plen: int, admitted_now) -> bool:
        """Admission pressure ladder: free capacity -> registry LRU
        reclaim -> victim preemption.  True once ``req`` fits."""
        if self.can_admit(req):
            return True
        own = self._req_key(req, plen) if plen else None
        while not self.can_admit(req) and self._reclaim_one(own):
            pass
        while not self.can_admit(req):
            victim = self._pick_victim(req, admitted_now)
            if victim is None:
                return False
            self._preempt_row(victim, f"pool pressure admitting "
                                      f"request {req.rid}")
            while not self.can_admit(req) and self._reclaim_one(own):
                pass
        return True

    def _apply_faults_pre(self):
        """Release expired fault holds; apply this step's injected
        allocator exhaustion (pages stolen out of the free list)."""
        due = [(s, p) for s, p in self._fault_held if s <= self.step_count]
        self._fault_held = [(s, p) for s, p in self._fault_held
                            if s > self.step_count]
        for _, pages in due:
            self.alloc.release(pages)
        ev = self.faults.at_step(self.step_count) if self.faults else None
        if ev is not None and ev.steal_pages:
            pages = self.alloc.alloc(min(ev.steal_pages,
                                         self.alloc.free_count))
            if pages:
                self._fault_held.append(
                    (self.step_count + max(1, ev.steal_hold), pages))
        return ev

    def _process_lifecycle(self):
        """Cancellation (queued + mid-flight) and queued-state expiry."""
        now = time.monotonic()
        keep = []
        for req in self.queue:
            if req.cancel_requested:
                self._terminal(req, Status.CANCELLED,
                               "cancelled while queued")
                dispatch.STATS["cancelled"] += 1
            elif (req.ttl_steps is not None
                  and self.step_count - req._submit_step >= req.ttl_steps):
                self._terminal(req, Status.TIMED_OUT,
                               f"expired after {req.ttl_steps} queued steps")
                dispatch.STATS["expired"] += 1
            elif (req.deadline_s is not None
                  and now - req._submit_time >= req.deadline_s):
                self._terminal(req, Status.TIMED_OUT,
                               f"deadline {req.deadline_s}s passed while "
                               f"queued")
                dispatch.STATS["expired"] += 1
            else:
                keep.append(req)
        self.queue = keep
        for row, req in enumerate(self.row_req):
            if req is not None and req.cancel_requested:
                self._release_row(row)
                self._terminal(req, Status.CANCELLED, "cancelled mid-flight")
                dispatch.STATS["cancelled"] += 1

    def _on_straggler(self, dt: float, ema: float):
        dispatch.STATS["watchdog_fires"] += 1
        if self._wd_user_cb is not None:
            self._wd_user_cb(dt, ema)

    def _step_fallback(self, tok):
        """The decode step on the plain ``torch`` backend, for forced
        fallback fault steps.  It is selected explicitly, also when the
        engine already runs that backend; a model whose
        ``QuantConfig.backend`` is set keeps it, as in the reference."""
        with dispatch.use_backend("torch"):
            return lm.decode_step(self.params, tok, self.cache, self.cfg)

    # -- drain / prefill ---------------------------------------------------

    def _drain_queue(self):
        """Admit every admittable queued request, then prefill: first one
        chunk-1 launch per NEWLY REGISTERED prefix (so same-drain sharers
        read codes that already exist), then ONE batched tail prefill per
        (prefix length, tail bucket) group.  Chunked admissions (tail
        over the largest bucket, or any admission once ``prefill_chunk``/
        ``prefill_budget`` is configured) only reserve their pages and
        enter PREFILLING here — their chunks launch under the token
        budget in :meth:`_advance_prefills`.

        The scan runs in (priority desc, arrival) order.  Requests that
        can NEVER run — worst-case pages over the page-table row or the
        whole pool — are rejected in place (``Request.error``, naming the
        offending quantity) instead of blocking the head of the queue.
        Requests in preemption backoff are skipped without blocking.  A
        merely-blocked servable request stops admission behind it (FIFO
        within priority) after the pressure ladder — registry LRU
        reclaim, then victim preemption (:meth:`_make_room`) — fails.
        """
        admits = []
        admitted_now: set = set()
        self.queue.sort(key=lambda r: (-r.priority, r._arrival))
        i = 0
        while i < len(self.queue):
            req = self.queue[i]
            plen = self._effective_prefix(req)
            need = self._pages_needed(req)
            if need > self.max_pages:
                self.queue.pop(i)
                self._terminal(req, Status.REJECTED,
                               f"needs {need} pages but a sequence may hold "
                               f"at most {self.max_pages}")
                continue
            if need > self.num_pages:
                self.queue.pop(i)
                self._terminal(req, Status.REJECTED,
                               f"needs {need} pages but the pool has only "
                               f"{self.num_pages}")
                continue
            if req._not_before_step > self.step_count:
                i += 1                              # backoff: skip, no block
                continue
            if not self._make_room(req, plen, admitted_now):
                break
            self.queue.pop(i)
            row = self.row_req.index(None)
            # donor-ness decided BEFORE _admit registers the prefix
            donor = plen > 0 and self._lookup_prefix(req, plen) is None
            self._admit(req, row)
            admitted_now.add(id(req))
            admits.append((req, row, plen, donor))
        for req, row, plen, donor in admits:
            if donor:
                self._prefill_prefix(req, row, plen)
        for src, dst in self._pending_cow:
            self._cow_copy(src, dst)
            self.alloc.release([src])           # pendency ref (see _admit)
        self._pending_cow.clear()
        groups: dict[tuple, list] = {}
        for req, row, plen, donor in admits:
            if req.status == Status.PREFILLING:
                continue                # chunked: _advance_prefills launches
            b = _bucket(len(req.prompt) - plen, self.prefill_buckets)
            groups.setdefault((plen, b), []).append((req, row))
        for plen, bucket in sorted(groups):
            self._prefill_group(bucket, groups[(plen, bucket)], plen)

    def _count_chunk(self, tokens: int, first: bool):
        """Prefill accounting (module docstring): one logical call per
        plan-beginning launch, one chunk per launch, real tokens."""
        if first:
            self.prefill_calls += 1
            dispatch.STATS["prefill_calls"] += 1
        self.prefill_chunks += 1
        self.prefill_tokens += tokens
        dispatch.STATS["prefill_chunks"] += 1
        dispatch.STATS["prefill_tokens"] += tokens

    def _prefill_prefix(self, req: Request, row: int, plen: int):
        """Chunk-1: prefill a newly registered prefix ONCE, into its pinned
        pages.  A pure function of the prefix tokens (W=1, buckets from
        the canonical cut plan, pages only name where codes land), so
        every future sharer — and this request's own solo baseline —
        reads exactly these codes and scales.  Logits are discarded:
        generation is seeded by the tail chunk.

        A prefix longer than ``chunk_tokens`` (or the largest bucket)
        prefills as a sequence of page-aligned chunks — the same cut plan
        as tail chunking — launched synchronously within this drain, so
        same-drain sharers and CoW copies always read complete codes."""
        npre = -(-plen // self.page_size)
        ptw = np.full((1, self.max_pages), -1, np.int32)
        ptw[0, :npre] = self.row_pages[row][:npre]
        one_shot = (plen <= self.prefill_buckets[-1]
                    and not self._chunking())
        cur = 0
        while cur < plen:
            end = plen if one_shot else self._next_cut(cur, plen)
            bucket = _bucket(end - cur, self.prefill_buckets)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :end - cur] = req.prompt[cur:end]
            _, self.cache = self._admit_prefill(
                toks, np.asarray([end - cur], np.int32),
                np.asarray([row], np.int32), ptw, cur)
            self._count_chunk(end - cur, first=cur == 0)
            cur = end
        self.prefix_prefills += 1

    def _prefill_group(self, bucket: int, group, prefix_len: int = 0):
        """One batched ragged admission prefill: W prompt TAILS of one
        (prefix, bucket) group land their KV codes directly in the shared
        pools at the reserved physical pages (lm.admission_prefill) — no
        private batch=1 cache and no page-copy pass.  The one-shot face
        of :meth:`_launch_chunk` (every row's single chunk is both first
        and final)."""
        self._launch_chunk(prefix_len, bucket,
                           [(req, row, len(req.prompt))
                            for req, row in group])

    def _launch_chunk(self, start: int, bucket: int, items):
        """One batched ragged prefill launch: W chunks sharing (start
        offset, bucket).  ``items`` is [(req, row, end)] — prefill
        ``req.prompt[start:end]`` into the row's reserved pages with
        ``prefix_len=start``, so the chunk attends every already-written
        token [0, start) through its stored codes and per-page scale
        grids.  A pure function of (tokens, start, end) per row: batching
        width and launch step never change the codes (the batched-admission
        and prefix-sharing invariant, extended to chunks).

        Rows whose chunk is FINAL (end == len(prompt)) take their first
        generated token from the launch logits and enter decode; a
        resumed recompute instead cross-checks the recorded first token
        and re-enters decode in REPLAY mode — finishing immediately when
        it was preempted after already recording its final token.
        Non-final rows stay PREFILLING, frozen at pos -1."""
        w = len(items)
        toks = np.zeros((w, bucket), np.int32)
        lens = np.zeros((w,), np.int32)
        ptw = np.full((w, self.max_pages), -1, np.int32)
        rows = np.zeros((w,), np.int32)
        for j, (req, row, end) in enumerate(items):
            seg = req.prompt[start:end]
            toks[j, :len(seg)] = seg
            lens[j] = len(seg)
            ptw[j] = self.page_table[row]
            rows[j] = row
        logits, self.cache = self._admit_prefill(toks, lens, rows, ptw,
                                                 start)
        self._count_chunk(int(lens.sum()),
                          first=any(req._chunk_start == start
                                    for req, _, _ in items))
        first = torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu() \
            .numpy()
        for j, (req, row, end) in enumerate(items):
            req._chunk_pos = end
            if end < len(req.prompt):
                continue                    # mid-prefill: row stays frozen
            if req.status == Status.PREFILLING:
                req.status = Status.RUNNING
                self.pos[row] = len(req.prompt)
                self._dirty = True
            if req._resuming:
                if int(first[j]) != req.tokens[0]:
                    self._violation(
                        f"resume prefill diverged for request {req.rid}: "
                        f"recomputed {int(first[j])} != recorded "
                        f"{req.tokens[0]}")
                self.next_tok[row] = req.tokens[0]
                req._replay = list(req.tokens[1:]) or None
                req._resuming = False
                self.resume_count += 1
                dispatch.STATS["resumes"] += 1
                if req._replay is None:
                    # Preempted after already recording its final token
                    # (EOS or max_new reached): finish NOW — the row must
                    # not decode (and record) past its terminal state.
                    self._maybe_finish(row, req.tokens[-1])
                continue
            self.next_tok[row] = first[j]
            req.tokens.append(int(first[j]))
            self._maybe_finish(row, int(first[j]))

    def _advance_prefills(self):
        """Token-budget packer: launch pending chunks for PREFILLING rows.

        Packs chunks round-robin over PREFILLING rows in admission order
        until ``prefill_budget`` tokens are spent (unlimited when None),
        with a floor of one chunk per step so a chunk larger than the
        budget still makes progress.  Chunks sharing (start, bucket)
        batch into one ragged launch; launches run in ascending start
        order, so a row's chunk i+1 always reads codes chunk i already
        wrote.  The budget changes only the launch schedule — the cut
        plan (and therefore every code and token) is fixed by
        :meth:`_next_cut`."""
        pending = sorted(
            (req.admitted_step, req._arrival, row)
            for row, req in enumerate(self.row_req)
            if req is not None and req.status == Status.PREFILLING)
        if not pending:
            return
        order = [row for _, _, row in pending]
        budget = self.prefill_budget
        cursors = {row: self.row_req[row]._chunk_pos for row in order}
        spent, taken = 0, []
        progressed = True
        while progressed and (budget is None or spent < budget):
            progressed = False
            for row in order:
                req = self.row_req[row]
                cur = cursors[row]
                if cur >= len(req.prompt):
                    continue
                end = self._next_cut(cur, len(req.prompt))
                if budget is not None and taken \
                        and spent + (end - cur) > budget:
                    continue
                taken.append((req, row, cur, end))
                cursors[row] = end
                spent += end - cur
                progressed = True
        groups: dict[tuple, list] = {}
        for req, row, cur, end in taken:
            b = _bucket(end - cur, self.prefill_buckets)
            groups.setdefault((cur, b), []).append((req, row, end))
        for start, b in sorted(groups):
            self._launch_chunk(start, b, groups[(start, b)])

    def _maybe_finish(self, row: int, tok: int):
        req = self.row_req[row]
        if req is None:
            return
        if ((req.eos_id is not None and tok == req.eos_id)
                or len(req.tokens) >= req.max_new_tokens):
            self._evict(row)

    def _evict(self, row: int):
        req = self.row_req[row]
        req.finished_step = self.step_count
        req.status = Status.DONE
        self._release_row(row)

    # -- auditing ----------------------------------------------------------

    def audit(self, raise_on_fail: Optional[bool] = None) -> list:
        """Engine-wide invariant audit; returns the violation list.

        Cross-checks, beyond :meth:`PageAllocator.audit`:

        - every physical page's refcount equals its independently counted
          holders: rows' page lists + registry pins + CoW pendency refs +
          fault-injection holds;
        - host mirrors are consistent: ``page_table`` rows mirror
          ``row_pages`` exactly (-1 beyond), inactive rows are fully
          cleared (``pos == -1``), and an active row's ``pos`` sits inside
          [len(prompt), len(prompt) + len(tokens) - 1] (the upper bound is
          exact once replay has drained);
        - per-physical-page scale pools (``page_k_scale``/``page_v_scale``
          in every attention layer) are finite and positive — a NaN/zero
          grid would silently corrupt every future write to that page.

        Failures bump ``STATS["audit_failures"]`` and are kept in
        ``self.violations``; with ``raise_on_fail`` (default: the
        engine's ``audit_raises``) a RuntimeError carries them.
        """
        v = list(self.alloc.audit())
        holders = Counter(p for pages in self.row_pages for p in pages)
        pins = Counter(p for e in self.prefix_registry.values()
                       for p in e.pages)
        pend = Counter(src for src, _ in self._pending_cow)
        held = Counter(p for _, pages in self._fault_held for p in pages)
        for p in range(self.num_pages):
            expect = holders[p] + pins[p] + pend[p] + held[p]
            if self.alloc.refs[p] != expect:
                v.append(f"page {p}: refcount {self.alloc.refs[p]} != "
                         f"{holders[p]} row holders + {pins[p]} registry "
                         f"pins + {pend[p]} CoW pendency + {held[p]} fault "
                         f"holds")
        for row in range(self.batch_size):
            req, pages = self.row_req[row], self.row_pages[row]
            if req is None:
                if pages:
                    v.append(f"row {row}: free row still holds {pages}")
                if self.pos[row] != -1:
                    v.append(f"row {row}: free row has pos {self.pos[row]}")
                if np.any(self.page_table[row] != -1):
                    v.append(f"row {row}: free row has live table entries")
                continue
            need = self._pages_needed(req)
            if len(pages) != need:
                v.append(f"row {row}: holds {len(pages)} pages, "
                         f"reservation is {need}")
            if list(self.page_table[row, :len(pages)]) != pages:
                v.append(f"row {row}: page_table mirror != row_pages")
            if np.any(self.page_table[row, len(pages):] != -1):
                v.append(f"row {row}: table entries beyond the reservation")
            if req.status is Status.PREFILLING:
                if int(self.pos[row]) != -1:
                    v.append(f"row {row}: PREFILLING row has pos "
                             f"{int(self.pos[row])}, expected -1 (frozen)")
                if not (0 <= req._chunk_pos < len(req.prompt)):
                    v.append(f"row {row}: chunk cursor {req._chunk_pos} "
                             f"outside [0, {len(req.prompt)})")
                continue
            lo = len(req.prompt)
            hi = lo + max(len(req.tokens) - 1, 0)
            if not (lo <= int(self.pos[row]) <= hi):
                v.append(f"row {row}: pos {int(self.pos[row])} outside "
                         f"[{lo}, {hi}] for request {req.rid}")
            elif req._replay is None and req._resuming is False \
                    and int(self.pos[row]) != hi:
                v.append(f"row {row}: pos {int(self.pos[row])} != {hi} "
                         f"with no replay pending")
        for path, kpool, vpool in lm.page_scale_pools(self.cache):
            for name, pool in (("page_k_scale", kpool),
                               ("page_v_scale", vpool)):
                # the trailing TRASH page takes masked writes with
                # whatever rowscale the lane computed — exempt it
                arr = pool[..., :self.num_pages].cpu().numpy()
                if not np.all(np.isfinite(arr)):
                    v.append(f"{path}.{name}: non-finite page scale")
                elif not np.all(arr > 0):
                    v.append(f"{path}.{name}: non-positive page scale")
        if v:
            self.violations.extend(v)
            dispatch.STATS["audit_failures"] += 1
            do_raise = self.audit_raises if raise_on_fail is None \
                else raise_on_fail
            if do_raise:
                raise RuntimeError("engine audit failed: " + "; ".join(v))
        return v

    def _audit_maybe(self):
        if self.audit_every and self.step_count % self.audit_every == 0:
            self.audit()

    # -- serving loop ------------------------------------------------------

    def _push_tables(self):
        if self._dirty:
            self.cache["pos"].copy_(torch.from_numpy(self.pos))
            self.cache["page_table"].copy_(torch.from_numpy(self.page_table))
            self._dirty = False

    def step(self) -> bool:
        """One engine step: fault injection -> lifecycle (cancel/expire) ->
        drain admissions (one batched prefill per group, preempting victims
        under pressure) -> advance chunked prefills -> decode one token for
        every active row (replaying recorded tokens for resumed rows) ->
        quarantine non-finite rows -> periodic audit.

        Returns False when there is nothing left to do.
        """
        ev = self._apply_faults_pre()
        self._process_lifecycle()
        self._drain_queue()
        self._advance_prefills()
        active = [r for r, req in enumerate(self.row_req)
                  if req is not None and req.status is Status.RUNNING]
        if not active:
            if self.queue or any(req is not None for req in self.row_req):
                # Everything queued is gated on preemption backoff or on
                # fault-held pages: tick time forward so the gates expire.
                self.step_count += 1
                self._audit_maybe()
                return True
            return False
        self._push_tables()
        forced = ev is not None and ev.force_xla
        if forced:
            dispatch.STATS["forced_xla_steps"] += 1
        self.watchdog.start()
        if ev is not None and ev.stall_s:
            time.sleep(ev.stall_s)              # straggler, seen by the EMA
        t0 = time.perf_counter()
        tok = self._tensor(self.next_tok)[:, None]
        if forced:
            logits, self.cache = self._step_fallback(tok)
        else:
            logits, self.cache = lm.decode_step(self.params, tok, self.cache,
                                                self.cfg)
        if ev is not None and ev.nan_row is not None:
            logits = faults_mod.corrupt_rows(
                logits, [active[ev.nan_row % len(active)]])
        last = logits[:, 0]
        nxt = torch.argmax(last, dim=-1).to(torch.int32).cpu().numpy()
        finite = torch.isfinite(last).all(dim=-1).cpu().numpy()
        dt = time.perf_counter() - t0
        self.watchdog.stop()
        self.pos[self.pos >= 0] += 1          # mirror the device update
        self.step_count += 1
        for row in active:
            req = self.row_req[row]
            req.decode_s += dt
            if not finite[row]:
                self._quarantine(row)
                continue
            if req._replay:
                expect = req._replay.pop(0)
                if int(nxt[row]) != expect:
                    self._violation(
                        f"replay diverged for request {req.rid}: recomputed "
                        f"{int(nxt[row])} != recorded {expect}")
                self.next_tok[row] = expect
                if not req._replay:
                    req._replay = None
                    # Replay has drained: a recorded stream that was already
                    # terminal finishes now.
                    self._maybe_finish(row, expect)
                continue
            req._replay = None
            req.tokens.append(int(nxt[row]))
            self.next_tok[row] = nxt[row]
            self._maybe_finish(row, int(nxt[row]))
        self._audit_maybe()
        return True

    def shutdown(self):
        """Graceful drain (SIGTERM/SIGUSR1 path): stop serving NOW.

        Queued requests are terminally PREEMPTED with an error (never
        admitted); in-flight rows are released with their PARTIAL token
        streams kept (status PREEMPTED, no error — the work delivered so
        far is valid and, being deterministic, resumable by a restarted
        engine from prompt + tokens).  Fault holds are dropped so the
        allocator conserves; the registry keeps its pins (a restart may
        rebuild onto them)."""
        for req in list(self.queue):
            self._terminal(req, Status.PREEMPTED,
                           "preempted before admission (engine shutdown)")
        self.queue.clear()
        for row, req in enumerate(self.row_req):
            if req is not None:
                self._release_row(row)
                self._terminal(req, Status.PREEMPTED, None)
        for _, pages in self._fault_held:
            self.alloc.release(pages)
        self._fault_held.clear()

    def run(self, requests=None) -> list:
        """Serve ``requests`` (plus anything already queued) to completion."""
        done: list[Request] = []
        for r in requests or []:
            self.submit(r)
        track = list(self.queue) + [r for r in self.row_req if r is not None]
        while self.step():
            pass
        done.extend(track)
        return done
