"""Continuous batching over a paged KV cache.

Same scheduling discipline as `runtime.scheduler.Scheduler` (slot pool,
fragment prefill, chunked decode, EOS latching) but KV state lives in a
shared page pool: memory scales with tokens actually resident instead of
max_batch * max_seq.  Admission allocates pages for the prompt; each
decode chunk tops slots up; retirement returns pages to the free list.

Dead/free slots have their table rows pointed at a reserved trash page,
so their (masked, EOS-latched) decode writes can never corrupt a live
sequence's pages.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from functools import partial
from typing import Deque, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models.llama import (
    LlamaParams,
    forward_paged_decode,
    forward_paged_prefill,
    logits_from_hidden,
)
from tokenhawk_tpu.runtime.engine import _bucket
from tokenhawk_tpu.runtime.paged import PageAllocator, PagedKVCache
from tokenhawk_tpu.runtime.scheduler import Request
from tokenhawk_tpu.sampling import is_eos as _is_eos
from tokenhawk_tpu.sampling import normalize_eos
from tokenhawk_tpu.tokenizer import EOS_ID


@partial(jax.jit, donate_argnums=(1, 2, 3, 4, 5))
def _admit_state_paged(logits, sp, counters, last_tok, last_n, done, slot,
                       ring, slot_sp):
    """Fused admission state update: sample the first token from the
    prefill logits and write every per-slot device field in one
    dispatch (see PagedScheduler._activate)."""
    from tokenhawk_tpu.sampling import sample_dynamic

    first = sample_dynamic(logits, slot_sp, jnp.zeros((1,), jnp.int32),
                           ring[None, :])[0]
    sp = jax.tree_util.tree_map(lambda a, v: a.at[slot].set(v[0]),
                                sp, slot_sp)
    counters = counters.at[slot].set(1)
    last_tok = last_tok.at[slot].set(first)
    last_n = last_n.at[slot].set(
        jnp.concatenate([ring[1:], first[None]]))
    done = done.at[slot].set(False)
    return sp, counters, last_tok, last_n, done, first


@partial(jax.jit, donate_argnums=(1, 2, 3, 4, 5))
def _admit_state_paged_many(logits, sp, counters, last_tok, last_n, done,
                            slots, rings, slot_sp):
    """N-admission generalization of _admit_state_paged: one dispatch
    samples every newly-admitted slot's first token from the batched
    prefill logits [Nb, V] and scatters all per-slot state.  Padding
    rows (the prefill is bucket-padded) carry an out-of-range slot index
    and drop at the scatter."""
    from tokenhawk_tpu.sampling import sample_dynamic

    n = logits.shape[0]
    first = sample_dynamic(logits, slot_sp, jnp.zeros((n,), jnp.int32),
                           rings)
    sp = jax.tree_util.tree_map(
        lambda a, v: a.at[slots].set(v, mode="drop"), sp, slot_sp)
    counters = counters.at[slots].set(1, mode="drop")
    last_tok = last_tok.at[slots].set(first, mode="drop")
    last_n = last_n.at[slots].set(
        jnp.concatenate([rings[:, 1:], first[:, None]], axis=1),
        mode="drop")
    done = done.at[slots].set(False, mode="drop")
    return sp, counters, last_tok, last_n, done, first


def make_paged_decode_fn_dynamic(cfg: LlamaConfig, chunk: int,
                                 eos_id: int = EOS_ID):
    """Paged decode with per-slot traced sampling parameters (see
    engine.make_decode_fn_dynamic)."""
    from tokenhawk_tpu.sampling import sample_dynamic

    eos0, eos_ids = normalize_eos(eos_id)

    @partial(jax.jit, donate_argnums=(1,))
    def decode(params, cache, table, last_tok, lengths, last_n, done, sp,
               counters):
        def step(carry, _):
            cache, tok, lens, last_n, done, counters = carry
            h, cache = forward_paged_decode(
                cfg, params, tok[:, None], cache, table, lens
            )
            logits = logits_from_hidden(cfg, params, h[:, 0])
            nxt = sample_dynamic(logits, sp, counters, last_n)
            nxt = jnp.where(done, jnp.int32(eos0), nxt)
            lens = lens + jnp.where(done, 0, 1)
            counters = counters + 1
            done = done | _is_eos(nxt, eos_ids)
            last_n = jnp.concatenate([last_n[:, 1:], nxt[:, None]], axis=1)
            return (cache, nxt, lens, last_n, done, counters), nxt

        (cache, tok, lengths, last_n, done, counters), toks = jax.lax.scan(
            step, (cache, last_tok, lengths, last_n, done, counters),
            None, length=chunk,
        )
        # The scan already carries the ring; returning it saves the
        # scheduler a host-side jnp rebuild (one extra device dispatch
        # per decode chunk).
        return cache, toks.T, done, counters, last_n

    return decode


def make_paged_prefill_fn(cfg: LlamaConfig):
    """Direct paged prefill: one pass writes prompt KV straight into the
    slot's pages (no dense-fragment double-write; models/llama.py
    forward_paged_prefill)."""

    @partial(jax.jit, donate_argnums=(1,))
    def prefill(params, cache, tokens, lengths, table_row):
        h, cache = forward_paged_prefill(cfg, params, tokens, cache,
                                         table_row, lengths)
        idx = jnp.clip(lengths - 1, 0, tokens.shape[1] - 1)
        h_last = jnp.take_along_axis(h, idx[:, None, None], axis=1)[:, 0]
        logits = logits_from_hidden(cfg, params, h_last)
        return cache, logits

    return prefill


def make_paged_prefill_cont_fn(cfg: LlamaConfig):
    """Chunked-prefill step: one C-token chunk of one prompt attends to
    the slot's pages so far and writes its own KV in place
    (models/llama.forward_paged_prefill_cont)."""
    from tokenhawk_tpu.models.llama import forward_paged_prefill_cont

    @partial(jax.jit, donate_argnums=(1,))
    def prefill_cont(params, cache, tokens, table_row, start, n_new):
        h, cache = forward_paged_prefill_cont(
            cfg, params, tokens, cache, table_row, start, n_new)
        idx = jnp.clip(n_new - 1, 0, tokens.shape[1] - 1)
        h_last = jnp.take_along_axis(h, idx[:, None, None], axis=1)[:, 0]
        logits = logits_from_hidden(cfg, params, h_last)
        return cache, logits

    return prefill_cont


class PagedScheduler:
    # No KV-pinned sessions; the serving loop replays conversation text
    # instead, and the prefix cache makes the replay prefill only the
    # new tokens (serving/server.py ServingLoop.submit_text).
    native_sessions = False

    def __init__(
        self,
        cfg: LlamaConfig,
        params: LlamaParams,
        sampling: SamplingConfig = SamplingConfig(),
        max_batch: int = 8,
        max_seq: Optional[int] = None,
        page_size: int = 128,
        n_pages: Optional[int] = None,
        cache_dtype=jnp.bfloat16,
        decode_chunk: int = 8,
        eos_id: int = EOS_ID,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        draft_cfg: Optional[LlamaConfig] = None,
        draft_params: Optional[LlamaParams] = None,
        gamma: int = 4,
        mesh=None,
    ):
        """prefill_chunk: admit prompts longer than this in page-aligned
        chunks interleaved with decode steps, so one long prompt never
        stalls the other slots' token streams for a full prefill (the
        "chunked prefill" serving discipline).  Must be a multiple of
        page_size.  None = classic single-shot admission.

        prefix_cache: automatic cross-request prefix caching — full
        prompt pages register under a content hash and later prompts
        sharing the prefix reuse them (refcounted; idle cached pages
        evict LRU under pool pressure), prefilling only the uncached
        suffix.  Prompt KV depends only on the prefix tokens, so reuse
        is bit-identical.

        draft_cfg/draft_params: speculative serving — a draft model
        proposes gamma tokens per round, the target verifies them in one
        paged multi-token pass (greedy-only; bit-identical to
        non-speculative greedy).  The draft keeps a dense per-slot
        cache."""
        if isinstance(params.layers, tuple) and mesh is not None:
            # The TP paged path scans stacked layer weights; stack under
            # jit with out_shardings pinned so the stacked weights are
            # born sharded — a plain stack of sharded per-layer leaves
            # can transiently replicate the full stacked weight per
            # device (OOM for models that only fit sharded).
            from tokenhawk_tpu.parallel.tp import stack_params_tp

            params = stack_params_tp(params, mesh)
        # Single chip: unrolled params (the loader's decode-fast form)
        # pair with the UNROLLED per-layer page pool — the paged
        # forwards' python layer loop updates each donated pool array in
        # place.  Stacked params keep the stacked pool + lax.scan.
        self._unrolled = isinstance(params.layers, tuple) and mesh is None
        self.cfg = cfg
        self.params = params
        self.sampling = sampling
        self.B = max_batch
        self.S = max_seq or cfg.n_ctx
        self.ps = page_size
        self.eos_id, self.eos_ids = normalize_eos(eos_id)
        eos_id = self.eos_ids if len(self.eos_ids) > 1 else self.eos_id
        self.decode_chunk = decode_chunk
        self.mesh = mesh
        self.max_pages = -(-self.S // page_size)
        if n_pages is None:
            # Default: full occupancy for half the slots + 1 trash page.
            n_pages = self.B * self.max_pages // 2 + 2

        # mesh = tensor-parallel paged serving (parallel/tp_paged.py):
        # the page pool (int8 scale pages included) shards along KV
        # heads; params must be the row_parallel_shards=tp layout (see
        # shard_params_tp).  Speculative serving keeps the draft
        # replicated and verifies head-sharded.
        if cache_dtype == "int8":  # quantized pages (runtime/paged.py)
            if self._unrolled:
                from tokenhawk_tpu.runtime.paged import (
                    make_unrolled_quant_pool,
                )

                self.cache = make_unrolled_quant_pool(cfg, n_pages,
                                                      page_size)
            else:
                from tokenhawk_tpu.runtime.paged import PagedQuantKVCache

                self.cache = PagedQuantKVCache.create(cfg, n_pages,
                                                      page_size)
        elif self._unrolled:
            from tokenhawk_tpu.runtime.paged import make_unrolled_pool

            self.cache = make_unrolled_pool(cfg, n_pages, page_size,
                                            cache_dtype)
        else:
            self.cache = PagedKVCache.create(cfg, n_pages, page_size,
                                             cache_dtype)
        if mesh is not None:
            from tokenhawk_tpu.parallel.tp_paged import shard_paged_cache_tp

            self.cache = shard_paged_cache_tp(self.cache, mesh)
        self.cache_dtype = cache_dtype
        self.alloc = PageAllocator(n_pages)
        self.trash_page = self.alloc.alloc(1)[0]
        self.table = np.full((self.B, self.max_pages), self.trash_page, np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(self.B)]
        self.lengths = np.zeros((self.B,), np.int32)

        self.spec = draft_params is not None
        self.gamma = gamma
        if self.spec:
            if draft_cfg.n_vocab != cfg.n_vocab:
                raise ValueError("draft and target must share the vocab")
            if cache_dtype == "int8":
                raise ValueError("speculative serving needs bf16 pages")
            from tokenhawk_tpu.models.llama import KVCache
            from tokenhawk_tpu.runtime.engine import make_prefill_fn
            from tokenhawk_tpu.runtime.speculative import (
                make_spec_serving_fn_paged,
                make_spec_serving_fn_paged_sampled,
            )

            self.draft_cfg = draft_cfg
            if isinstance(draft_params.layers, tuple):
                # The loader's decode-fast pipelines end in the unrolled
                # tuple form; the spec round scans stacked draft weights
                # against the stacked dense draft cache (an unrolled
                # draft would zip its layer tuple against the KVCache
                # NamedTuple — wrong shapes).  Replicated under TP.
                from tokenhawk_tpu.models.llama import stack_params

                draft_params = stack_params(draft_params)
            self.draft_params = draft_params
            self.draft_cache = KVCache.create(
                draft_cfg, max_batch, self.S, cache_dtype)
            self._draft_prefill = make_prefill_fn(draft_cfg)
            if mesh is not None:
                from tokenhawk_tpu.parallel.tp_paged import (
                    make_tp_spec_serving_fn_paged,
                    make_tp_spec_serving_fn_paged_sampled,
                )

                self._spec_step = make_tp_spec_serving_fn_paged(
                    draft_cfg, cfg, mesh, gamma, eos_id, params)
                self._spec_step_sampled = (
                    make_tp_spec_serving_fn_paged_sampled(
                        draft_cfg, cfg, mesh, gamma, eos_id, params))
            else:
                self._spec_step = make_spec_serving_fn_paged(
                    draft_cfg, cfg, gamma, eos_id)
                self._spec_step_sampled = make_spec_serving_fn_paged_sampled(
                    draft_cfg, cfg, gamma, eos_id)
            # Host mirror of per-slot temperatures: rounds where every
            # live slot is greedy take the cheaper exact-match fn;
            # sampled slots use rejection sampling (target-distributed).
            self._slot_sampled = [False] * max_batch

        quant = cache_dtype == "int8"
        if mesh is not None:
            from tokenhawk_tpu.parallel.tp_paged import (
                make_tp_paged_decode_fn_dynamic,
                make_tp_paged_prefill_cont_fn,
                make_tp_paged_prefill_fn,
            )

            self._prefill = make_tp_paged_prefill_fn(cfg, mesh, params,
                                                     quant=quant)
            self._decode = make_tp_paged_decode_fn_dynamic(
                cfg, mesh, decode_chunk, eos_id, params, quant=quant)
        else:
            self._prefill = make_paged_prefill_fn(cfg)
            self._decode = make_paged_decode_fn_dynamic(cfg, decode_chunk,
                                                        eos_id)
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None and prefill_chunk % page_size:
            raise ValueError("prefill_chunk must be a page_size multiple")
        if prefill_chunk is not None or prefix_cache:
            if mesh is not None:
                from tokenhawk_tpu.parallel.tp_paged import (
                    make_tp_paged_prefill_cont_fn,
                )

                self._prefill_cont = make_tp_paged_prefill_cont_fn(
                    cfg, mesh, params, quant=quant)
            else:
                self._prefill_cont = make_paged_prefill_cont_fn(cfg)
        # Mid-admission long prompts: slot -> (request, tokens prefilled).
        self.chunking: List[Optional[tuple]] = [None] * self.B

        # Automatic prefix cache: content-hash -> page id.  page_refs
        # counts live users; refcount-0 entries stay cached (reusable)
        # until pool pressure evicts them LRU.
        self.prefix_cache_enabled = prefix_cache
        from collections import OrderedDict

        self._pc: "OrderedDict[bytes, int]" = OrderedDict()
        self.page_refs: dict = {}
        self.page_key: dict = {}
        self.slot_shared: List[set] = [set() for _ in range(self.B)]
        self.prefix_hits = 0  # pages reused across requests (stats)
        # First-page keys shared by >=2 pending requests this step (see
        # the cold-leader rule in _admit_one); refreshed by step().
        self._hot_prefixes: set = set()

        n_ring = max(sampling.repeat_last_n, 1)
        self.n_ring = n_ring
        self.last_tok = jnp.zeros((self.B,), jnp.int32)
        self.last_n = jnp.full((self.B, n_ring), -1, jnp.int32)
        self.done = jnp.ones((self.B,), bool)
        from tokenhawk_tpu.sampling import SamplingParams

        self.sp = SamplingParams.broadcast(sampling, self.B)
        self.counters = jnp.zeros((self.B,), jnp.int32)

        self.slots: List[Optional[Request]] = [None] * self.B
        self.pending: Deque[Request] = deque()
        self.finished: List[Request] = []
        self._ids = itertools.count()
        self._key = jax.random.PRNGKey(sampling.seed)

        self.buckets = []
        b = 16
        while b < self.S:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(self.S)

    # ------------------------------------------------------------------

    def submit(self, req: Request) -> int:
        req.id = next(self._ids)
        req.submitted_at = time.perf_counter()
        if req.max_new_tokens <= 0:
            req.finish_reason = "length"
            req.done_at = req.submitted_at
            self.finished.append(req)
            if req.on_done:
                req.on_done(req)
            return req.id
        if len(req.prompt) >= self.S:
            req.finish_reason = "error:prompt_too_long"
            req.done_at = req.submitted_at
            self.finished.append(req)
            req.flush_text()
            if req.on_done:
                req.on_done(req)
            return req.id
        self.pending.append(req)
        return req.id

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def n_chunking(self) -> int:
        return sum(c is not None for c in self.chunking)

    @property
    def has_work(self) -> bool:
        return (self.n_active > 0 or self.n_chunking > 0
                or len(self.pending) > 0)

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    # -- automatic prefix cache ----------------------------------------

    def _prefix_keys(self, prompt, n_pages: int):
        """Content keys for the first n_pages full pages, hashed
        incrementally (one pass over the prompt, a digest per page —
        rehashing each growing prefix from scratch is O(pages^2))."""
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        keys = []
        toks = np.asarray(prompt, np.int32)
        for p in range(n_pages):
            h.update(toks[p * self.ps : (p + 1) * self.ps].tobytes())
            keys.append(h.copy().digest())
        return keys

    def _alloc_pages(self, k: int):
        """Allocate k pages, evicting idle (refcount-0) cached prefix
        pages LRU if the pool is dry.  Raises MemoryError if even
        eviction cannot satisfy."""
        try:
            return self.alloc.alloc(k)
        except MemoryError:
            for key in list(self._pc):
                page = self._pc[key]
                if self.page_refs.get(page, 0) <= 0:
                    del self._pc[key]
                    self.page_key.pop(page, None)
                    self.page_refs.pop(page, None)
                    self.alloc.free([page])
                    if self.alloc.n_free >= k:
                        break
            return self.alloc.alloc(k)

    def _table_slice(self, slot: int, n_tokens: int):
        """Table row truncated to a power-of-two page count covering
        n_tokens: the continuation prefill gathers exactly this many
        pages per layer, so chunk cost scales with the live history, not
        max_seq (the full row would gather max_pages*ps positions)."""
        need = -(-n_tokens // self.ps)
        n = 1
        while n < need:
            n *= 2
        n = min(n, self.max_pages)
        return self.table[slot : slot + 1, :n]

    def _reuse_prefix(self, slot: int, prompt) -> int:
        """Point the slot's leading table entries at cached pages shared
        with earlier prompts.  Returns tokens covered.  Caps at the page
        before the prompt's last token (at least one suffix token must
        run to produce the first logits)."""
        if not self.prefix_cache_enabled:
            return 0
        max_pages = (len(prompt) - 1) // self.ps
        keys = self._prefix_keys(prompt, max_pages)
        n = 0
        for key in keys:
            page = self._pc.get(key)
            if page is None:
                break
            self.table[slot, n] = page
            self.slot_pages[slot].append(page)
            self.slot_shared[slot].add(n)
            self.page_refs[page] = self.page_refs.get(page, 0) + 1
            self._pc.move_to_end(key)
            self.prefix_hits += 1
            n += 1
        return n * self.ps

    def _register_prompt_pages(self, slot: int, prompt):
        """Publish this slot's full prompt pages into the prefix cache
        (first writer wins; a page already cached by another slot leaves
        ours private)."""
        if not self.prefix_cache_enabled:
            return
        max_reg = (len(prompt) - 1) // self.ps
        keys = self._prefix_keys(prompt, max_reg)
        for pidx in range(max_reg):
            if pidx in self.slot_shared[slot]:
                continue  # reused: already cached
            key = keys[pidx]
            if key in self._pc:
                continue
            page = int(self.table[slot, pidx])
            self._pc[key] = page
            self.page_key[page] = key
            self.page_refs[page] = self.page_refs.get(page, 0) + 1
            self.slot_shared[slot].add(pidx)

    def _release_slot_pages(self, slot: int):
        """Retirement/cancel: decref shared pages (they stay cached at
        refcount 0 for reuse), free private ones."""
        for i, page in enumerate(self.slot_pages[slot]):
            if i in self.slot_shared[slot]:
                self.page_refs[page] = self.page_refs.get(page, 1) - 1
            else:
                self.alloc.free([page])
        self.slot_pages[slot] = []
        self.slot_shared[slot] = set()
        self.table[slot, :] = self.trash_page

    def _ensure_pages(self, slot: int, need_tokens: int) -> bool:
        """Grow slot's page list to cover need_tokens; False if OOM."""
        need = -(-need_tokens // self.ps)
        have = len(self.slot_pages[slot])
        if need > self.max_pages:
            return False
        if need > have:
            try:
                new = self._alloc_pages(need - have)
            except MemoryError:
                return False
            for i, p in enumerate(new):
                self.table[slot, have + i] = p
            self.slot_pages[slot].extend(new)
        return True

    def _admit_one(self, slot: int, req: Request,
                   batch: Optional[list] = None) -> bool:
        """Admit req into slot.  With `batch` given, a PLAIN admission
        (no cached prefix, no chunking, no draft model) only reserves
        pages and appends (slot, req, Tb) for the caller to prefill in
        ONE padded multi-slot dispatch (_admit_batch) — each separate
        prefill call pays the full per-dispatch cost (arg marshalling
        for the ~370-leaf params+pool tree), so admitting n slots in one
        call saves n-1 of them."""
        prompt = req.prompt
        reused = self._reuse_prefix(slot, prompt)  # tokens from the cache
        remaining = len(prompt) - reused
        if (self.prefill_chunk is not None
                and remaining > self.prefill_chunk):
            # Long prompt: claim the slot and prefill chunk-by-chunk
            # across subsequent step()s instead of stalling everyone now.
            if not self._ensure_pages(
                    slot, reused + min(remaining, self.prefill_chunk)):
                self._release_slot_pages(slot)
                return False
            self.chunking[slot] = (req, reused)
            return True
        if reused:
            # Cached prefix: prefill only the suffix (continuation path,
            # page-aligned start).
            Cb = -(-remaining // self.ps) * self.ps
            if not self._ensure_pages(slot, len(prompt)):
                self._release_slot_pages(slot)
                return False
            if batch is not None and not self.spec:
                batch.append(("cont", slot, req, reused, remaining, Cb))
                return True
            toks = np.zeros((1, Cb), np.int32)
            toks[0, :remaining] = prompt[reused:]
            self.cache, logits = self._prefill_cont(
                self.params, self.cache, jnp.asarray(toks),
                jnp.asarray(self._table_slice(slot, reused + Cb)),
                jnp.asarray([reused], jnp.int32),
                jnp.asarray([remaining], jnp.int32),
            )
            if self.spec:
                Tb = _bucket(len(prompt), self.buckets)
                dtoks = np.zeros((1, Tb), np.int32)
                dtoks[0, : len(prompt)] = prompt
                self._spec_draft_prefill(slot, dtoks, len(prompt))
            self._register_prompt_pages(slot, prompt)
            self._activate(slot, req, logits)
            return True
        Tb = _bucket(len(prompt), self.buckets)
        if not self._ensure_pages(slot, Tb):
            return False  # not enough pages right now
        if batch is not None and not self.spec:
            # Cold SHARED prefix: if another same-step pending request
            # shares this prompt's (uncached) first page, admit this one
            # IMMEDIATELY (unbatched) so its pages register before the
            # rest of the step's admissions run _reuse_prefix — the
            # followers then admit as batched continuations instead of
            # each prefilling a private copy.  (Deferring everyone to
            # the flush would also be a write/read race: a follower's
            # continuation row would attend over prefix pages the
            # leader's row is still writing in the same dispatch.)
            # Requests with UNIQUE cold prefixes stay batched — going
            # solo for every multi-page cold prompt would re-serialize
            # the plain-admission path entirely.  (Reaching here with a
            # multi-page prompt implies its first-page key is NOT in
            # _pc: _reuse_prefix returned 0.)
            cold_leader = (
                self.prefix_cache_enabled
                and (len(prompt) - 1) // self.ps >= 1
                and self._prefix_keys(prompt, 1)[0] in self._hot_prefixes
            )
            if not cold_leader:
                batch.append(("plain", slot, req, Tb))
                return True

        toks = np.zeros((1, Tb), np.int32)
        toks[0, : len(prompt)] = prompt
        self.cache, logits = self._prefill(
            self.params, self.cache, jnp.asarray(toks),
            jnp.asarray([len(prompt)], jnp.int32),
            jnp.asarray(self.table[slot : slot + 1]),
        )
        if self.spec:
            self._spec_draft_prefill(slot, toks, len(prompt))
        self._register_prompt_pages(slot, prompt)
        self._activate(slot, req, logits)
        return True

    def _admit_batch(self, group: list):
        """Admit a group of plain same-bucket admissions with ONE padded
        prefill dispatch + ONE fused state dispatch.

        The group's row count pads to a power of two so the serve path
        compiles at most log2(B)+1 prefill variants per token bucket
        (an exact-n shape would compile per distinct group size).
        Padding rows carry zero lengths and all-trash table rows: their
        (garbage) KV writes land on the trash page and their logits rows
        drop at the state scatter."""
        Tb = group[0][3]
        n = len(group)
        Nb = 1 << (n - 1).bit_length()
        toks = np.zeros((Nb, Tb), np.int32)
        lengths = np.zeros((Nb,), np.int32)
        table = np.full((Nb, self.max_pages), self.trash_page, np.int32)
        for i, (_, slot, req, _Tb) in enumerate(group):
            prompt = req.prompt
            toks[i, : len(prompt)] = prompt
            lengths[i] = len(prompt)
            table[i] = self.table[slot]
        self.cache, logits = self._prefill(
            self.params, self.cache, jnp.asarray(toks),
            jnp.asarray(lengths), jnp.asarray(table),
        )
        self._activate_many([(slot, req) for _, slot, req, _Tb in group],
                            Nb, logits)

    def _prefill_cont_group(self, rows, Cb: int):
        """ONE padded prefill_cont dispatch over same-width continuation
        rows (slot, tokens, start) — the shared engine under batched
        prefix-cache admissions AND batched chunk advances (each
        unbatched call pays the full per-dispatch cost, the arg
        marshalling of the ~370-leaf params+pool tree).  The row
        count pads to a power of two and the table width to the group's
        power-of-two page-count bucket (same bucketing as _table_slice,
        so batched and single calls share compilations when shapes
        agree); padding rows carry zero n_new and all-trash tables.
        Returns (Nb, logits [Nb, V]) with the live rows leading."""
        n = len(rows)
        Nb = 1 << (n - 1).bit_length()
        need = max(-(-(start + Cb) // self.ps) for _, _, start in rows)
        W = 1
        while W < need:
            W *= 2
        W = min(W, self.max_pages)
        toks = np.zeros((Nb, Cb), np.int32)
        starts = np.zeros((Nb,), np.int32)
        n_new = np.zeros((Nb,), np.int32)
        table = np.full((Nb, W), self.trash_page, np.int32)
        for i, (slot, row_toks, start) in enumerate(rows):
            toks[i, : len(row_toks)] = row_toks
            starts[i] = start
            n_new[i] = len(row_toks)
            table[i] = self.table[slot, :W]
        self.cache, logits = self._prefill_cont(
            self.params, self.cache, jnp.asarray(toks),
            jnp.asarray(table), jnp.asarray(starts), jnp.asarray(n_new),
        )
        return Nb, logits

    def _admit_batch_cont(self, group: list):
        """Batched prefix-cache continuation admissions: one padded
        prefill_cont dispatch covers every same-bucket suffix."""
        Cb = group[0][5]
        Nb, logits = self._prefill_cont_group(
            [(slot, req.prompt[reused:], reused)
             for _, slot, req, reused, _rem, _Cb in group], Cb)
        self._activate_many(
            [(slot, req) for _, slot, req, _r, _m, _c in group], Nb, logits)

    def _activate_many(self, rows: list, Nb: int, logits):
        """Fused state update + host-side activation for one admission
        group (logits [Nb, V]; rows is the n <= Nb live (slot, req)
        prefix — padding rows scatter-drop via out-of-range indices)."""
        n = len(rows)
        # Out-of-range slot index = dropped at the scatter (mode="drop").
        slots = np.full((Nb,), self.B, np.int32)
        rings = np.full((Nb, self.n_ring), -1, np.int32)
        scfgs = []
        for i, (slot, req) in enumerate(rows):
            slots[i] = slot
            m = min(self.n_ring, len(req.prompt))
            if m:
                rings[i, self.n_ring - m:] = req.prompt[-m:]
            scfgs.append(req.sampling or self.sampling)
        from tokenhawk_tpu.sampling import SamplingParams

        slot_sp = SamplingParams.from_configs(scfgs, Nb)
        (self.sp, self.counters, self.last_tok, self.last_n, self.done,
         first) = _admit_state_paged_many(
            logits, self.sp, self.counters, self.last_tok, self.last_n,
            self.done, jnp.asarray(slots), jnp.asarray(rings), slot_sp,
        )
        first_host = np.asarray(first)
        now = time.perf_counter()
        for i, (slot, req) in enumerate(rows):
            self._register_prompt_pages(slot, req.prompt)
            self.lengths[slot] = len(req.prompt)
            self.slots[slot] = req
            req.first_token_at = now
            self._deliver(slot, int(first_host[i]))

    def _spec_draft_prefill(self, slot: int, toks: np.ndarray, n: int):
        """Mirror the admission prefill into the DRAFT's dense cache
        stripe (its logits are unused; it only needs the KV state)."""
        from tokenhawk_tpu.models.llama import KVCache
        from tokenhawk_tpu.runtime.scheduler import _insert_fragment

        frag = KVCache.create(self.draft_cfg, 1, toks.shape[1],
                              self.draft_cache.k.dtype)
        frag, _ = self._draft_prefill(
            self.draft_params, frag, jnp.asarray(toks),
            jnp.asarray([n], jnp.int32), jnp.asarray([0], jnp.int32),
        )
        self.draft_cache = type(self.draft_cache)(
            _insert_fragment(self.draft_cache.k, frag.k, slot),
            _insert_fragment(self.draft_cache.v, frag.v, slot),
        )

    def _advance_chunking_batch(self):
        """Advance every mid-admission prompt by one chunk this step,
        grouped into ONE padded prefill_cont dispatch per chunk-width
        bucket (mirrors _admit_batch_cont: each unbatched call pays the
        full per-dispatch cost, the arg marshalling of the ~370-leaf
        params+pool tree).  Rows that
        complete their prompt are sorted to the FRONT of their group so
        _activate_many can consume the leading logits rows; the rest
        keep their chunking state.  Spec mode keeps the single-slot path
        (the draft-cache mirror prefill is per-slot)."""
        if self.spec:
            for slot in range(self.B):
                if self.chunking[slot] is not None:
                    self._advance_chunking(slot)
                    break
            return
        C = self.prefill_chunk
        rows = []  # (slot, req, pos, n_new, Cb, completes)
        for slot in range(self.B):
            if self.chunking[slot] is None:
                continue
            if rows and self.n_active > 0:
                # One chunk per step while streams are live (see below);
                # do not _ensure_pages for slots that will not advance —
                # they would hoard unwritten pages under pool pressure.
                break
            req, pos = self.chunking[slot]
            n_new = min(C, len(req.prompt) - pos)
            if not self._ensure_pages(slot, pos + n_new):
                # Transient shortage: keep the chunking state and retry
                # next step while anything else in flight could free
                # pages (same discipline as the single-slot path).
                if self.n_active > 0 or self.n_chunking > 1 or rows:
                    continue
                self.chunking[slot] = None
                self._release_slot_pages(slot)
                req.finish_reason = "oom_pages"
                req.done_at = time.perf_counter()
                self.finished.append(req)
                req.flush_text()
                if req.on_done:
                    req.on_done(req)
                continue
            # Last (short) chunk shrinks to a page multiple of the REAL
            # data so no pad-only page is ever written (see
            # _advance_chunking).
            Cb = C if n_new == C else -(-n_new // self.ps) * self.ps
            rows.append((slot, req, pos, n_new, Cb,
                         pos + n_new >= len(req.prompt)))
        if not rows:
            # Every chunking slot is page-starved and nothing active can
            # ever free pages: deterministically stuck (each slot alone
            # sees "other chunking slots in flight" and waits for the
            # others — mutual waiting, not progress).  Fail the slot
            # with the LARGEST total page need — the most likely to be
            # infeasible for this pool — so a satisfiable request is
            # never sacrificed ahead of an unsatisfiable one.
            if self.n_active == 0 and self.n_chunking > 1:
                slot = max(
                    (s for s in range(self.B)
                     if self.chunking[s] is not None),
                    key=lambda s: -(-len(self.chunking[s][0].prompt)
                                    // self.ps),
                )
                req, _pos = self.chunking[slot]
                self.chunking[slot] = None
                self._release_slot_pages(slot)
                req.finish_reason = "oom_pages"
                req.done_at = time.perf_counter()
                self.finished.append(req)
                req.flush_text()
                if req.on_done:
                    req.on_done(req)
            return
        # Live decode streams present: the scan above stopped after one
        # row, keeping the one-chunk-per-step stall bound (the whole
        # point of chunked admission).  The full multi-slot batch only
        # runs when nothing is decoding, where per-step latency has no
        # audience.
        rows.sort(key=lambda r: (r[4], not r[5]))
        for _, grp in itertools.groupby(rows, key=lambda r: r[4]):
            self._advance_chunk_group(list(grp))

    def _advance_chunk_group(self, group: list):
        """One padded prefill_cont dispatch advances a same-width group
        of prompt chunks (different slots write disjoint pages)."""
        Cb = group[0][4]
        Nb, logits = self._prefill_cont_group(
            [(slot, req.prompt[pos : pos + n_new], pos)
             for slot, req, pos, n_new, _Cb, _done in group], Cb)
        completed = []
        for slot, req, pos, n_new, _Cb, done in group:
            if done:
                self.chunking[slot] = None
                completed.append((slot, req))
            else:
                self.chunking[slot] = (req, pos + n_new)
        if completed:
            self._activate_many(completed, Nb, logits)

    def _advance_chunking(self, slot: int):
        """Prefill the next chunk of a mid-admission prompt; activate the
        slot when the last chunk lands."""
        req, pos = self.chunking[slot]
        prompt = req.prompt
        C = self.prefill_chunk
        n_new = min(C, len(prompt) - pos)
        if not self._ensure_pages(slot, pos + n_new):
            # Transient shortage: live slots retiring can free capacity,
            # so keep the chunking state and retry next step (same
            # discipline as admission).  Only fail when nothing else in
            # flight could ever free pages.
            if self.n_active > 0 or self.n_chunking > 1:
                return
            self.chunking[slot] = None
            self._release_slot_pages(slot)
            req.finish_reason = "oom_pages"
            req.done_at = time.perf_counter()
            self.finished.append(req)
            req.flush_text()
            if req.on_done:
                req.on_done(req)
            return
        # Last (short) chunk: shrink the array to a page multiple of the
        # REAL data so no pad-only page is ever written (a pad page's
        # index can exceed the table slice, and take_along_axis clamps —
        # the garbage would land on the last live page).
        Cb = C if n_new == C else -(-n_new // self.ps) * self.ps
        toks = np.zeros((1, Cb), np.int32)
        toks[0, :n_new] = prompt[pos : pos + n_new]
        self.cache, logits = self._prefill_cont(
            self.params, self.cache, jnp.asarray(toks),
            jnp.asarray(self._table_slice(slot, pos + Cb)),
            jnp.asarray([pos], jnp.int32),
            jnp.asarray([n_new], jnp.int32),
        )
        pos += n_new
        if pos >= len(prompt):
            self.chunking[slot] = None
            if self.spec:
                Tb = _bucket(len(prompt), self.buckets)
                dtoks = np.zeros((1, Tb), np.int32)
                dtoks[0, : len(prompt)] = prompt
                self._spec_draft_prefill(slot, dtoks, len(prompt))
            self._register_prompt_pages(slot, prompt)
            self._activate(slot, req, logits)
        else:
            self.chunking[slot] = (req, pos)

    def _activate(self, slot: int, req: Request, logits):
        prompt = req.prompt
        ring = np.full((self.n_ring,), -1, np.int32)
        m = min(self.n_ring, len(prompt))
        ring[self.n_ring - m :] = prompt[-m:]
        from tokenhawk_tpu.sampling import SamplingParams

        scfg = req.sampling or self.sampling
        if self.spec:
            self._slot_sampled[slot] = scfg.temperature > 0.0
        # ONE fused dispatch for the whole slot-state update (sample +
        # sp/counters/last_tok/last_n/done writes): the unfused form was
        # ~7 tiny device calls per admission, each paying a dispatch.
        (self.sp, self.counters, self.last_tok, self.last_n, self.done,
         first) = _admit_state_paged(
            logits, self.sp, self.counters, self.last_tok, self.last_n,
            self.done, jnp.int32(slot), jnp.asarray(ring),
            SamplingParams.broadcast(scfg, 1),
        )
        self.lengths[slot] = len(prompt)
        self.slots[slot] = req
        req.first_token_at = time.perf_counter()
        self._deliver(slot, int(first))
        return True

    def _deliver(self, slot: int, tok: int) -> bool:
        req = self.slots[slot]
        if req is None:
            return False
        if tok in self.eos_ids:
            self._retire(slot, "eos")
            return False
        req.output.append(tok)
        if req.on_token:
            req.on_token(tok)
        if req.feed_text(tok):
            self._retire(slot, "stop")
            return False
        if len(req.output) >= req.max_new_tokens:
            self._retire(slot, "length")
            return False
        margin = 1 + (self.gamma if self.spec else 0)
        if len(req.prompt) + len(req.output) >= self.S - margin:
            self._retire(slot, "context_full")
            return False
        return True

    def _retire(self, slot: int, reason: str):
        req = self.slots[slot]
        req.finish_reason = reason
        req.done_at = time.perf_counter()
        self.slots[slot] = None
        self.done = self.done.at[slot].set(True)
        self._release_slot_pages(slot)
        self.lengths[slot] = 0
        self.finished.append(req)
        req.flush_text()
        if req.on_done:
            req.on_done(req)

    # ------------------------------------------------------------------

    def _masked_table(self):
        """Table view for decode/verify: mid-chunking slots' rows point at
        the trash page so their done-masked writes cannot touch the pages
        being prefilled.  (Safe with the prefix cache: shared page
        indices are always < ceil(len(prompt)/ps), so decode/verify
        frontier writes never land on a shared page.)"""
        table = self.table
        if any(c is not None for c in self.chunking):
            table = table.copy()
            for slot, c in enumerate(self.chunking):
                if c is not None:
                    table[slot, :] = self.trash_page
        return table

    def step(self):
        if self.prefix_cache_enabled and len(self.pending) > 1:
            # First-page keys appearing in >=2 pending prompts: these
            # get a solo "leader" admission so followers reuse their
            # pages (see _admit_one).
            counts: dict = {}
            for req in self.pending:
                if (len(req.prompt) - 1) // self.ps >= 1:
                    k = self._prefix_keys(req.prompt, 1)[0]
                    counts[k] = counts.get(k, 0) + 1
            self._hot_prefixes = {k for k, c in counts.items() if c >= 2}
        else:
            self._hot_prefixes = set()
        batch: list = []  # deferred plain admissions (slot, req, Tb)
        for slot in range(self.B):
            if (self.slots[slot] is None and self.chunking[slot] is None
                    and self.pending):
                if not self._admit_one(slot, self.pending[0], batch):
                    if (self.n_active == 0 and self.n_chunking == 0
                            and not batch):
                        # Nothing in flight can ever free capacity: the
                        # request is infeasible for this pool, not merely
                        # queued.  Fail it instead of spinning forever.
                        req = self.pending.popleft()
                        req.finish_reason = "oom_pages"
                        req.done_at = time.perf_counter()
                        self.finished.append(req)
                        req.flush_text()
                        if req.on_done:
                            req.on_done(req)
                        continue
                    break  # page pool exhausted; decode to free capacity
                else:
                    self.pending.popleft()
        # Flush the deferred admissions: one padded multi-slot prefill
        # dispatch per (kind, token bucket) instead of one per request.
        if batch:
            plains = sorted((e for e in batch if e[0] == "plain"),
                            key=lambda e: e[3])
            for _, grp in itertools.groupby(plains, key=lambda e: e[3]):
                self._admit_batch(list(grp))
            conts = sorted((e for e in batch if e[0] == "cont"),
                           key=lambda e: e[5])
            for _, grp in itertools.groupby(conts, key=lambda e: e[5]):
                self._admit_batch_cont(list(grp))
        # Advance every mid-admission prompt by one chunk, batched into
        # one dispatch per chunk-width bucket.  Per-slot stall stays
        # bounded by ONE chunk per step; batching the slots into a
        # single padded call beats advancing them on separate steps on
        # both axes (N x chunk device cost either way, but one dispatch
        # overhead instead of N).
        if self.n_chunking:
            self._advance_chunking_batch()
        if self.n_active == 0:
            return

        # Top up pages so every live slot can absorb a full chunk (or a
        # speculative round's gamma+1 writes).
        grow = (self.gamma + 1 if self.spec else self.decode_chunk) + 1
        for slot in range(self.B):
            if self.slots[slot] is not None:
                if not self._ensure_pages(
                    slot, int(self.lengths[slot]) + grow
                ):
                    self._retire(slot, "oom_pages")

        if self.n_active == 0:
            return
        if self.spec:
            any_sampled = any(
                self._slot_sampled[s] for s in range(self.B)
                if self.slots[s] is not None)
            if any_sampled:
                (self.draft_cache, self.cache, out, n_new, lengths_new,
                 self.done, self.last_tok, self.last_n,
                 self.counters) = self._spec_step_sampled(
                    self.draft_params, self.params, self.draft_cache,
                    self.cache, jnp.asarray(self._masked_table()),
                    self.last_tok, jnp.asarray(self.lengths), self.done,
                    self.last_n, self.sp, self.counters,
                )
            else:
                (self.draft_cache, self.cache, out, n_new, lengths_new,
                 self.done, self.last_tok) = self._spec_step(
                    self.draft_params, self.params, self.draft_cache,
                    self.cache, jnp.asarray(self._masked_table()),
                    self.last_tok, jnp.asarray(self.lengths), self.done,
                )
            self.lengths = np.array(lengths_new)  # writable copy
            out_host = np.asarray(out)
            n_host = np.asarray(n_new)
            for slot in range(self.B):
                if self.slots[slot] is None:
                    continue
                for t in out_host[slot, : n_host[slot]]:
                    if not self._deliver(slot, int(t)):
                        break
            return
        # Decode/verify sees trash-page rows for mid-chunking slots:
        # their done-masked writes must not land on the pages being
        # prefilled (free slots already point at trash; a chunking
        # slot's row is live).
        table = self._masked_table()
        (self.cache, toks, self.done, self.counters,
         self.last_n) = self._decode(
            self.params, self.cache, jnp.asarray(table),
            self.last_tok, jnp.asarray(self.lengths), self.last_n,
            self.done, self.sp, self.counters,
        )
        self.last_tok = toks[:, -1]
        toks_host = np.asarray(toks)
        for slot in range(self.B):
            if self.slots[slot] is None:
                continue
            n_emitted = 0
            for t in toks_host[slot]:
                n_emitted += 1
                if not self._deliver(slot, int(t)):
                    break
            self.lengths[slot] += n_emitted

    # -- serving compatibility (serving/server.py drives either
    #    scheduler through the same surface) ---------------------------

    def cancel(self, req: "Request", reason: str = "cancelled") -> bool:
        """Abort a request: drops it from the queue, frees its slot, or
        abandons a mid-chunking admission (pages returned to the pool)."""
        if req in self.pending:
            self.pending.remove(req)
            req.finish_reason = reason
            req.done_at = time.perf_counter()
            self.finished.append(req)
            if req.on_done:
                req.on_done(req)
            return True
        for slot, c in enumerate(self.chunking):
            if c is not None and c[0] is req:
                self.chunking[slot] = None
                self._release_slot_pages(slot)
                req.finish_reason = reason
                req.done_at = time.perf_counter()
                self.finished.append(req)
                if req.on_done:
                    req.on_done(req)
                return True
        for slot, r in enumerate(self.slots):
            if r is req:
                self._retire(slot, reason)
                return True
        return False

    @property
    def sessions(self) -> dict:
        return {}  # multi-turn sessions live in the dense Scheduler

    def reset_session(self, sid: str) -> None:
        pass  # no session state to clear

    def reset_device_state(self):
        """Recovery path: rebuild the page pool and slot state from
        scratch after repeated device-step failures (callers retire the
        active slots first); the pending queue is untouched."""
        from tokenhawk_tpu.runtime.paged import pool_n_pages

        n_pages = pool_n_pages(self.cache)
        if self.cache_dtype == "int8":
            if self._unrolled:
                from tokenhawk_tpu.runtime.paged import (
                    make_unrolled_quant_pool,
                )

                self.cache = make_unrolled_quant_pool(self.cfg, n_pages,
                                                      self.ps)
            else:
                from tokenhawk_tpu.runtime.paged import PagedQuantKVCache

                self.cache = PagedQuantKVCache.create(self.cfg, n_pages,
                                                      self.ps)
        elif self._unrolled:
            from tokenhawk_tpu.runtime.paged import make_unrolled_pool

            self.cache = make_unrolled_pool(self.cfg, n_pages, self.ps,
                                            self.cache_dtype)
        else:
            self.cache = PagedKVCache.create(
                self.cfg, n_pages, self.ps, self.cache_dtype)
        # Re-shard EVERY rebuilt pool form under TP, mirroring __init__
        # (an int8 or unrolled pool born here with default placement
        # would silently diverge from the sharded compiled steps).
        if self.mesh is not None:
            from tokenhawk_tpu.parallel.tp_paged import (
                shard_paged_cache_tp,
            )

            self.cache = shard_paged_cache_tp(self.cache, self.mesh)
        self.alloc = PageAllocator(n_pages)
        self.trash_page = self.alloc.alloc(1)[0]
        self.table = np.full((self.B, self.max_pages), self.trash_page,
                             np.int32)
        self.slot_pages = [[] for _ in range(self.B)]
        self.lengths = np.zeros((self.B,), np.int32)
        self.last_tok = jnp.zeros((self.B,), jnp.int32)
        self.last_n = jnp.full((self.B, self.n_ring), -1, jnp.int32)
        self.done = jnp.ones((self.B,), bool)
        self.counters = jnp.zeros((self.B,), jnp.int32)
        self.chunking = [None] * self.B
        if self.spec:
            from tokenhawk_tpu.models.llama import KVCache

            self.draft_cache = KVCache.create(
                self.draft_cfg, self.B, self.S, self.draft_cache.k.dtype)
        self._pc.clear()
        self.page_refs.clear()
        self.page_key.clear()
        self.slot_shared = [set() for _ in range(self.B)]

    def run(self):
        while self.has_work:
            self.step()

    def generate_many(self, prompts, max_new_tokens: int = 256) -> List[Request]:
        reqs = [Request(prompt=list(p), max_new_tokens=max_new_tokens)
                for p in prompts]
        for r in reqs:
            self.submit(r)
        self.run()
        return reqs
