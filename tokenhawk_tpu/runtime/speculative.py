"""Speculative decoding: a small draft model proposes, the target verifies.

Decode is weight-stream-bound: a 7B forward over T=1 and T=gamma+1
tokens reads the same weight bytes, so verifying gamma
draft tokens in ONE target pass multiplies tokens/step by the acceptance
length.  Classic speculative decoding (greedy form): the target's
argmax over the drafted prefix either reproduces each draft token
(accept) or yields the correction token (reject + replace), so output
is EXACTLY the target-only greedy stream regardless of draft quality —
the draft only changes speed, never content.

Device-side details:

  * Everything runs in one jitted step per round: the draft's
    gamma-step `lax.scan`, the target's single [B, gamma+1] forward,
    and the acceptance arithmetic.  Only token ids + accept counts
    cross to the host.
  * No KV rollback.  Both caches write K/V for speculative positions
    as they go; on rejection the engine simply does not advance
    `offsets` past the accepted prefix.  Every attention kernel in this
    framework masks by length (`kpos < length`), so stale cache slots
    beyond the offset are invisible and get overwritten when those
    positions are legitimately reached again.
  * The invariant matches runtime.engine: "last committed token not
    yet in cache".  The draft writes [last, d_1..d_{g-1}] at
    offsets..offsets+g-1; the accepted prefix d_1..d_k occupies exactly
    the slots the committed history needs, so the draft cache is valid
    for ANY acceptance length k.

Beyond the reference's scope (it decodes strictly one token per GPU
round trip, /root/reference/th-llama.cpp:662-727).
"""

from __future__ import annotations

import time
from functools import partial
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.models.llama import (
    LlamaParams,
    forward,
    logits_from_hidden,
)
from tokenhawk_tpu.tokenizer import BOS_ID, EOS_ID, Tokenizer


def make_spec_decode_fn(cfg_draft: LlamaConfig, cfg_target: LlamaConfig,
                        gamma: int):
    """One speculative round, fully on device.

    (params_d, params_t, cache_d, cache_t, last_tok [B], offsets [B])
      -> (cache_d, cache_t, out [B, gamma+1] (-1-padded), n_new [B],
          offsets', last_tok')

    Greedy draft + greedy target: out[:, :n_new] extends the committed
    stream with k accepted drafts plus the target's own token at the
    cut — bit-identical to target-only greedy decoding.
    """

    @partial(jax.jit, donate_argnums=(2, 3))
    def step(params_d, params_t, cache_d, cache_t, last_tok, offsets):
        B = last_tok.shape[0]

        def dstep(carry, _):
            cache_d, tok, off = carry
            h, cache_d = forward(cfg_draft, params_d, tok[:, None],
                                 cache_d, off)
            lg = logits_from_hidden(cfg_draft, params_d, h[:, 0])
            nxt = jnp.argmax(lg, -1).astype(jnp.int32)
            return (cache_d, nxt, off + 1), nxt

        (cache_d, _, _), drafts = jax.lax.scan(
            dstep, (cache_d, last_tok, offsets), None, length=gamma
        )
        drafts = drafts.T  # [B, gamma]

        seq = jnp.concatenate([last_tok[:, None], drafts], axis=1)
        h, cache_t = forward(cfg_target, params_t, seq, cache_t, offsets)
        logits = logits_from_hidden(cfg_target, params_t, h)  # [B, g+1, V]
        tgt = jnp.argmax(logits, -1).astype(jnp.int32)  # [B, g+1]

        # k = length of the matching draft prefix (0..gamma).
        match = drafts == tgt[:, :gamma]
        k = jnp.sum(jnp.cumprod(match.astype(jnp.int32), axis=1), axis=1)

        # out[:, j] = drafts[:, j] for j < k; target's token at j == k;
        # -1 padding after.
        j = jnp.arange(gamma + 1)[None, :]
        bonus = jnp.take_along_axis(tgt, k[:, None], axis=1)  # [B, 1]
        drafts_pad = jnp.concatenate(
            [drafts, jnp.zeros((B, 1), jnp.int32)], axis=1)
        out = jnp.where(j < k[:, None], drafts_pad, -1)
        out = jnp.where(j == k[:, None], bonus, out)

        n_new = k + 1
        offsets = offsets + n_new
        last_tok = bonus[:, 0]
        return cache_d, cache_t, out, n_new, offsets, last_tok

    return step


def _spec_round_greedy(cfg_draft, cfg_target, gamma, eos_id, target_forward,
                       target_logits, params_d, params_t, cache_d, cache_t,
                       last_tok, offsets, done):
    """Shared body of the dense/paged greedy speculative round.

    `target_forward(params_t, seq, cache_t, offsets, adv)` and
    `target_logits(params_t, h)` are hooks so the same accept/EOS/freeze
    math serves the dense forward, the paged verify, and their
    tensor-parallel twins (parallel/tp.py, parallel/tp_paged.py).
    eos_id: int or iterable (multi-EOS vocabs)."""
    from tokenhawk_tpu.sampling import is_eos as _tok_is_eos
    from tokenhawk_tpu.sampling import normalize_eos

    _, eos_ids = normalize_eos(eos_id)
    B = last_tok.shape[0]
    adv = (~done).astype(jnp.int32)

    def dstep(carry, _):
        cache_d, tok, off = carry
        h, cache_d = forward(cfg_draft, params_d, tok[:, None],
                             cache_d, off)
        lg = logits_from_hidden(cfg_draft, params_d, h[:, 0])
        nxt = jnp.argmax(lg, -1).astype(jnp.int32)
        return (cache_d, nxt, off + adv), nxt

    (cache_d, _, _), drafts = jax.lax.scan(
        dstep, (cache_d, last_tok, offsets), None, length=gamma
    )
    drafts = drafts.T  # [B, gamma]

    seq = jnp.concatenate([last_tok[:, None], drafts], axis=1)
    h, cache_t = target_forward(params_t, seq, cache_t, offsets, adv)
    logits = target_logits(params_t, h)  # [B, g+1, V]
    tgt = jnp.argmax(logits, -1).astype(jnp.int32)

    match = drafts == tgt[:, :gamma]
    k = jnp.sum(jnp.cumprod(match.astype(jnp.int32), axis=1), axis=1)

    j = jnp.arange(gamma + 1)[None, :]
    bonus = jnp.take_along_axis(tgt, k[:, None], axis=1)  # [B, 1]
    drafts_pad = jnp.concatenate(
        [drafts, jnp.zeros((B, 1), jnp.int32)], axis=1)
    out = jnp.where(j < k[:, None], drafts_pad, -1)
    out = jnp.where(j == k[:, None], bonus, out)

    n_new = jnp.where(done, 0, k + 1)
    # Cut at the first EOS among the committed tokens (inclusive).
    is_eos = _tok_is_eos(out, eos_ids) & (j < n_new[:, None])
    eos_pos = jnp.min(jnp.where(is_eos, j, gamma + 1), axis=1)
    has_eos = eos_pos <= gamma
    n_new = jnp.where(has_eos, eos_pos + 1, n_new)
    out = jnp.where(j < n_new[:, None], out, -1)

    offsets = offsets + n_new
    done_new = done | has_eos
    last_idx = jnp.clip(n_new - 1, 0, gamma)
    last_new = jnp.take_along_axis(out, last_idx[:, None], axis=1)[:, 0]
    last_tok = jnp.where(done, last_tok, last_new)
    return cache_d, cache_t, out, n_new, offsets, done_new, last_tok


def make_spec_serving_fn(cfg_draft: LlamaConfig, cfg_target: LlamaConfig,
                         gamma: int, eos_id: int = EOS_ID):
    """One speculative round shaped for the continuous-batching scheduler.

    (params_d, params_t, cache_d, cache_t, last_tok [B], offsets [B],
     done [B])
      -> (cache_d, cache_t, out [B, gamma+1] (-1 past n_new), n_new [B],
          offsets', done', last_tok')

    Differences from make_spec_decode_fn, matching the scheduler's slot
    protocol (runtime/scheduler.py):
      * done slots freeze: their offsets do not advance, n_new == 0, and
        their rows of `out` are all -1 (their forwards still run — the
        batch is shape-stable — but writes land beyond the committed
        frontier, invisible to the length-masked kernels);
      * EOS latches ON DEVICE: the round's output is cut at the first
        EOS among the committed tokens (n_new includes the EOS so the
        host's delivery loop sees it and retires the slot).
    """

    def tgt_fwd(params_t, seq, cache_t, offsets, adv):
        return forward(cfg_target, params_t, seq, cache_t, offsets)

    def tgt_logits(params_t, h):
        return logits_from_hidden(cfg_target, params_t, h)

    @partial(jax.jit, donate_argnums=(2, 3))
    def step(params_d, params_t, cache_d, cache_t, last_tok, offsets, done):
        return _spec_round_greedy(
            cfg_draft, cfg_target, gamma, eos_id, tgt_fwd, tgt_logits,
            params_d, params_t, cache_d, cache_t, last_tok, offsets, done)

    return step


def make_spec_serving_fn_paged(cfg_draft: LlamaConfig,
                               cfg_target: LlamaConfig, gamma: int,
                               eos_id: int = EOS_ID):
    """make_spec_serving_fn over a PAGED target cache: the draft keeps a
    dense per-slot cache (it is small), the target verify block writes
    into pages at the slot's frontier (models/llama.forward_paged_verify)
    and the accept/EOS/freeze rules match the dense fn exactly.

    (params_d, params_t, cache_d, cache_t, table, last_tok, lengths, done)
      -> (cache_d, cache_t, out [B, gamma+1] (-1 past n_new), n_new [B],
          lengths', done', last_tok')
    """
    from tokenhawk_tpu.models.llama import forward_paged_verify

    @partial(jax.jit, donate_argnums=(2, 3))
    def step(params_d, params_t, cache_d, cache_t, table, last_tok,
             lengths, done):
        def tgt_fwd(params_t, seq, cache_t, lengths, adv):
            return forward_paged_verify(
                cfg_target, params_t, seq, cache_t, table, lengths, adv)

        def tgt_logits(params_t, h):
            return logits_from_hidden(cfg_target, params_t, h)

        return _spec_round_greedy(
            cfg_draft, cfg_target, gamma, eos_id, tgt_fwd, tgt_logits,
            params_d, params_t, cache_d, cache_t, last_tok, lengths, done)

    return step


# ---------------------------------------------------------------------------
# Sampled speculation (rejection sampling)
# ---------------------------------------------------------------------------
#
# Standard speculative sampling (Leviathan et al. / Chen et al.): draft
# token x_i ~ p_d is accepted with probability min(1, p_t(x_i)/p_d(x_i));
# at the first rejection the committed token resamples from the residual
# norm(max(p_t - p_d, 0)); if all gamma drafts are accepted a bonus token
# samples from p_t directly.  Committed outputs are distributed EXACTLY
# as target-only sampling, position by position, for any draft.
#
# Both distributions are the PROCESSED ones (repetition penalty /
# temperature / top-k / top-p via sampling.processed_probs_dynamic) — the
# theorem then reproduces processed-target sampling.  The repetition
# penalty is history-dependent, so both sides carry a LOCAL speculative
# copy of the last-N ring through the round (draft pushes its proposals,
# the target's position-i distribution sees ring + drafts[:i]); the
# committed ring is rebuilt from the accepted tokens only.  Greedy slots
# (temperature <= 0) ride the same code path through exact one-hots:
# match -> ratio 1 (accept), mismatch -> ratio 0 (reject) with a one-hot
# residual at the target's argmax — exactly the greedy accept rule, so
# mixed-temperature batches work.
#
# Each round consumes gamma+2 per-slot counter values (gamma draft
# draws, one uniform row, one residual/bonus draw), advanced uniformly
# so a request's stream never depends on its batch neighbours.


def _ring_push(ring, tok):
    return jnp.concatenate([ring[:, 1:], tok[:, None]], axis=1)


def _accept_sampled(drafts, probs_d, probs_t, sp, counters):
    """Rejection-sampling accept/commit.

    drafts [B, g]; probs_d [B, g, V] draft distributions; probs_t
    [B, g+1, V] target distributions.  Returns (out [B, g+1] committed
    tokens, -1 past position k; k [B] accepted draft counts)."""
    B, g, V = probs_d.shape
    from tokenhawk_tpu.sampling import categorical_probs, uniform_rows

    pt_at = jnp.take_along_axis(
        probs_t[:, :g], drafts[..., None], axis=-1)[..., 0]  # [B, g]
    pd_at = jnp.take_along_axis(
        probs_d, drafts[..., None], axis=-1)[..., 0]
    u = uniform_rows(sp.seed, counters + g, g)  # [B, g]
    # u < min(1, pt/pd)  <=>  u * pd < pt  (pd > 0 at a sampled token)
    acc = u * jnp.maximum(pd_at, 1e-30) < pt_at
    k = jnp.sum(jnp.cumprod(acc.astype(jnp.int32), axis=1), axis=1)

    pt_k = jnp.take_along_axis(
        probs_t, k[:, None, None], axis=1)[:, 0]  # [B, V]
    pd_pad = jnp.concatenate(
        [probs_d, jnp.zeros((B, 1, V), probs_d.dtype)], axis=1)
    pd_k = jnp.take_along_axis(pd_pad, k[:, None, None], axis=1)[:, 0]
    q = jnp.maximum(pt_k - pd_k, 0.0)
    qs = jnp.sum(q, axis=-1, keepdims=True)
    q = jnp.where(qs > 1e-30, q / jnp.maximum(qs, 1e-30), pt_k)
    y = categorical_probs(q, sp.seed, counters + g + 1)  # [B]

    j = jnp.arange(g + 1)[None, :]
    drafts_pad = jnp.concatenate(
        [drafts, jnp.zeros((B, 1), jnp.int32)], axis=1)
    out = jnp.where(j < k[:, None], drafts_pad, -1)
    out = jnp.where(j == k[:, None], y[:, None], out)
    return out, k


def _spec_round_sampled(cfg_draft, cfg_target, gamma, eos_id,
                        target_forward, params_d, params_t, cache_d,
                        cache_t, last_tok, offsets, done, last_n, sp,
                        counters, target_logits=None):
    """Shared body of the dense/paged sampled speculative round.

    `target_logits(params_t, h)` overrides the plain logits head for the
    tensor-parallel twins (vocab-parallel matmul + all-gather).
    eos_id: int or iterable (multi-EOS vocabs)."""
    from tokenhawk_tpu.sampling import is_eos as _tok_is_eos
    from tokenhawk_tpu.sampling import (
        categorical_probs,
        normalize_eos,
        processed_probs_dynamic,
    )

    _, eos_ids = normalize_eos(eos_id)

    B = last_tok.shape[0]
    adv = (~done).astype(jnp.int32)

    def dstep(carry, i):
        cache_d, tok, off, ring = carry
        h, cache_d = forward(cfg_draft, params_d, tok[:, None],
                             cache_d, off)
        lg = logits_from_hidden(cfg_draft, params_d, h[:, 0])
        probs = processed_probs_dynamic(lg, sp, ring)
        nxt = categorical_probs(probs, sp.seed, counters + i)
        return (cache_d, nxt, off + adv, _ring_push(ring, nxt)), (nxt, probs)

    (cache_d, _, _, _), (drafts, probs_d) = jax.lax.scan(
        dstep, (cache_d, last_tok, offsets, last_n), jnp.arange(gamma)
    )
    drafts = drafts.T  # [B, gamma]
    probs_d = jnp.transpose(probs_d, (1, 0, 2))  # [B, gamma, V]

    seq = jnp.concatenate([last_tok[:, None], drafts], axis=1)
    h, cache_t = target_forward(params_t, seq, cache_t, offsets, adv)
    if target_logits is None:
        logits = logits_from_hidden(cfg_target, params_t, h)  # [B, g+1, V]
    else:
        logits = target_logits(params_t, h)

    # Target distributions position by position: position i's penalty
    # history is the committed ring extended with drafts[:i].
    ring = last_n
    pts = []
    for i in range(gamma + 1):
        pts.append(processed_probs_dynamic(logits[:, i], sp, ring))
        if i < gamma:
            ring = _ring_push(ring, drafts[:, i])
    probs_t = jnp.stack(pts, axis=1)  # [B, g+1, V]

    out, k = _accept_sampled(drafts, probs_d, probs_t, sp, counters)

    j = jnp.arange(gamma + 1)[None, :]
    n_new = jnp.where(done, 0, k + 1)
    is_eos = _tok_is_eos(out, eos_ids) & (j < n_new[:, None])
    eos_pos = jnp.min(jnp.where(is_eos, j, gamma + 1), axis=1)
    has_eos = eos_pos <= gamma
    n_new = jnp.where(has_eos, eos_pos + 1, n_new)
    out = jnp.where(j < n_new[:, None], out, -1)

    # Committed ring: push exactly the delivered tokens.
    ring = last_n
    for jj in range(gamma + 1):
        pushed = _ring_push(ring, out[:, jj])
        ring = jnp.where((jj < n_new)[:, None], pushed, ring)

    offsets = offsets + n_new
    done_new = done | has_eos
    last_idx = jnp.clip(n_new - 1, 0, gamma)
    last_new = jnp.take_along_axis(out, last_idx[:, None], axis=1)[:, 0]
    last_tok = jnp.where(done, last_tok, last_new)
    counters = counters + (gamma + 2)
    return (cache_d, cache_t, out, n_new, offsets, done_new, last_tok,
            ring, counters)


def make_spec_serving_fn_sampled(cfg_draft: LlamaConfig,
                                 cfg_target: LlamaConfig, gamma: int,
                                 eos_id: int = EOS_ID):
    """make_spec_serving_fn with per-slot SAMPLED acceptance.

    (params_d, params_t, cache_d, cache_t, last_tok [B], offsets [B],
     done [B], last_n [B, N], sp: SamplingParams, counters [B])
      -> (cache_d, cache_t, out, n_new, offsets', done', last_tok',
          last_n', counters')
    """

    @partial(jax.jit, donate_argnums=(2, 3))
    def step(params_d, params_t, cache_d, cache_t, last_tok, offsets, done,
             last_n, sp, counters):
        def tgt_fwd(params_t, seq, cache_t, offsets, adv):
            return forward(cfg_target, params_t, seq, cache_t, offsets)

        return _spec_round_sampled(
            cfg_draft, cfg_target, gamma, eos_id, tgt_fwd,
            params_d, params_t, cache_d, cache_t, last_tok, offsets, done,
            last_n, sp, counters)

    return step


def make_spec_serving_fn_paged_sampled(cfg_draft: LlamaConfig,
                                       cfg_target: LlamaConfig, gamma: int,
                                       eos_id: int = EOS_ID):
    """Sampled acceptance over a PAGED target cache (see
    make_spec_serving_fn_paged for the cache protocol).

    (params_d, params_t, cache_d, cache_t, table, last_tok, lengths,
     done, last_n, sp, counters)
      -> (cache_d, cache_t, out, n_new, lengths', done', last_tok',
          last_n', counters')
    """
    from tokenhawk_tpu.models.llama import forward_paged_verify

    @partial(jax.jit, donate_argnums=(2, 3))
    def step(params_d, params_t, cache_d, cache_t, table, last_tok,
             lengths, done, last_n, sp, counters):
        def tgt_fwd(params_t, seq, cache_t, lengths, adv):
            return forward_paged_verify(
                cfg_target, params_t, seq, cache_t, table, lengths, adv)

        return _spec_round_sampled(
            cfg_draft, cfg_target, gamma, eos_id, tgt_fwd,
            params_d, params_t, cache_d, cache_t, last_tok, lengths, done,
            last_n, sp, counters)

    return step


class SpeculativeEngine:
    """Greedy generation with draft-model speculation.

    Both models must share the tokenizer/vocab (e.g. LLaMA-7B target
    with a TinyLlama-class draft).  Output is bit-identical to
    `Engine(..., temperature=0).generate`; only throughput changes.
    """

    def __init__(
        self,
        cfg_target: LlamaConfig,
        params_target: LlamaParams,
        cfg_draft: LlamaConfig,
        params_draft: LlamaParams,
        tokenizer: Optional[Tokenizer] = None,
        gamma: int = 4,
        max_seq: Optional[int] = None,
        cache_dtype=jnp.bfloat16,
        eos_id: Optional[int] = None,
    ):
        if eos_id is None:
            eog = getattr(tokenizer, "eog_ids", None)
            if eog:
                eos_id = tuple(sorted(int(e) for e in eog if e >= 0))
            if not eos_id:
                eos_id = getattr(tokenizer, "eos_id", EOS_ID)
            if eos_id is None or (isinstance(eos_id, int) and eos_id < 0):
                eos_id = EOS_ID
        from tokenhawk_tpu.sampling import normalize_eos

        eos_id, self.eos_ids_all = normalize_eos(eos_id)
        if cfg_target.n_vocab != cfg_draft.n_vocab:
            raise ValueError("draft and target must share the vocab")
        from tokenhawk_tpu.runtime.engine import Engine

        self.gamma = gamma
        self.eos_id = eos_id
        self.tokenizer = tokenizer
        # Reuse Engine for prefill/caches on both models (greedy).
        from tokenhawk_tpu.config import SamplingConfig

        greedy = SamplingConfig(temperature=0.0)
        self.target = Engine(cfg_target, params_target, tokenizer=tokenizer,
                             sampling=greedy, max_seq=max_seq,
                             cache_dtype=cache_dtype, eos_id=eos_id)
        self.draft = Engine(cfg_draft, params_draft, tokenizer=tokenizer,
                            sampling=greedy,
                            max_seq=max_seq or cfg_target.n_ctx,
                            cache_dtype=cache_dtype, eos_id=eos_id)
        self._step = make_spec_decode_fn(cfg_draft, cfg_target, gamma)
        self.max_seq = max_seq or cfg_target.n_ctx

    def generate(self, prompt, max_new_tokens: int = 256,
                 on_token=None):
        """Greedy speculative generation for a single prompt.

        Returns (tokens, stats) where stats carries the acceptance data:
        rounds, drafted, accepted, tokens/round."""
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompt needs a tokenizer")
            # encode_prompt handles BOS and the tokenizer-model-specific
            # prefix convention (SPM dummy space vs byte-level BPE none).
            ids = self.tokenizer.encode_prompt(prompt, add_bos=True)
        else:
            ids = list(prompt)

        t_cache = self.target.new_cache(1)
        d_cache = self.draft.new_cache(1)

        t0 = time.perf_counter()
        # Target prefill commits the prompt and greedily picks token 1;
        # draft prefill just fills its cache (its logits are unused).
        t_cache, logits, _ = self.target.prefill(t_cache, [ids])
        d_cache, _, _ = self.draft.prefill(d_cache, [ids])
        first = int(np.asarray(jnp.argmax(logits[0], -1)))
        prefill_s = time.perf_counter() - t0

        tokens: List[int] = [first]
        if on_token:
            on_token(first)
        offsets = jnp.asarray([len(ids)], jnp.int32)
        last = jnp.asarray([first], jnp.int32)
        rounds = 0
        accepted_drafts = 0
        t0 = time.perf_counter()
        while (len(tokens) < max_new_tokens
               and tokens[-1] not in self.eos_ids_all
               and int(offsets[0]) + self.gamma + 1 < self.max_seq):
            d_cache, t_cache, out, n_new, offsets, last = self._step(
                self.draft.params, self.target.params, d_cache, t_cache,
                last, offsets)
            rounds += 1
            n = int(np.asarray(n_new)[0])
            accepted_drafts += n - 1
            new = [int(t) for t in np.asarray(out)[0, :n]]
            for t in new:
                tokens.append(t)
                if on_token:
                    on_token(t)
                if (t in self.eos_ids_all
                        or len(tokens) >= max_new_tokens):
                    break
            if any(t in self.eos_ids_all for t in new):
                break
        decode_s = time.perf_counter() - t0

        stats = {
            "rounds": rounds,
            "drafted": rounds * self.gamma,
            "accepted_drafts": accepted_drafts,
            "acceptance_rate": (accepted_drafts / (rounds * self.gamma)
                                if rounds else 0.0),
            "tokens_per_round": (len(tokens) - 1) / rounds if rounds else 0.0,
            "prefill_seconds": prefill_s,
            "decode_seconds": decode_s,
        }
        return tokens[:max_new_tokens], stats
