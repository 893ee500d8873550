"""Generation engine: jit-compiled prefill + decode with on-device sampling.

JAX redesign of the reference's generation loop
(/root/reference/th-llama.cpp:111-238 `do_inference` /
`sync_continue_inference`): where the reference re-encodes a command
buffer, submits it, spins on a map-read and samples on the CPU *for every
token* (/root/reference/th-llama.cpp:662-727), here

  - prefill is one jitted call on a padded token bucket (the reference
    feeds prompts one token at a time, kAllowedSubsequentBatchSize=1,
    /root/reference/th-llama.cpp:15);
  - decode runs CHUNK tokens per device call via `lax.scan`, with
    sampling, repeat-penalty ring buffer, EOS latching and KV append all
    on device; only sampled token ids cross the host boundary;
  - KV caches are donated, so decode is in-place in device memory.

Streaming callbacks (`on_token`) mirror the reference's onNewToken /
onInferenceComplete / onError model callbacks
(/root/reference/th-llama.hpp:159-161).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models.llama import (
    KVCache,
    LlamaParams,
    forward,
    logits_from_hidden,
)
from tokenhawk_tpu.sampling import is_eos as _is_eos
from tokenhawk_tpu.sampling import normalize_eos, sample
from tokenhawk_tpu.tokenizer import BOS_ID, EOS_ID, Tokenizer


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    text: str
    prompt_tokens: int
    prefill_seconds: float
    decode_seconds: float

    @property
    def decode_tokens_per_second(self) -> float:
        n = len(self.tokens)
        return n / self.decode_seconds if self.decode_seconds > 0 else 0.0


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


def make_prefill_fn(cfg: LlamaConfig):
    """jit fn: (params, cache, tokens [B,Tb], lengths [B], offsets [B]) ->
    (cache, last_logits [B,V])."""

    @partial(jax.jit, donate_argnums=(1,))
    def prefill(params, cache, tokens, lengths, offsets):
        h, cache = forward(cfg, params, tokens, cache, offsets)
        idx = jnp.clip(lengths - 1, 0, tokens.shape[1] - 1)
        h_last = jnp.take_along_axis(h, idx[:, None, None], axis=1)[:, 0]
        logits = logits_from_hidden(cfg, params, h_last)
        return cache, logits

    return prefill


def make_decode_fn(cfg: LlamaConfig, sampling: SamplingConfig, chunk: int,
                   eos_id: int = EOS_ID):
    """jit fn decoding `chunk` tokens on device.

    (params, cache, last_tok [B], offsets [B], last_n [B,N], done [B], key)
      -> (cache, tokens [B,chunk], offsets, last_n, done)

    eos_id: int, or an iterable for multi-EOS vocabs (Llama-3 instruct
    stops on <|end_of_text|> AND <|eot_id|>).
    """
    eos0, eos_ids = normalize_eos(eos_id)

    @partial(jax.jit, donate_argnums=(1,))
    def decode(params, cache, last_tok, offsets, last_n, done, key):
        def step(carry, k):
            cache, tok, off, last_n, done = carry
            h, cache = forward(cfg, params, tok[:, None], cache, off)
            logits = logits_from_hidden(cfg, params, h[:, 0])
            nxt = sample(logits, k, sampling, last_n)
            nxt = jnp.where(done, jnp.int32(eos0), nxt)
            # Done/idle slots must not advance: in long-lived serving an
            # unbounded offset walks past the cache end (out-of-range
            # cache writes and stale-cache unmasking).
            off = off + jnp.where(done, 0, 1)
            done = done | _is_eos(nxt, eos_ids)
            last_n = jnp.concatenate([last_n[:, 1:], nxt[:, None]], axis=1)
            return (cache, nxt, off, last_n, done), nxt

        keys = jax.random.split(key, chunk)
        (cache, tok, offsets, last_n, done), toks = jax.lax.scan(
            step, (cache, last_tok, offsets, last_n, done), keys
        )
        return cache, toks.T, offsets, last_n, done

    return decode


def make_decode_fn_dynamic(cfg: LlamaConfig, chunk: int, eos_id: int = EOS_ID):
    """Decode chunk with PER-SLOT sampling parameters (device arrays).

    (params, cache, last_tok [B], offsets [B], last_n [B,N], done [B],
     sp: SamplingParams, counters [B])
      -> (cache, tokens [B,chunk], offsets, last_n, done, counters)

    Each slot has its own (seed, counter) RNG stream, so a request's
    output is reproducible regardless of its batch neighbours.
    """
    from tokenhawk_tpu.sampling import sample_dynamic

    eos0, eos_ids = normalize_eos(eos_id)

    @partial(jax.jit, donate_argnums=(1,))
    def decode(params, cache, last_tok, offsets, last_n, done, sp, counters):
        def step(carry, _):
            cache, tok, off, last_n, done, counters = carry
            h, cache = forward(cfg, params, tok[:, None], cache, off)
            logits = logits_from_hidden(cfg, params, h[:, 0])
            nxt = sample_dynamic(logits, sp, counters, last_n)
            nxt = jnp.where(done, jnp.int32(eos0), nxt)
            off = off + jnp.where(done, 0, 1)
            counters = counters + 1
            done = done | _is_eos(nxt, eos_ids)
            last_n = jnp.concatenate([last_n[:, 1:], nxt[:, None]], axis=1)
            return (cache, nxt, off, last_n, done, counters), nxt

        (cache, tok, offsets, last_n, done, counters), toks = jax.lax.scan(
            step, (cache, last_tok, offsets, last_n, done, counters),
            None, length=chunk,
        )
        return cache, toks.T, offsets, last_n, done, counters

    return decode


class Engine:
    """Single-model inference engine (synchronous API).

    For request-level scheduling/continuous batching see
    `tokenhawk_tpu.runtime.scheduler`.
    """

    def __init__(
        self,
        cfg: LlamaConfig,
        params: LlamaParams,
        tokenizer: Optional[Tokenizer] = None,
        sampling: SamplingConfig = SamplingConfig(),
        max_seq: Optional[int] = None,
        batch_size: int = 1,
        cache_dtype=jnp.bfloat16,
        decode_chunk: int = 8,
        eos_id: Optional[int] = None,
        mesh=None,
        parallel: str = "gspmd",  # "gspmd" | "tp" (shard_map, kernel-capable)
    ):
        if eos_id is None:
            # The tokenizer knows the file's end-of-generation ids
            # (Llama-3 BPE vocabs stop on 128001 AND 128009, not the SPM
            # default 2).
            eog = getattr(tokenizer, "eog_ids", None)
            if eog:
                eos_id = tuple(sorted(int(e) for e in eog if e >= 0))
            if not eos_id:
                eos_id = getattr(tokenizer, "eos_id", EOS_ID)
            if eos_id is None or (isinstance(eos_id, int) and eos_id < 0):
                eos_id = EOS_ID
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.parallel = parallel
        self.tokenizer = tokenizer
        self.sampling = sampling
        self.max_seq = max_seq or cfg.n_ctx
        self.batch_size = batch_size
        if cache_dtype == "auto":
            # int8 KV halves the cache's bytes; pick it whenever the
            # context is long enough for the cache to rival the weights.
            # The shard_map TP/CP paths carry bf16 caches (int8 sharding
            # not wired), so auto only upgrades the single-mesh path.
            cache_dtype = ("int8" if self.max_seq >= 1024 and mesh is None
                           else jnp.bfloat16)
        self.cache_dtype = cache_dtype
        self.decode_chunk = decode_chunk
        self.eos_id, self.eos_ids = normalize_eos(eos_id)
        eos_id = self.eos_ids if len(self.eos_ids) > 1 else self.eos_id

        if mesh is not None and parallel == "tp":
            from tokenhawk_tpu.parallel.tp import (
                make_tp_decode_fn,
                make_tp_prefill_fn,
            )

            self._prefill = make_tp_prefill_fn(cfg, mesh, params)
            self._decode = make_tp_decode_fn(cfg, mesh, sampling, decode_chunk,
                                             eos_id, params)
            self._make_decode1 = lambda: make_tp_decode_fn(
                cfg, mesh, sampling, 1, eos_id, params)
        elif mesh is not None and parallel == "pp":
            from tokenhawk_tpu.parallel.pp import (
                make_pp_decode_fn,
                make_pp_prefill_fn,
                validate_pp,
            )
            from tokenhawk_tpu.parallel.mesh import STAGE_AXIS

            validate_pp(cfg, mesh.shape[STAGE_AXIS])
            self._prefill = make_pp_prefill_fn(cfg, mesh, params)
            self._decode = make_pp_decode_fn(cfg, mesh, sampling, decode_chunk,
                                             eos_id, params)
            self._make_decode1 = lambda: make_pp_decode_fn(
                cfg, mesh, sampling, 1, eos_id, params)
        elif mesh is not None and parallel == "cp":
            from tokenhawk_tpu.parallel.cp import (
                make_cp_decode_fn,
                make_cp_prefill_fn,
                validate_cp,
            )
            from tokenhawk_tpu.parallel.mesh import CTX_AXIS

            validate_cp(cfg, mesh.shape[CTX_AXIS], max_seq or cfg.n_ctx)
            self._prefill = make_cp_prefill_fn(cfg, mesh, params)
            self._decode = make_cp_decode_fn(cfg, mesh, sampling, decode_chunk,
                                             eos_id, params)
            self._make_decode1 = lambda: make_cp_decode_fn(
                cfg, mesh, sampling, 1, eos_id, params)
        else:
            self._prefill = make_prefill_fn(cfg)
            self._decode = make_decode_fn(cfg, sampling, decode_chunk, eos_id)
            self._make_decode1 = lambda: make_decode_fn(cfg, sampling, 1, eos_id)
        # The 1-step tail decode compiles lazily: it is only needed when a
        # generation budget isn't a multiple of decode_chunk near the
        # context edge, and each extra compile costs seconds.
        self._decode1_cache = None

        # Prefill buckets: powers of two up to max_seq (shape-specialized
        # compilations, the XLA analogue of the reference's per-shape WGSL
        # pipeline cache, /root/reference/th.cpp:89-134).
        self.buckets = []
        b = 16
        while b < self.max_seq:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(self.max_seq)

        self._key = jax.random.PRNGKey(sampling.seed)

    # -- low-level API ---------------------------------------------------

    def new_cache(self, batch: Optional[int] = None):
        if self.cache_dtype == "int8":  # quantized KV (ops/kvquant.py)
            if isinstance(self.params.layers, tuple):
                from tokenhawk_tpu.models.llama import make_unrolled_quant_cache

                return make_unrolled_quant_cache(
                    self.cfg, batch or self.batch_size, self.max_seq
                )
            from tokenhawk_tpu.models.llama import QuantKVCache

            return QuantKVCache.create(
                self.cfg, batch or self.batch_size, self.max_seq
            )
        if isinstance(self.params.layers, tuple):  # unrolled-layer params
            from tokenhawk_tpu.models.llama import make_unrolled_cache

            cache = make_unrolled_cache(
                self.cfg, batch or self.batch_size, self.max_seq,
                self.cache_dtype,
            )
            if self.mesh is not None and self.parallel == "tp":
                from tokenhawk_tpu.parallel.tp import shard_cache_tp

                cache = shard_cache_tp(cache, self.mesh)
            elif self.mesh is not None and self.parallel == "cp":
                from tokenhawk_tpu.parallel.cp import shard_cache_cp

                cache = shard_cache_cp(cache, self.mesh)
            return cache
        cache = KVCache.create(
            self.cfg, batch or self.batch_size, self.max_seq, self.cache_dtype
        )
        if self.mesh is not None and self.parallel == "pp":
            from tokenhawk_tpu.parallel.pp import shard_cache_pp

            return shard_cache_pp(cache, self.mesh)
        if self.mesh is not None:
            from tokenhawk_tpu.parallel import shard_kv_cache

            cache = shard_kv_cache(cache, self.mesh)
        return cache

    def prefill(self, cache: KVCache, prompts: Sequence[Sequence[int]],
                offsets: Optional[np.ndarray] = None):
        """Prefill a batch of prompts (padded to one bucket)."""
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        Tb = _bucket(int(lens.max()), self.buckets)
        toks = np.zeros((B, Tb), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        if offsets is None:
            offsets = np.zeros((B,), np.int32)
        cache, logits = self._prefill(
            self.params, cache, jnp.asarray(toks), jnp.asarray(lens),
            jnp.asarray(offsets),
        )
        return cache, logits, lens

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    # -- user API --------------------------------------------------------

    def generate(
        self,
        prompt: Sequence[int] | str,
        max_new_tokens: int = 500,
        on_token: Optional[Callable[[int], None]] = None,
        on_text: Optional[Callable[[str], None]] = None,
    ) -> GenerationResult:
        """Generate from a single prompt, streaming tokens as they arrive.

        max_new_tokens defaults to the reference's 500-token cap
        (/root/reference/th-llama.cpp:17).
        """
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompt requires a tokenizer")
            prompt_ids = self.tokenizer.encode_prompt(prompt, add_bos=True)
        else:
            prompt_ids = list(prompt)
        if not prompt_ids:
            bos = getattr(self.tokenizer, "bos_id", BOS_ID)
            prompt_ids = [bos if bos is not None and bos >= 0 else BOS_ID]
        if len(prompt_ids) >= self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt_ids)} tokens) exceeds context {self.max_seq}"
            )

        t0 = time.perf_counter()
        cache = self.new_cache(batch=1)
        cache, logits, lens = self.prefill(cache, [prompt_ids])

        # First sampled token comes from the prefill logits.
        n_ring = max(self.sampling.repeat_last_n, 1)
        last_n = np.full((1, n_ring), -1, np.int32)
        m = min(n_ring, len(prompt_ids))
        last_n[0, n_ring - m :] = prompt_ids[-m:]
        last_n = jnp.asarray(last_n)

        first = sample(logits, self._next_key(), self.sampling, last_n)
        first_id = int(first[0])
        jax.block_until_ready(first)
        t1 = time.perf_counter()

        out_tokens: List[int] = []
        done_host = False

        def emit(tid: int) -> bool:
            nonlocal done_host
            if tid in self.eos_ids:
                done_host = True
                return False
            out_tokens.append(tid)
            if on_token:
                on_token(tid)
            if on_text and self.tokenizer:
                on_text(self.tokenizer.decode_token_bytes(tid).decode("utf-8", "replace"))
            return True

        emit(first_id)
        last_n = jnp.concatenate([last_n[:, 1:], first[:, None]], axis=1)

        offsets = jnp.asarray([len(prompt_ids)], jnp.int32)
        done = jnp.asarray([done_host])
        last_tok = first

        budget = min(max_new_tokens, self.max_seq - len(prompt_ids) - 1)
        produced = 1
        position = len(prompt_ids)  # host mirror of offsets[0]
        while produced < budget and not done_host:
            n = min(self.decode_chunk, budget - produced)
            # A full chunk may overshoot the requested budget; that is fine
            # as long as the KV cache has room for the whole chunk.
            if n == self.decode_chunk or self.max_seq - position > self.decode_chunk:
                fn = self._decode  # full chunk; surplus tokens are discarded
                steps = self.decode_chunk
            else:
                if self._decode1_cache is None:
                    self._decode1_cache = self._make_decode1()
                fn = self._decode1_cache
                steps = 1
            cache, toks, offsets, last_n, done = fn(
                self.params, cache, last_tok, offsets, last_n, done,
                self._next_key(),
            )
            position += steps
            toks_host = np.asarray(toks)[0]
            last_tok = toks[:, -1]
            for t in toks_host[:n]:
                produced += 1
                if not emit(int(t)):
                    break
            if done_host or int(toks_host[-1]) in self.eos_ids:
                done_host = True
        t2 = time.perf_counter()

        text = self.tokenizer.decode(out_tokens) if self.tokenizer else ""
        return GenerationResult(
            tokens=out_tokens,
            text=text,
            prompt_tokens=len(prompt_ids),
            prefill_seconds=t1 - t0,
            decode_seconds=t2 - t1,
        )
