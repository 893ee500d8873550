"""Decode-throughput benchmark (driver contract: prints ONE JSON line).

Measures one-GPU LLaMA-7B weight-only-quantized greedy decode, the
headline metric of BASELINE.md (reference: 37 tok/s, LLaMA-7B f16 on an
RTX 4090, token-hawk's README).  vs_baseline is tok/s divided by that
37 tok/s.  It needs a GPU and fails without one; every line it prints
names the card and its power limit.

Weights are synthetic (random quantized payloads generated on device —
decode speed is independent of weight values), sized exactly like
LLaMA-7B: n_embd 4096, n_ff 11008, n_layer 32, n_vocab 32000.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def synth_qweight(key, K, N, kind, scale_dtype):
    """Synthetic quantized weight. Values are constant (iota-derived):
    decode throughput only depends on bytes moved, and constants
    materialize faster than random draws."""
    import jax.numpy as jnp

    from tokenhawk_tpu.ops.qweight import QWeight

    if kind == "f16":  # dense bf16 (BASELINE config 1: LLaMA-7B f16)
        return jnp.full((K, N), 0.01, jnp.bfloat16)

    def scales(rows):
        return jnp.full((rows, N), 0.01, scale_dtype)

    if kind == "q8_0":
        qs = jnp.tile(
            (jnp.arange(256, dtype=jnp.int32) - 128).astype(jnp.int8),
            K * N // 256,
        ).reshape(K, N)
        return QWeight(qs=qs, scales=scales(K // 32), mins=None, kind=kind)
    if kind == "q4_0":
        qs = jnp.tile(jnp.arange(256, dtype=jnp.int32).astype(jnp.uint8),
                      (K // 2) * N // 256).reshape(K // 2, N)
        return QWeight(qs=qs, scales=scales(K // 64), mins=None,
                       scales_hi=scales(K // 64), kind=kind)
    if kind == "q4_k":
        qs = jnp.tile(
            (jnp.arange(16, dtype=jnp.int32) - 8).astype(jnp.int4),
            K * N // 16,
        ).reshape(K, N)
        # Native Q4_K layout: int4 codes + per-group affine
        # (scale, bias) — ~5 bpw on device (ops/qweight.from_kquant_raw)
        return QWeight(qs=qs, scales=scales(K // 32),
                       mins=scales(K // 32), kind="qk_i4", group=32)
    raise ValueError(kind)


def synth_params(cfg, kind, dtype, scale_dtype, fuse=True, unroll=True):
    """Synthetic parameters sized like the real model.

    unroll=True returns the per-layer tuple form with every layer
    REFERENCING the same device buffers.  One layer's weights are far
    larger than the card's L2, so per-token traffic is that of distinct
    buffers, while setup memory stays at one layer.
    """
    import jax
    import jax.numpy as jnp

    from tokenhawk_tpu.models.llama import LayerParams, LlamaParams

    key = jax.random.PRNGKey(0)
    D, F, V, L = cfg.n_embd, cfg.n_ff, cfg.n_vocab, cfg.n_layer
    Dkv = cfg.n_embd_kv
    ks = iter(jax.random.split(key, 16))

    def qw(K, N):
        return synth_qweight(next(ks), K, N, kind, scale_dtype)

    def stack_qw(K, N):
        from tokenhawk_tpu.ops.qweight import QWeight

        w = synth_qweight(next(ks), K, N, kind, scale_dtype)
        if not unroll:
            # Stacked [L, ...] form for lax.scan: broadcast-stacked
            # shared payload (materializes once under jit).
            def bcast(x):
                return None if x is None else jnp.broadcast_to(
                    x[None], (L, *x.shape))

            if kind == "f16":
                return bcast(w)
            return QWeight(
                qs=bcast(w.qs), scales=bcast(w.scales), mins=bcast(w.mins),
                scales_hi=bcast(w.scales_hi), kind=w.kind, group=w.group,
            )
        return w

    if fuse:
        # Build the fused wqkv/w13 forms directly (synthetic payloads are
        # interchangeable): concatenating separate wq/wk/wv on device
        # would double peak device memory during setup.
        layers = LayerParams(
            wq=None, wk=None, wv=None, w1=None, w3=None,
            wqkv=stack_qw(D, D + 2 * Dkv),
            w13=stack_qw(D, 2 * F),
            wo=stack_qw(D, D),
            w2=stack_qw(F, D),
            attn_norm=jnp.ones((L, D), dtype),
            ffn_norm=jnp.ones((L, D), dtype),
        )
    else:
        layers = LayerParams(
            wq=stack_qw(D, D),
            wk=stack_qw(D, Dkv),
            wv=stack_qw(D, Dkv),
            wo=stack_qw(D, D),
            w1=stack_qw(D, F),
            w2=stack_qw(F, D),
            w3=stack_qw(D, F),
            attn_norm=jnp.ones((L, D), dtype),
            ffn_norm=jnp.ones((L, D), dtype),
        )
    if unroll:
        import dataclasses

        # Drop the leading L dim off the norms (tuple form is [D]).
        lp = dataclasses.replace(
            layers,
            attn_norm=jnp.ones((D,), dtype), ffn_norm=jnp.ones((D,), dtype))
        layers = tuple([lp] * L)
    emb = jnp.full((V, D), 0.01, dtype)
    return LlamaParams(
        tok_embd=emb,
        layers=layers,
        norm=jnp.ones((D,), dtype),
        output=qw(D, V),
    )


def step_ab(cfg, params, B, ctx, note, emit, iters=30, trials=3) -> int:
    """Time one compiled paged decode step (every layer + logits + argmax,
    the per-layer pool donated) with the kernels on, each one off, and
    both off: the measurement that decides whether a kernel stays."""
    import jax
    import jax.numpy as jnp

    from tokenhawk_tpu.models.llama import (
        forward_paged_decode,
        logits_from_hidden,
    )
    from tokenhawk_tpu.ops import dispatch
    from tokenhawk_tpu.runtime.paged import make_unrolled_pool

    ps = 128
    mp = ctx // ps
    # tokens already stored: mixed lengths up to the context, or half of it
    lens = (np.linspace(1, ctx - 1, B).astype(np.int32) if B > 1
            else np.asarray([ctx // 2], np.int32))
    table = jnp.asarray(np.arange(B * mp, dtype=np.int32).reshape(B, mp))
    lens = jnp.asarray(lens)
    variants = {"both_kernels": (), "qgemv_only": ("paged_attention",),
                "paged_attention_only": ("qgemv",),
                "plain_xla": dispatch.KERNELS}
    step_ms = {}
    for name, off in variants.items():
        def step(params, pool, tok, table, lens):
            h, pool = forward_paged_decode(cfg, params, tok, pool, table, lens)
            lg = logits_from_hidden(cfg, params, h[:, 0])
            return pool, jnp.argmax(lg, -1).astype(jnp.int32)[:, None]

        pool = make_unrolled_pool(cfg, B * mp, ps)
        tok = jnp.zeros((B, 1), jnp.int32)
        t0 = time.perf_counter()
        with dispatch.kernels_off(*off):
            fn = jax.jit(step, donate_argnums=(1,)).lower(
                params, pool, tok, table, lens).compile()
        compile_s = time.perf_counter() - t0
        temp_mb = fn.memory_analysis().temp_size_in_bytes / 1e6
        pool, tok = jax.block_until_ready(fn(params, pool, tok, table, lens))
        times = []
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(iters):
                pool, tok = fn(params, pool, tok, table, lens)
            jax.block_until_ready(tok)
            times.append((time.perf_counter() - t0) / iters * 1e3)
        step_ms[name] = sorted(times)[len(times) // 2]
        note(f"step B={B} {name}: {step_ms[name]:.3f} ms (trials "
             f"{[round(t, 3) for t in times]}); compile {compile_s:.1f}s; "
             f"temporaries {temp_mb:.1f} MB")
        del pool, fn
    emit(f"paged_decode_step_ms_b{B}", round(step_ms["both_kernels"], 3),
         "ms", 0.0, lengths=[int(n) for n in lens],
         **{f"{k}_ms": round(v, 3) for k, v in step_ms.items()})
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--quant", choices=["f16", "q8_0", "q4_0", "q4_k"],
                   default="q4_0",
                   help="f16 = dense bf16 weights (BASELINE config 1); "
                        "q4_k = native Q4_K affine int4 layout")
    p.add_argument("--ctx", type=int, default=512)
    p.add_argument("--prompt-tokens", type=int, default=64)
    p.add_argument("--tokens", type=int, default=256, help="decode tokens to time")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--chunk", type=int, default=64,
                   help="decode tokens per executable launch (a lax.scan "
                        "inside ONE jit program — the production decode "
                        "fn)")
    p.add_argument("--model", choices=["7b", "13b", "1b"], default="7b")
    p.add_argument("--scale-dtype", choices=["f32", "bf16"], default="bf16",
                   help="quantization scale dtype (bf16 halves scale traffic)")
    p.add_argument("--no-fuse", action="store_true",
                   help="keep wq/wk/wv and w1/w3 as separate matmuls")
    p.add_argument("--unroll", dest="unroll", action="store_true", default=True,
                   help="unroll layers (per-layer weight buffers; default)")
    p.add_argument("--no-unroll", dest="unroll", action="store_false",
                   help="stacked weights + lax.scan over layers")
    p.add_argument("--mode", choices=["decode", "ttft", "serve", "step"],
                   default="decode",
                   help="ttft: time prefill + first token; serve: "
                        "aggregate tok/s through the paged continuous-"
                        "batching scheduler (production serving stack); "
                        "step: one paged decode step (32 layers + logits) "
                        "with each hand-written kernel on and off")
    p.add_argument("--requests", type=int, default=16,
                   help="serve mode: concurrent requests to push through")
    p.add_argument("--prefix-cache", action="store_true",
                   help="serve mode: enable automatic prefix caching")
    p.add_argument("--kv", choices=["bf16", "int8"], default="bf16",
                   help="KV cache dtype (int8 halves KV traffic at long ctx)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a jax.profiler device trace of the "
                        "steady-state decode into DIR")
    p.add_argument("--rope", choices=["half", "interleaved"], default="half",
                   help="rope style; production loads permute wq/wk to "
                        "'half' (rope_half_params), so that is the default")
    p.add_argument("--no-probe", dest="probe", action="store_false",
                   default=True,
                   help="skip the device-memory stream probe (the "
                        "measured yardstick beside the published peak)")
    args = p.parse_args(argv)
    if args.mode == "step" and not args.unroll:
        p.error("--mode step times the per-layer (unrolled) paged forward")
    # serve mode uses the UNROLLED form too: one-card paged forwards
    # pair unrolled weights with the per-layer tuple pool, whose donated
    # arrays update in place (a stacked pool rides lax.scan as xs/ys and
    # is reallocated and rewritten every decode step).

    from tokenhawk_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
    from tokenhawk_tpu.models.llama import KVCache
    from tokenhawk_tpu.runtime.engine import make_decode_fn, make_prefill_fn

    if args.model == "7b":
        cfg = LlamaConfig.llama_7b(n_ctx=args.ctx)
    elif args.model == "13b":
        # BASELINE config 4 shape (13B q4_0 ~= 7.5 GB on device).
        cfg = LlamaConfig.llama_13b(n_ctx=args.ctx)
    else:
        cfg = LlamaConfig(
            n_vocab=32000, n_embd=2048, n_head=16, n_layer=16, n_ctx=args.ctx,
            n_ff=5504,
        )
    if args.rope != cfg.rope_style:
        import dataclasses as _dc

        cfg = _dc.replace(cfg, rope_style=args.rope)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    from tokenhawk_tpu.utils.profiling import card_description, device_peaks

    card = card_description()
    peak_gbps = device_peaks(dev.device_kind)["hbm_gbps"]

    def note(msg: str) -> None:
        print(f"{msg} [{card}]", file=sys.stderr)

    note(f"device: {len(jax.devices())} x {dev.device_kind}")

    # Each timing trial decodes up to (tokens//chunk + 1) chunks past the
    # prompt (+8 slack from recycling); never run past the cache.
    budget = args.ctx - args.prompt_tokens - 16
    max_chunks = max(2, budget // args.chunk - 1)
    if args.tokens // args.chunk > max_chunks:
        args.tokens = max_chunks * args.chunk
        note(f"note: clamped --tokens to {args.tokens} to fit ctx")

    # Device-memory stream probe (plain XLA read stream, no model in the
    # loop): the measured yardstick beside the published peak.  Runs
    # BEFORE the weights are allocated.
    measured_hbm = None
    if args.probe:
        from tokenhawk_tpu.utils.benchlib import hbm_stream_gbps

        t0 = time.perf_counter()
        measured_hbm = hbm_stream_gbps()
        note(f"memory stream probe: {measured_hbm:.0f} GB/s measured "
             f"({measured_hbm / peak_gbps * 100:.0f}% of the published "
             f"{peak_gbps:.0f} GB/s) [{time.perf_counter() - t0:.0f}s]")

    def emit(metric: str, value: float, unit: str, vs_baseline: float,
             **extra) -> None:
        """ONE self-describing JSON line (batch-8 and B=1 must not
        collide on the metric name alone)."""
        rec = {
            "metric": metric, "value": value, "unit": unit,
            "vs_baseline": vs_baseline,
            "model": args.model, "quant": args.quant, "mode": args.mode,
            "batch": args.batch, "ctx": args.ctx,
            "prompt_tokens": args.prompt_tokens, "kv": args.kv,
            "chunk": args.chunk, "card": card,
            "platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
        }
        if measured_hbm is not None:
            rec["measured_hbm_gbps"] = round(measured_hbm, 1)
        rec.update(extra)
        print(json.dumps(rec))

    scale_dtype = jnp.bfloat16 if args.scale_dtype == "bf16" else jnp.float32
    t0 = time.perf_counter()
    params = synth_params(cfg, args.quant, jnp.bfloat16, scale_dtype,
                          fuse=not args.no_fuse, unroll=args.unroll)
    if args.unroll:
        from tokenhawk_tpu.models.llama import unstack_params

        params = unstack_params(params)
    params = jax.block_until_ready(params)
    note(f"synth {args.model} {args.quant} params ready in "
          f"{time.perf_counter() - t0:.1f}s")

    B = args.batch
    if args.mode == "step":
        return step_ab(cfg, params, B, args.ctx, note, emit)

    def new_cache():
        if args.kv == "int8":
            if args.unroll:
                from tokenhawk_tpu.models.llama import make_unrolled_quant_cache

                return make_unrolled_quant_cache(cfg, B, args.ctx)
            from tokenhawk_tpu.models.llama import QuantKVCache

            return QuantKVCache.create(cfg, B, args.ctx)
        if args.unroll:
            from tokenhawk_tpu.models.llama import make_unrolled_cache

            return make_unrolled_cache(cfg, B, args.ctx, jnp.bfloat16)
        return KVCache.create(cfg, B, args.ctx, jnp.bfloat16)

    rng = np.random.default_rng(0)

    if args.mode != "serve":
        cache = new_cache()
        prefill = make_prefill_fn(cfg)
        decode = make_decode_fn(cfg, SamplingConfig(temperature=0.0),
                                args.chunk)
        prompt = jnp.asarray(
            rng.integers(3, cfg.n_vocab, (B, args.prompt_tokens)), jnp.int32)
        lengths = jnp.full((B,), args.prompt_tokens, jnp.int32)
        offsets0 = jnp.zeros((B,), jnp.int32)

        t0 = time.perf_counter()
        cache, logits = prefill(params, cache, prompt, lengths, offsets0)
        logits.block_until_ready()
        prefill_s = time.perf_counter() - t0
        note(f"prefill({args.prompt_tokens} tok): {prefill_s:.2f}s "
              f"(incl. compile)")

    if args.mode == "serve":
        # Production-stack throughput: paged continuous batching with
        # per-request sampling, chunked decode, page allocation — the
        # whole scheduler in the loop (not just the raw decode fn).
        from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler
        from tokenhawk_tpu.runtime.scheduler import Request

        sched = PagedScheduler(
            cfg, params, SamplingConfig(temperature=0.0),
            max_batch=B, max_seq=args.ctx, decode_chunk=args.chunk,
            cache_dtype="int8" if args.kv == "int8" else jnp.bfloat16,
            prefix_cache=args.prefix_cache,
            n_pages=B * (args.ctx // 128) + 2,
        )
        gen_tokens = args.tokens
        if args.prefix_cache:
            # Shared system-prompt prefix (the scenario the cache serves);
            # must span full 128-token pages to be cacheable.
            n_shared = max(256, args.prompt_tokens // 2)
            shared = rng.integers(3, cfg.n_vocab, n_shared).tolist()
            prompts = [
                shared + rng.integers(
                    3, cfg.n_vocab, args.prompt_tokens).tolist()
                for _ in range(args.requests)
            ]
        else:
            prompts = [
                rng.integers(3, cfg.n_vocab, args.prompt_tokens).tolist()
                for _ in range(args.requests)
            ]
        # warmup: compile prefill+decode AND the batched-admission
        # variants the measured region will hit (a same-step group of B
        # admissions prefills as ONE padded Nb=B dispatch — compiling it
        # inside the timed region would swallow the measurement).
        if args.prefix_cache:
            # Warm with THROWAWAY suffixes sharing only the intended
            # prefix: warming with prompts[0] itself put its FULL
            # prompt in the prefix cache, handing request 0 a free
            # whole-prompt hit the other requests don't get (advisor
            # r4).  Pass 2 HITS the shared prefix and compiles the
            # single continuation path; pass 3 compiles the Nb=B
            # batched continuation + fused admit state.
            def warm_prompt():
                return shared + rng.integers(
                    3, cfg.n_vocab, args.prompt_tokens).tolist()

            sched.generate_many([warm_prompt()], max_new_tokens=args.chunk)
            sched.generate_many([warm_prompt()], max_new_tokens=args.chunk)
            sched.generate_many([warm_prompt() for _ in range(B)],
                                max_new_tokens=args.chunk)
        else:
            sched.generate_many([prompts[0]], max_new_tokens=args.chunk)
            warm = [rng.integers(3, cfg.n_vocab,
                                 args.prompt_tokens).tolist()
                    for _ in range(B)]
            sched.generate_many(warm, max_new_tokens=args.chunk)

        # Phase attribution (serve-mode wall must be explainable from
        # its parts): wrap the scheduler's device entry
        # points with blocking timers.  Blocking inside the wrapper
        # serializes what the scheduler already serializes (it consumes
        # every result on host immediately), so the attribution is
        # faithful, not an observer effect.
        import collections

        phase = collections.defaultdict(float)
        calls = collections.defaultdict(int)

        def timed(name, fn):
            def wrapper(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                # Block on ONE output leaf: every call here is a single
                # executable, so one ready buffer means the whole call
                # finished.
                jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
                phase[name] += time.perf_counter() - t
                calls[name] += 1
                return out

            return wrapper

        sched._prefill = timed("prefill", sched._prefill)
        sched._decode = timed("decode", sched._decode)
        if getattr(sched, "_prefill_cont", None) is not None:
            sched._prefill_cont = timed("prefill_cont", sched._prefill_cont)

        t0 = time.perf_counter()
        reqs = [Request(prompt=pr, max_new_tokens=gen_tokens)
                for pr in prompts]
        for r in reqs:
            sched.submit(r)
        while sched.has_work:
            sched.step()
        wall = time.perf_counter() - t0
        dev_s = sum(phase.values())
        note(
            "serve phases: "
            + ", ".join(f"{k} {v:.2f}s/{calls[k]}x" for k, v in phase.items())
            + f"; host+glue {wall - dev_s:.2f}s of {wall:.2f}s wall")
        total = sum(len(r.output) for r in reqs)
        tps = total / wall
        ttfts = sorted(r.ttft_seconds for r in reqs if r.ttft_seconds)
        p50 = ttfts[len(ttfts) // 2] * 1e3 if ttfts else 0.0
        note(f"serve: {args.requests} reqs x {args.prompt_tokens} prompt "
             f"-> {total} tokens in {wall:.2f}s over {B} slots; "
             f"TTFT p50 {p50:.0f} ms")
        emit(
            f"llama{args.model}_{args.quant}_serve_agg_tokens_per_sec_b{B}"
            + ("_kvint8" if args.kv == "int8" else "")
            + ("_pc" if args.prefix_cache else ""),
            round(tps, 2), "tok/s", round(tps / 37.0, 3),
            requests=args.requests, prefix_cache=args.prefix_cache,
            gen_tokens=gen_tokens, ttft_p50_ms=round(p50, 1),
            wall_s=round(wall, 2),
            **{f"{k}_s": round(v, 2) for k, v in phase.items()},
            **{f"{k}_calls": n for k, n in calls.items()},
            host_glue_s=round(wall - dev_s, 2),
        )
        return 0

    if args.mode == "ttft":
        # TTFT = prefill + first-token logits, steady state (cache hot).
        samples = []
        for trial in range(7):
            c2 = new_cache()  # same kv-mode cache as the timed prefill
            t0 = time.perf_counter()
            c2, lg = prefill(params, c2, prompt, lengths, offsets0)
            first = jnp.argmax(lg, -1).astype(jnp.int32)
            np.asarray(first)
            samples.append(time.perf_counter() - t0)
        if args.trace:
            # Device-side attribution of the prefill kernels.
            from tokenhawk_tpu.utils.profiling import trace as _trace

            with _trace(args.trace):
                c2 = new_cache()
                c2, lg = prefill(params, c2, prompt, lengths, offsets0)
                np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))
            note(f"ttft trace written to {args.trace}")
        samples = sorted(samples)[1:-1]  # trim extremes
        p50 = samples[len(samples) // 2] * 1e3
        note(f"TTFT samples (ms): {[f'{s*1e3:.1f}' for s in samples]}")
        # Prefill compute roofline: matrix FLOPs the pass must spend vs
        # the card's published bf16 peak.  p50 is wall time (host
        # dispatch included), so this is a floor on the kernels' share.
        from tokenhawk_tpu.utils.profiling import (
            prefill_roofline_fraction,
            prefill_speed_of_light,
        )

        sol_s = prefill_speed_of_light(cfg, args.prompt_tokens, batch=B)
        frac = prefill_roofline_fraction(cfg, args.prompt_tokens,
                                         p50 / 1e3, batch=B)
        tps_pre = args.prompt_tokens * B / (p50 / 1e3)
        note(
            f"prefill: {tps_pre:.0f} tok/s; bf16 roofline {sol_s * 1e3:.1f} ms "
            f"-> {frac * 100:.0f}% of compute SoL (wall)")
        emit(
            f"llama{args.model}_{args.quant}_ttft_p50_ms_prompt{args.prompt_tokens}"
            + ("_kvint8" if args.kv == "int8" else ""),
            round(p50, 1), "ms",
            0.0,  # the reference published no TTFT numbers
            prefill_tokens_per_sec=round(tps_pre, 1),
            bf16_roofline_ms=round(sol_s * 1e3, 2),
            pct_of_bf16_roofline=round(frac * 100, 1),
        )
        return 0

    last = jnp.argmax(logits, -1).astype(jnp.int32)
    last_n = jnp.full((B, 64), -1, jnp.int32)
    done = jnp.zeros((B,), bool)
    offsets = lengths

    # Warmup decode (compile)
    t0 = time.perf_counter()
    cache, toks, offsets, last_n, done = decode(
        params, cache, last, offsets, last_n, done, jax.random.PRNGKey(0)
    )
    np.asarray(toks)
    note(f"decode compile+first chunk: {time.perf_counter() - t0:.1f}s")

    def run_chunks(n, cache, toks, offsets, last_n, done):
        t0 = time.perf_counter()
        for i in range(n):
            cache, toks, offsets, last_n, done = decode(
                params, cache, toks[:, -1], offsets, last_n, done,
                jax.random.PRNGKey(i),
            )
        np.asarray(toks)
        return time.perf_counter() - t0, (cache, toks, offsets, last_n, done)

    # Steady-state timing. The first post-compile call pays one-off
    # costs (donation rebinding), so: one throwaway pass, then time n2
    # chunks directly.
    n2 = max(2, args.tokens // args.chunk)
    state = (cache, toks, offsets, last_n, done)

    def recycle(state):
        cache2, toks2, offsets2, last_n2, done2 = state
        new_off = jnp.minimum(offsets2, args.prompt_tokens + 8)
        return (cache2, toks2, new_off, last_n2, jnp.zeros_like(done2))

    _, state = run_chunks(1, *state)  # throwaway (post-compile one-offs)
    if args.trace:
        from tokenhawk_tpu.utils.profiling import trace as _trace

        with _trace(args.trace):
            _, state = run_chunks(max(1, n2 // 2), *state)
        state = recycle(state)
        note(f"trace of {max(1, n2 // 2) * args.chunk} decode tokens "
             f"written to {args.trace}")
    times = []
    for trial in range(3):
        t, state = run_chunks(n2, *state)
        times.append(t)
        note(f"trial {trial}: T({n2} chunks)={t:.3f}s")
        state = recycle(state)
    dt = sorted(times)[len(times) // 2]  # median
    per_chunk = dt / n2
    n_tok = n2 * args.chunk
    tps = args.chunk * B / per_chunk
    per_tok_ms = per_chunk / args.chunk * 1e3

    from tokenhawk_tpu.utils.profiling import (
        decode_speed_of_light,
        weight_stream_bytes,
    )

    wbytes = weight_stream_bytes(params)
    achieved_bw = wbytes * (tps / B) / 1e9
    n_past_mid = args.prompt_tokens + n_tok // 2
    sol = decode_speed_of_light(
        params, cfg=cfg, n_past=n_past_mid, batch=B,
        kv_dtype_bytes=1 if args.kv == "int8" else 2)
    extra = {
        "weight_gb_per_tok": round(wbytes / 1e9, 3),
        "achieved_gbps": round(achieved_bw, 1),
        "pct_of_spec_sol": round(tps / B / sol * 100, 1),
    }
    line = (
        f"decode: {n_tok} tok x batch {B} in {dt:.2f}s -> {tps:.1f} tok/s "
        f"({per_tok_ms:.1f} ms/tok); weights {wbytes / 1e9:.2f} GB/tok -> "
        f"{achieved_bw:.0f} GB/s weight stream; "
        f"roofline {sol:.1f} tok/s (published peak) -> "
        f"{tps / B / sol * 100:.0f}% of spec SoL"
    )
    if measured_hbm is not None:
        # Roofline against the card's MEASURED stream bandwidth: the
        # same bytes-per-token accounting, ceilinged by what a plain
        # read stream achieves on this card today.
        sol_meas = sol * measured_hbm / peak_gbps
        extra["pct_of_measured_sol"] = round(tps / B / sol_meas * 100, 1)
        line += (f"; measured-band roofline {sol_meas:.1f} tok/s -> "
                 f"{tps / B / sol_meas * 100:.0f}% of measured SoL")
    note(line)

    emit(
        f"llama{args.model}_{args.quant}_decode_tokens_per_sec"
        + (f"_b{B}" if B > 1 else "")  # batch-8 must not clobber B=1
        + ("_kvint8" if args.kv == "int8" else ""),
        round(tps, 2), "tok/s", round(tps / 37.0, 3),
        **extra,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
