"""HTTP chat server entry point.

    python -m tokenhawk_tpu.serving -m model.bin --port 22345

Reference parity: the web frontend's serve.py + WASM chat
(/root/reference/web/serve.py:1-20, web/main.cpp:82-179), except the
model runs server-side on the GPU behind an SSE streaming API, with
continuous batching, multi-turn sessions, per-request sampling, and
optional speculative decoding (--draft-model).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tokenhawk-serve", description="Quantized LLaMA chat server"
    )
    p.add_argument("-m", "--model", help="GGML model file")
    p.add_argument("-d", "--dir", help="TH chunk directory (split model)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=22345,
                   help="reference web/serve.py port parity")
    p.add_argument("--n-ctx", type=int, default=2048)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--decode-chunk", type=int, default=8)
    p.add_argument("--temp", type=float, default=0.80)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--repeat-penalty", type=float, default=1.10)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--seed", type=int, default=780658349)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--paged", action="store_true",
                   help="paged-KV continuous batching (page pool instead "
                        "of per-slot dense caches; enables --prefill-chunk)")
    p.add_argument("--page-size", type=int, default=128)
    p.add_argument("--prefix-cache", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="automatic cross-request prefix caching over the "
                        "page pool (paged only; shared prompt pages are "
                        "reused, only the uncached suffix prefills).  ON "
                        "by default — paged sessions replay conversation "
                        "text and rely on it; --no-prefix-cache reverts")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="admit long prompts in chunks of this many tokens "
                        "interleaved with decode (paged only; bounds the "
                        "stall a long prompt inflicts on live streams)")
    p.add_argument("--kv", choices=["bf16", "int8"], default="bf16",
                   help="paged KV dtype (int8 halves page traffic)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways: shard weights, KV (and "
                        "the page pool with --paged) across a TP mesh "
                        "(parallel/tp.py, tp_paged.py).  CP/PP are "
                        "engine-level (see ARCHITECTURE.md)")
    p.add_argument("--draft-model",
                   help="GGML draft model: speculative continuous batching "
                        "(greedy only; outputs identical to the target)")
    p.add_argument("--gamma", type=int, default=4)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    model_path = args.model or args.dir
    if not model_path:
        parser.error("one of -m/--model or -d/--dir is required")

    from tokenhawk_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from tokenhawk_tpu.config import SamplingConfig
    from tokenhawk_tpu.runtime.loader import load_model
    from tokenhawk_tpu.runtime.scheduler import Scheduler
    from tokenhawk_tpu.serving.server import serve

    dtype = jnp.bfloat16 if args.dtype == "bf16" else jnp.float32
    mesh = None
    if args.tp > 1:
        from tokenhawk_tpu.parallel import make_mesh

        mesh = make_mesh(dp=1, tp=args.tp)
    print(f"Loading {model_path} ...", file=sys.stderr)
    t0 = time.perf_counter()
    cfg, params, tokenizer = load_model(model_path, n_ctx=args.n_ctx,
                                        dtype=dtype, mesh=mesh,
                                        parallel="tp")
    print(f"Loaded in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # Speculative serving supports sampling: greedy slots use the
    # exact-match rule, sampled slots rejection sampling (distributed
    # exactly as target-only sampling) — runtime/speculative.py.
    sampling = SamplingConfig(
        temperature=0.0 if args.greedy else args.temp,
        top_k=args.top_k, top_p=args.top_p,
        repeat_penalty=args.repeat_penalty, seed=args.seed,
    )
    draft_cfg = draft_params = None
    if args.draft_model:
        draft_cfg, draft_params, _ = load_model(
            args.draft_model, n_ctx=args.n_ctx, dtype=dtype)

    # The file's end-of-generation ids (Llama-3 BPE vocabs stop on
    # 128001 AND the chat terminator 128009, not the SPM default 2).
    eog = getattr(tokenizer, "eog_ids", None)
    eos_id = tuple(sorted(int(e) for e in eog if e >= 0)) if eog else None
    if not eos_id:
        eos_id = getattr(tokenizer, "eos_id", 2)
    if eos_id is None or (isinstance(eos_id, int) and eos_id < 0):
        eos_id = 2
    if args.paged:
        from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler

        sched = PagedScheduler(
            cfg, params, sampling=sampling, max_batch=args.max_batch,
            max_seq=args.n_ctx, decode_chunk=args.decode_chunk,
            page_size=args.page_size,
            cache_dtype="int8" if args.kv == "int8" else dtype,
            prefill_chunk=args.prefill_chunk,
            prefix_cache=args.prefix_cache,
            draft_cfg=draft_cfg, draft_params=draft_params,
            gamma=args.gamma, mesh=mesh, eos_id=eos_id,
        )
    else:
        sched = Scheduler(
            cfg, params, sampling=sampling, max_batch=args.max_batch,
            max_seq=args.n_ctx, decode_chunk=args.decode_chunk,
            draft_cfg=draft_cfg, draft_params=draft_params, gamma=args.gamma,
            mesh=mesh, parallel="tp", eos_id=eos_id,
        )
    chat_template = None
    try:
        from tokenhawk_tpu.ggml.gguf import GGUFFile, is_gguf

        if is_gguf(model_path):
            with GGUFFile(model_path) as gf:
                chat_template = gf.metadata.get("tokenizer.chat_template")
    except (OSError, ValueError):
        pass
    httpd = serve(sched, tokenizer, host=args.host, port=args.port,
                  model_info={"model": model_path, "n_ctx": args.n_ctx,
                              "paged": args.paged,
                              "chat_template": chat_template,
                              "speculative": bool(args.draft_model)})
    print(f"Serving on http://{args.host}:{args.port}", file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.serving_loop.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
