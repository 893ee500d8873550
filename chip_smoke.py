#!/usr/bin/env python3
"""On-card smoke test: the paged LLaMA-7B q4_0 server end to end on one GPU.

    python chip_smoke.py                # one GPU: every phase below
    python chip_smoke.py --four-cards   # four GPUs: TP=4 paged serving only

Phases (one process; any failure exits non-zero before the last line):
  1. device check: JAX must see a GPU; prints the card and power limit;
  2. kernel parity at 7B widths: every kept kernel against the plain
     reference (f32, highest matmul precision), its error beside the
     stated tolerance, a check that the 7B shapes take the kernel
     (Triton custom call in the lowered program), and its time beside
     the plain XLA version;
  3. serve: a seeded 7B-width q4_0 GGUF (written once under
     .smoke_models/) -> load_model -> PagedScheduler -> HTTP/SSE server,
     four concurrent requests, and the served first-step logits against
     the plain path (no hand-written kernel);
  4. CLI: tokenhawk_tpu.cli.main in this process on the same file;
  5. informational decode tok/s, TTFT and compile seconds (not claims).

The last line of stdout is the JSON result.  tests/test_chip_smoke.py
drives the serve, CLI and four-card phases on the CPU at toy widths.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import socket
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 1234

# Tolerances, stated with their reason:
#  - kernel vs f32 reference: the kernel rounds its output to bf16
#    (2^-8 relative); max |err| is judged against max |ref| of the call.
KERNEL_TOL = 1e-2
#  - served vs plain first-step logits, and TP=4 vs one card: the two
#    programs round bf16 activations and weights in different places and
#    sum in different orders.  Measured on an H100: 2.7e-3 (prefill) and
#    2.9e-3 (decode) at 7B widths and full depth, 5.2e-3 for TP=4 at 70B
#    widths; the limit is about twice the largest reading.  Planted
#    faults read far above it at toy widths on the CPU: 3.4e-1 with the
#    GEMV scaling q4_0's high nibbles by the low nibbles' scales, 6.0e-2
#    with paged attention skipping each sequence's last live page.
LOGITS_TOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rel_err(got, ref) -> tuple[float, float]:
    import numpy as np

    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    err = float(np.max(np.abs(got - ref)))
    return err, err / max(float(np.max(np.abs(ref))), 1e-30)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_in_graph(fn, x, *args, iters: int = 50) -> float:
    """Seconds per call of fn(x, *args), from `iters` chained calls in
    one program (the carry feeds each call so XLA cannot hoist it)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(x, *args):
        def body(i, acc):
            y = fn(x + (acc * 0).astype(x.dtype), *args)
            return acc + jnp.sum(y.astype(jnp.float32)) * 1e-30

        return jax.lax.fori_loop(0, iters, body, jnp.float32(0))

    jax.block_until_ready(loop(x, *args))
    t0 = time.perf_counter()
    jax.block_until_ready(loop(x, *args))
    return (time.perf_counter() - t0) / iters


# ---------------------------------------------------------------------------
# Phase 2: kernel parity
# ---------------------------------------------------------------------------


def synth_q4(key, K, N, scale_dtype):
    import jax
    import jax.numpy as jnp

    from tokenhawk_tpu.ops.qweight import QWeight

    k1, k2, k3 = jax.random.split(key, 3)
    qs = jax.random.bits(k1, (K // 2, N), jnp.uint8)

    def sc(k):
        return jax.random.uniform(k, (K // 64, N), jnp.float32, 2e-3,
                                  6e-3).astype(scale_dtype)

    return QWeight(qs=qs, scales=sc(k2), mins=None, scales_hi=sc(k3),
                   kind="q4_0")


def synth_qk(key, K, N, kind):
    import jax
    import jax.numpy as jnp

    from tokenhawk_tpu.ops.qweight import QWeight

    k1, k2, k3 = jax.random.split(key, 3)
    if kind == "q8_0":
        qs = jax.random.randint(k1, (K, N), -127, 128, jnp.int32)
        qs, mins = qs.astype(jnp.int8), None
    else:  # qk_i4: Q4_K-style affine int4 codes
        qs = jax.random.randint(k1, (K, N), -8, 8, jnp.int32).astype(jnp.int4)
        mins = jax.random.normal(k3, (K // 32, N), jnp.float32).astype(
            jnp.bfloat16) * 1e-2
    scales = jax.random.uniform(k2, (K // 32, N), jnp.float32, 2e-3,
                                6e-3).astype(jnp.bfloat16)
    return QWeight(qs=qs, scales=scales, mins=mins, scales_hi=None,
                   kind=kind, group=32)


def lowered_has_triton(fn, *args) -> bool:
    import jax

    text = jax.jit(fn).lower(*args).as_text()
    return "triton" in text


def gemv_parity(widths, card, results):
    import jax
    import jax.numpy as jnp

    from tokenhawk_tpu.ops.linear import _matmul_quant, matmul
    from tokenhawk_tpu.ops.pallas import qgemv

    key = jax.random.PRNGKey(SEED)
    cases = [("q4_0", K, N) for K, N in widths["gemv"]]
    cases += [("q8_0", *widths["gemv"][2]), ("qk_i4", *widths["gemv"][2])]
    for kind, K, N in cases:
        key, kw, kx = jax.random.split(key, 3)
        w = (synth_q4(kw, K, N, jnp.bfloat16) if kind == "q4_0"
             else synth_qk(kw, K, N, kind))
        wf = w.dequantize(jnp.float32)
        rows_list = widths["rows"] if kind == "q4_0" else widths["rows"][:2]
        for rows in rows_list:
            x = jax.random.normal(kx, (rows, K), jnp.float32).astype(
                jnp.bfloat16)
            takes = qgemv.supported(rows, w)
            check(takes == (rows <= qgemv.MAX_ROWS),
                  f"kernel rule for {kind} {rows}x{K}x{N}: {takes}")
            if takes:
                check(lowered_has_triton(matmul, x, w),
                      f"{kind} {rows}x{K}x{N} did not lower to Triton")
            got = jax.jit(matmul)(x, w)
            with jax.default_matmul_precision("highest"):
                ref = jax.jit(jnp.dot)(x.astype(jnp.float32), wf)
            err, rel = rel_err(got, ref)
            path = "kernel" if takes else "plain"
            ok = rel <= KERNEL_TOL
            line = (f"parity gemv {kind} {rows}x{K}x{N} [{path}]: max abs err "
                    f"{err:.3e}, rel {rel:.2e} (tol {KERNEL_TOL:.0e}) "
                    f"{'ok' if ok else 'FAIL'}")
            if takes:
                t_k = time_in_graph(matmul, x, w)
                t_x = time_in_graph(
                    lambda x, w: _matmul_quant(x, w), x, w)
                results.append(dict(op="gemv", kind=kind, rows=rows, K=K,
                                    N=N, kernel_us=t_k * 1e6,
                                    xla_us=t_x * 1e6))
                line += (f"; kernel {t_k * 1e6:.1f} us vs plain XLA "
                         f"{t_x * 1e6:.1f} us [{card}]")
            log(line)
            check(ok, f"gemv {kind} {rows}x{K}x{N} rel err {rel:.2e}")


def attention_reference(q, k_pages, v_pages, table, lengths, contig):
    """f32 paged decode attention at highest precision (plain gather)."""
    import jax
    import jax.numpy as jnp

    B, H, Dh = q.shape
    if contig:
        kg = jnp.swapaxes(k_pages[table], 1, 2)
        vg = jnp.swapaxes(v_pages[table], 1, 2)
    else:
        kg = jnp.swapaxes(k_pages[:, table], 0, 1)
        vg = jnp.swapaxes(v_pages[:, table], 0, 1)
    _, Hkv, mp, ps, _ = kg.shape
    kg = kg.reshape(B, Hkv, mp * ps, Dh).astype(jnp.float32)
    vg = vg.reshape(B, Hkv, mp * ps, Dh).astype(jnp.float32)
    qg = q.astype(jnp.float32).reshape(B, Hkv, H // Hkv, Dh) / Dh**0.5
    with jax.default_matmul_precision("highest"):
        s = jnp.einsum("bhrd,bhsd->bhrs", qg, kg)
        live = jnp.arange(mp * ps)[None, :] < lengths[:, None]
        s = jnp.where(live[:, None, None, :], s, -jnp.inf)
        p = jax.nn.softmax(s, axis=-1)
        o = jnp.einsum("bhrs,bhsd->bhrd", p, vg)
    return o.reshape(B, H, Dh)


def paged_attention_parity(widths, card, results):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tokenhawk_tpu.ops import dispatch
    from tokenhawk_tpu.ops.pallas import paged_attention
    from tokenhawk_tpu.runtime.paged import _contig, attend_paged_layer

    a = widths["attn"]
    B, H, Hkv, Dh, ps = a["B"], a["H"], a["Hkv"], a["Dh"], a["ps"]
    lengths = np.asarray(a["lengths"], np.int32)
    mp = int(-(-lengths.max() // ps))
    n_pages = B * mp + 4
    rng = np.random.default_rng(SEED)
    perm = rng.permutation(n_pages)
    table = np.full((B, mp), -1, np.int32)  # -1 = hole (never allocated)
    nxt = 0
    for b in range(B):
        for p in range(-(-lengths[b] // ps)):
            table[b, p] = perm[nxt]
            nxt += 1
    table[2, 0] = table[1, 0]  # a shared (prefix-cache) page
    contig = _contig()
    shape = (n_pages, Hkv, ps, Dh) if contig else (Hkv, n_pages, ps, Dh)
    key = jax.random.PRNGKey(SEED + 1)
    k1, k2, k3 = jax.random.split(key, 3)
    kp = jax.random.normal(k1, shape, jnp.float32).astype(jnp.bfloat16)
    vp = jax.random.normal(k2, shape, jnp.float32).astype(jnp.bfloat16)
    q = jax.random.normal(k3, (B, 1, H, Dh), jnp.float32).astype(
        jnp.bfloat16)
    tbl = jnp.asarray(table)
    lens = jnp.asarray(lengths)
    check(paged_attention.supported(H, Dh, ps, mp, Hkv),
          "paged attention rule rejects the 7B shape")
    check(lowered_has_triton(attend_paged_layer, q, kp, vp, tbl, lens),
          "paged attention did not lower to Triton")
    got = jax.jit(attend_paged_layer)(q, kp, vp, tbl, lens)[:, 0]
    # holes are never read by the kernel; the reference clamps them
    ref = attention_reference(q[:, 0], kp, vp, jnp.maximum(tbl, 0), lens,
                              contig)
    err, rel = rel_err(got, ref)
    ok = rel <= KERNEL_TOL
    line = (f"parity paged-attention B={B} H={H} Hkv={Hkv} Dh={Dh} ps={ps} "
            f"lengths={lengths.tolist()}: max abs err {err:.3e}, rel "
            f"{rel:.2e} (tol {KERNEL_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    def plain(q, kp, vp, tbl, lens):
        with dispatch.kernels_off("paged_attention"):
            return attend_paged_layer(q, kp, vp, tbl, lens)

    t_k = time_in_graph(attend_paged_layer, q, kp, vp, tbl, lens)
    t_x = time_in_graph(plain, q, kp, vp, tbl, lens)
    results.append(dict(op="paged_attention", B=B, kernel_us=t_k * 1e6,
                        xla_us=t_x * 1e6))
    line += (f"; kernel {t_k * 1e6:.1f} us vs plain XLA "
             f"{t_x * 1e6:.1f} us [{card}]")
    log(line)
    check(ok, f"paged attention rel err {rel:.2e}")


# ---------------------------------------------------------------------------
# Phase 3: serve
# ---------------------------------------------------------------------------


def smoke_vocab(n_vocab: int):
    tokens = ["<unk>", "<s>", "</s>"]
    types = [2, 3, 3]
    tokens += [f"<0x{b:02X}>" for b in range(256)]
    types += [6] * 256
    tokens += [f"▁t{i}" for i in range(n_vocab - len(tokens))]
    types += [1] * (n_vocab - len(types))
    return tokens, types


def write_smoke_gguf(path: Path, w: dict, seed: int) -> None:
    """Seeded LLaMA GGUF: q4_0 codes and f16 scales drawn directly."""
    import numpy as np

    from tokenhawk_tpu.ggml.format import GGMLType
    from tokenhawk_tpu.ggml.gguf import RawTensor, write_gguf

    rng = np.random.default_rng(seed)
    D, F, V, L = w["n_embd"], w["n_ff"], w["n_vocab"], w["n_layer"]

    def q4(rows, cols):
        nb = rows * cols // 32
        blk = np.empty((nb, 18), np.uint8)
        d = rng.uniform(2e-3, 6e-3, nb).astype("<f2")
        blk[:, :2] = d.view(np.uint8).reshape(nb, 2)
        blk[:, 2:] = rng.integers(0, 256, (nb, 16), dtype=np.uint8)
        return RawTensor(GGMLType.Q4_0, (rows, cols), blk.tobytes())

    def norm(n):
        return (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)

    tensors = {
        "token_embd.weight": (rng.standard_normal((V, D)) * 0.5).astype(
            np.float16),
        "output_norm.weight": norm(D),
        "output.weight": q4(V, D),
    }
    for i in range(L):
        p = f"blk.{i}."
        tensors[p + "attn_norm.weight"] = norm(D)
        tensors[p + "attn_q.weight"] = q4(D, D)
        tensors[p + "attn_k.weight"] = q4(D, D)
        tensors[p + "attn_v.weight"] = q4(D, D)
        tensors[p + "attn_output.weight"] = q4(D, D)
        tensors[p + "ffn_norm.weight"] = norm(D)
        tensors[p + "ffn_gate.weight"] = q4(F, D)
        tensors[p + "ffn_up.weight"] = q4(F, D)
        tensors[p + "ffn_down.weight"] = q4(D, F)
    toks, types = smoke_vocab(V)
    md = {
        "general.architecture": "llama",
        "general.name": "smoke-llama",
        "general.file_type": 2,
        "llama.context_length": 2048,
        "llama.embedding_length": D,
        "llama.block_count": L,
        "llama.attention.head_count": w["n_head"],
        "llama.attention.head_count_kv": w["n_head"],
        "llama.feed_forward_length": F,
        "llama.rope.dimension_count": D // w["n_head"],
        "llama.attention.layer_norm_rms_epsilon": 1e-6,
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": toks,
        "tokenizer.ggml.scores": [0.0] * V,
        "tokenizer.ggml.token_type": types,
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
    }
    tmp = path.with_suffix(".tmp")
    write_gguf(tmp, md, tensors)
    tmp.replace(path)


def smoke_model(w: dict, d: Path) -> Path:
    d.mkdir(exist_ok=True)
    name = (f"llama_q4_0_d{w['n_embd']}_l{w['n_layer']}_f{w['n_ff']}"
            f"_v{w['n_vocab']}_seed{SEED}.gguf")
    path = d / name
    if path.exists():
        log(f"model: reusing {path}")
        return path
    t0 = time.perf_counter()
    write_smoke_gguf(path, w, SEED)
    log(f"model: wrote {path} "
        f"({path.stat().st_size / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f}s")
    return path


def http_post(port, path, payload, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def read_sse(resp, on_first=None):
    """(events, ttft_seconds): events as (event, data) pairs."""
    t0 = time.perf_counter()
    ttft = None
    events, ev, data = [], "message", []
    for raw in resp:
        line = raw.decode("utf-8").rstrip("\n")
        if line.startswith("event:"):
            ev = line[6:].strip()
        elif line.startswith("data:"):
            data.append(line[5:].strip())
            if ttft is None:
                ttft = time.perf_counter() - t0
                if on_first is not None:
                    on_first()
        elif line == "" and data:
            events.append((ev, "\n".join(data)))
            ev, data = "message", []
    return events, ttft


def first_step_logits(cfg, params, prompts, backend):
    """Prefill logits and one decode step's logits through the paged
    serving forwards under `backend` ("xla" = the plain path)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tokenhawk_tpu.models.llama import (
        forward_paged_decode,
        forward_paged_prefill,
        logits_from_hidden,
    )
    from tokenhawk_tpu.ops import dispatch
    from tokenhawk_tpu.runtime.paged import make_unrolled_pool

    ps = 128
    B = len(prompts)
    Tb = -(-max(len(p) for p in prompts) // ps) * ps
    mp = Tb // ps + 1
    toks = np.zeros((B, Tb), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    lens = jnp.asarray([len(p) for p in prompts], jnp.int32)
    table = jnp.asarray(np.arange(B * mp, dtype=np.int32).reshape(B, mp))

    def step(params, pool, toks, lens, table):
        h, pool = forward_paged_prefill(cfg, params, toks, pool, table, lens)
        h_last = h[jnp.arange(B), lens - 1]
        l0 = logits_from_hidden(cfg, params, h_last)
        nxt = toks[:, :1]  # teacher-forced: the same token on both paths
        h1, pool = forward_paged_decode(cfg, params, nxt, pool, table, lens)
        return l0, logits_from_hidden(cfg, params, h1[:, 0])

    served = dispatch.get_backend()
    dispatch.set_backend(backend or served)
    try:
        pool = make_unrolled_pool(cfg, B * mp, ps)
        return jax.jit(step)(params, pool, jnp.asarray(toks), lens, table)
    finally:
        dispatch.set_backend(served)


def serve_round(port, r, n_tok):
    """Four concurrent requests: a prompt longer than a page, two that
    share a 256-token prefix (the second arrives while the first runs,
    so its prefix pages come from the prefix cache), greedy and sampled,
    over /generate and /v1/completions.  Returns (wall, stream TTFTs)."""
    shared = f"{r}" + "".join(chr(97 + i % 26) for i in range(300))
    jobs = [
        ("/generate", {"prompt": f"{r} " + "long prompt " * 30,
                       "max_tokens": n_tok, "temperature": 0.0}),
        ("/generate", {"prompt": shared + " first question",
                       "max_tokens": n_tok, "temperature": 0.8,
                       "seed": 7}),
        ("/v1/completions", {"prompt": shared + " second question",
                             "max_tokens": n_tok, "temperature": 0.0}),
        ("/v1/completions", {"prompt": f"{r} a short one",
                             "max_tokens": n_tok, "temperature": 0.0,
                             "stream": True}),
    ]
    results = [None] * len(jobs)
    errors = []
    started = threading.Event()

    def run(i, route, payload):
        try:
            t = time.perf_counter()
            resp = http_post(port, route, payload)
            if route == "/v1/completions" and not payload.get("stream"):
                body = json.loads(resp.read())
                results[i] = ("json", body, time.perf_counter() - t)
            else:
                events, ttft = read_sse(
                    resp, on_first=started.set if i == 1 else None)
                results[i] = ("sse", events, ttft)
        except Exception as e:  # reported below, fails the phase
            errors.append(f"{route}: {e!r}")
        finally:
            if i == 1:
                started.set()

    threads = []
    t0 = time.perf_counter()
    for i in (0, 1, 3):
        threads.append(threading.Thread(target=run, args=(i, *jobs[i])))
        threads[-1].start()
    started.wait(timeout=600)
    threads.append(threading.Thread(target=run, args=(2, *jobs[2])))
    threads[-1].start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not errors, f"request errors: {errors}")
    ttfts = []
    for i, (route, payload) in enumerate(jobs):
        check(results[i] is not None, f"{route}: no response")
        kind, body, extra = results[i]
        if kind == "json":
            got = body["usage"]["completion_tokens"]
            reason = body["choices"][0]["finish_reason"]
            check(got == n_tok and reason == "length",
                  f"{route} returned {got} tokens ({reason})")
        else:
            ev, data = body[-1]
            if route == "/generate":
                check(ev == "done", f"{route} stream did not end in done")
                reason = json.loads(data)["finish_reason"]
            else:
                check(data == "[DONE]", f"{route} stream unfinished")
                reason = json.loads(body[-2][1])["choices"][0][
                    "finish_reason"]
            # "length": the stream stopped at max_tokens, not before
            check(reason == "length",
                  f"{route} finished with {reason!r}, not {n_tok} tokens")
            ttfts.append(extra)
        mode = "sampled" if payload.get("temperature") else "greedy"
        log(f"serve round {r}: {route} ({mode}"
            f"{', stream' if kind == 'sse' else ''}) -> {n_tok} tokens, "
            f"finish {reason}")
    return wall, ttfts


def serve_phase(w, card, info, model_dir: Path = ROOT / ".smoke_models"):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tokenhawk_tpu.config import SamplingConfig
    from tokenhawk_tpu.runtime.loader import load_model
    from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler
    from tokenhawk_tpu.serving.server import serve

    path = smoke_model(w, model_dir)
    t0 = time.perf_counter()
    cfg, params, tokenizer = load_model(str(path), n_ctx=w["n_ctx"])
    log(f"serve: loaded {cfg.n_layer} layers, n_embd {cfg.n_embd} in "
        f"{time.perf_counter() - t0:.1f}s")

    # Served first-step logits vs the plain path (no hand-written kernel).
    rng = np.random.default_rng(SEED)
    prompts = [[1] + rng.integers(3, cfg.n_vocab, n).tolist()
               for n in (w["logit_prompts"])]
    l0k, l1k = first_step_logits(cfg, params, prompts, None)
    l0x, l1x = first_step_logits(cfg, params, prompts, "xla")
    for name, a, b in (("prefill", l0k, l0x), ("decode", l1k, l1x)):
        err, rel = rel_err(a, b)
        top = float(np.mean(np.argmax(np.asarray(a), -1)
                            == np.argmax(np.asarray(b), -1)))
        log(f"logits {name}: served vs plain max abs err {err:.3e}, rel "
            f"{rel:.2e} (tol {LOGITS_TOL:.0e}), top-1 agreement {top:.2f}")
        check(bool(np.all(np.isfinite(np.asarray(a)))), "non-finite logits")
        check(rel <= LOGITS_TOL, f"{name} logits rel err {rel:.2e}")
    del l0k, l1k, l0x, l1x

    eog = getattr(tokenizer, "eog_ids", None)
    eos_id = tuple(sorted(int(e) for e in eog if e >= 0)) if eog else 2
    sched = PagedScheduler(
        cfg, params, sampling=SamplingConfig(), max_batch=8,
        max_seq=w["n_ctx"], decode_chunk=8, page_size=128,
        cache_dtype=jnp.bfloat16, prefill_chunk=None, prefix_cache=True,
        eos_id=eos_id)
    port = free_port()
    httpd = serve(sched, tokenizer, port=port,
                  model_info={"model": path.name, "n_ctx": w["n_ctx"],
                              "paged": True})
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        n_tok = w["max_tokens"]
        # Round 0 compiles every shape the requests need; round 1 runs
        # the same mix (fresh prompts) on the compiled programs.
        rounds = [serve_round(port, r, n_tok) for r in range(2)]
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=60).read())
        check(health["prefix_cache_hits"] > 0, "no prefix-cache hit")
        log(f"serve: prefix-cache hits {health['prefix_cache_hits']}, "
            f"completed {health['completed']}")
        (wall0, _), (wall1, ttfts) = rounds
        n_all = 4 * n_tok
        info["serve"] = dict(
            first_round_s=wall0, wall_s=wall1, tok_s=n_all / wall1,
            ttft_p50_ms=sorted(ttfts)[len(ttfts) // 2] * 1e3)
        log(f"info serve [{card}]: first round (compiles) {wall0:.1f}s; "
            f"compiled round: 4 concurrent requests, {n_all} tokens in "
            f"{wall1:.2f}s -> {n_all / wall1:.1f} tok/s; TTFT p50 "
            f"{info['serve']['ttft_p50_ms']:.0f} ms (streams)")
    finally:
        httpd.shutdown()
        httpd.serving_loop.stop()
    del sched, params
    return path


def cli_phase(path, w, card, info):
    from tokenhawk_tpu import cli

    out, err = io.StringIO(), io.StringIO()
    argv = ["-m", str(path), "Once upon a time", "--greedy", "--timing",
            "--max-tokens", str(w["max_tokens"]), "--n-ctx", "512"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli exited {rc}: {err.getvalue()[-2000:]}")
    summary = [l for l in err.getvalue().splitlines() if "generated" in l]
    check(bool(summary), "cli printed no generation summary")
    n_gen = int(summary[-1].split(",")[1].split()[0])
    check(n_gen >= 1 and out.getvalue().strip() != "",
          "cli emitted no tokens")
    log(f"cli: {summary[-1].strip()}")
    log(f"info cli [{card}]: {wall:.1f}s wall incl. load and compile")


# ---------------------------------------------------------------------------
# --four-cards: TP=4 paged serving vs the same weights on one card
# ---------------------------------------------------------------------------


def synth_params_q4(cfg, key):
    """Seeded q4_0 LlamaParams (stacked layers, k_shards=1 packing)."""
    import jax
    import jax.numpy as jnp

    from tokenhawk_tpu.models.llama import LayerParams, LlamaParams
    from tokenhawk_tpu.ops.qweight import QWeight

    D, F, V, L = cfg.n_embd, cfg.n_ff, cfg.n_vocab, cfg.n_layer
    Dkv = cfg.n_embd_kv
    keys = iter(jax.random.split(key, 16))

    def q4(K, N, lead=(L,)):
        k1, k2, k3 = jax.random.split(next(keys), 3)

        def sc(k):
            return jax.random.uniform(k, (*lead, K // 64, N), jnp.float32,
                                      2e-3, 6e-3).astype(jnp.bfloat16)

        return QWeight(qs=jax.random.bits(k1, (*lead, K // 2, N), jnp.uint8),
                       scales=sc(k2), mins=None, scales_hi=sc(k3),
                       kind="q4_0")

    ones = jnp.ones((L, D), jnp.bfloat16)
    layers = LayerParams(wq=q4(D, D), wk=q4(D, Dkv), wv=q4(D, Dkv),
                         wo=q4(D, D), w1=q4(D, F), w2=q4(F, D), w3=q4(D, F),
                         attn_norm=ones, ffn_norm=ones)
    emb = (jax.random.normal(next(keys), (V, D), jnp.float32) * 0.5).astype(
        jnp.bfloat16)
    return LlamaParams(tok_embd=emb, layers=layers,
                       norm=jnp.ones((D,), jnp.bfloat16),
                       output=q4(D, V, lead=()))


def repack_q4_shards(w, k_shards: int):
    """Device-side re-pack of a k_shards=1 q4_0 QWeight for contraction
    sharding: the same logical weight in the ops/qweight.pack_q4_rows /
    split_q4_scales layout with `k_shards` blocks (leading dims kept)."""
    import jax.numpy as jnp

    from tokenhawk_tpu.ops.qweight import QWeight

    if w.kind != "q4_0":
        raise ValueError(f"expected q4_0, got {w.kind}")
    if k_shards == 1:
        return w
    codes = (w.unpacked_qs().astype(jnp.int16) + 8).astype(jnp.uint8)
    scales = w.full_scales()
    *lead, K, N = codes.shape
    G = scales.shape[-2]
    u = codes.reshape(*lead, k_shards, K // k_shards, N)
    half = K // k_shards // 2
    qs = (u[..., :half, :] | (u[..., half:, :] << 4)).reshape(*lead, K // 2, N)
    s = scales.reshape(*lead, k_shards, G // k_shards, N)
    gh = G // k_shards // 2
    return QWeight(
        qs=qs, scales=s[..., :gh, :].reshape(*lead, G // 2, N),
        mins=None, scales_hi=s[..., gh:, :].reshape(*lead, G // 2, N),
        kind="q4_0", group=w.group)


def four_card_phase(w, cfg, card, devs):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tokenhawk_tpu.config import SamplingConfig
    from tokenhawk_tpu.models.llama import fuse_params, unstack_params
    from tokenhawk_tpu.parallel import make_mesh
    from tokenhawk_tpu.parallel.tp import fuse_params_tp, shard_params_tp
    from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler

    check(len(devs) == 4, f"--four-cards needs 4 devices, found {len(devs)}")
    tp = 4
    log(f"four-cards: n_embd {cfg.n_embd}, heads {cfg.n_head}/"
        f"{cfg.n_kv_head}, n_ff {cfg.n_ff}, {cfg.n_layer} layers, q4_0, "
        f"TP={tp} vs one card")
    with jax.default_device(devs[0]):
        logical = jax.block_until_ready(
            synth_params_q4(cfg, jax.random.PRNGKey(SEED)))
    single = unstack_params(fuse_params(logical))
    lay = logical.layers
    tp_packed = dataclasses.replace(logical, layers=dataclasses.replace(
        lay, wo=repack_q4_shards(lay.wo, tp), w2=repack_q4_shards(lay.w2, tp)))
    mesh = make_mesh(dp=1, tp=tp, devices=devs)
    sharded = shard_params_tp(cfg, unstack_params(
        fuse_params_tp(cfg, tp_packed, tp)), mesh)
    del tp_packed, lay

    rng = np.random.default_rng(SEED)
    prompts = [[1] + rng.integers(3, cfg.n_vocab, n).tolist()
               for n in w["logit_prompts"]]
    greedy = SamplingConfig(temperature=0.0)
    outs, logits = {}, {}
    for name, params, mesh_ in (("one card", single, None),
                                ("TP=4", sharded, mesh)):
        t0 = time.perf_counter()
        sched = PagedScheduler(cfg, params, sampling=greedy, max_batch=4,
                               max_seq=w["n_ctx"], decode_chunk=8,
                               page_size=128, mesh=mesh_)
        ps = sched.ps
        toks = np.zeros((1, -(-len(prompts[0]) // ps) * ps), np.int32)
        toks[0, : len(prompts[0])] = prompts[0]
        table = np.arange(sched.table.shape[1], dtype=np.int32)[None] + 1
        _, lg = sched._prefill(sched.params, sched.cache, jnp.asarray(toks),
                               jnp.asarray([len(prompts[0])], jnp.int32),
                               jnp.asarray(table))
        logits[name] = np.asarray(lg, np.float32)
        del sched
        sched = PagedScheduler(cfg, params, sampling=greedy, max_batch=4,
                               max_seq=w["n_ctx"], decode_chunk=8,
                               page_size=128, mesh=mesh_)
        reqs = sched.generate_many(prompts, max_new_tokens=w["max_tokens"])
        outs[name] = [r.output for r in reqs]
        log(f"four-cards: {name} served {sum(map(len, outs[name]))} tokens "
            f"in {time.perf_counter() - t0:.1f}s incl. compile [{card}]")
        del sched
    err, rel = rel_err(logits["TP=4"], logits["one card"])
    log(f"four-cards: prefill logits TP=4 vs one card max abs err "
        f"{err:.3e}, rel {rel:.2e} (tol {LOGITS_TOL:.0e})")
    check(rel <= LOGITS_TOL, f"TP logits rel err {rel:.2e}")
    match = [sum(1 for _ in itertools.takewhile(
        lambda ab: ab[0] == ab[1], zip(a, b)))
        for a, b in zip(outs["TP=4"], outs["one card"])]
    log(f"four-cards: greedy tokens matching before first divergence "
        f"{match} of {[len(o) for o in outs['one card']]}")
    # The two programs sum in different orders (a psum of four partial
    # products vs one dot), so a greedy stream may later flip between
    # near-tied logits of the random model; the first token follows the
    # compared logits and must agree.
    check(all(m >= 1 for m in match), "TP=4 first greedy token differs")


# ---------------------------------------------------------------------------


WIDTHS_7B = dict(
    gemv=[(4096, 12288), (4096, 22016), (4096, 4096), (4096, 32000),
          (11008, 4096)],
    rows=[1, 8, 512],
    attn=dict(B=8, H=32, Hkv=32, Dh=128, ps=128,
              lengths=[1, 127, 128, 129, 500, 777, 1000, 1024]),
    n_embd=4096, n_head=32, n_layer=32, n_ff=11008, n_vocab=32000,
    n_ctx=2048, max_tokens=32, logit_prompts=(200, 77),
)

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the TP=4 paged serving comparison")
    args = p.parse_args(argv)
    if not (ROOT / "tokenhawk_tpu").is_dir():
        print("chip_smoke.py: run it from a tokenhawk-tpu checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tokenhawk_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    import jax

    from tokenhawk_tpu.config import LlamaConfig

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    from tokenhawk_tpu.utils.profiling import card_description

    card = card_description()
    log(f"card: {card}")
    log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind} "
        f"({dev.platform}); compile cache {cache_dir}")
    w = dict(WIDTHS_7B)
    t_start = time.perf_counter()
    if args.four_cards:
        # depth cut from 80 to 8 layers to fit the time limit
        cfg = dataclasses.replace(LlamaConfig.llama2_70b(n_vocab=32000),
                                  n_layer=8, n_ctx=w["n_ctx"])
        four_card_phase(w, cfg, card, jax.devices())
    else:
        results, info = [], {}
        gemv_parity(w, card, results)
        paged_attention_parity(w, card, results)
        path = serve_phase(w, card, info)
        cli_phase(path, w, card, info)
        log("timings " + json.dumps(dict(card=card, kernels=results,
                                         **info)))
    log(f"total {time.perf_counter() - t_start:.1f}s [{card}]")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
