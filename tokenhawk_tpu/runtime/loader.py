"""Model loading: GGML file -> (config, device params, tokenizer).

End-to-end parity with the reference's `load_llama_file` +
`post_load_init_model` flow (/root/reference/th-llama-loader.cpp:485-635,
330-435), redesigned: tensors are mmap'd and uploaded straight into the
device layout (transposed, optionally sharded; see
`tokenhawk_tpu.parallel`), with no intermediate scratch copies.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from tokenhawk_tpu.config import LlamaConfig
from tokenhawk_tpu.ggml.reader import GGMLFile
from tokenhawk_tpu.models.llama import LlamaParams, params_from_ggml
from tokenhawk_tpu.tokenizer import Tokenizer


def config_from_hparams(hp, n_ctx: int = 2048, **overrides) -> LlamaConfig:
    kw = dict(
        n_vocab=hp.n_vocab,
        n_embd=hp.n_embd,
        n_head=hp.n_head,
        n_layer=hp.n_layer,
        n_mult=hp.n_mult,
        n_ctx=n_ctx,
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def _fast_device_tensor(f: GGMLFile, name: str, scale_dtype=jnp.float32):
    """One-pass native decode of q8_0/q4_0 records straight into the
    device layout (transposed, q4 nibble-packed); None if not applicable.

    ggjt v1 block layout only (f32 scales, even/odd nibble interleave);
    GGUF blocks (f16 scales, half-packed nibbles) take the generic path.
    """
    from tokenhawk_tpu.ggml.format import GGMLType
    from tokenhawk_tpu.ggml import native

    from tokenhawk_tpu.ggml.gguf import GGUFFile

    if isinstance(f, GGUFFile):
        return None
    rec = f.tensors[name]
    if len(rec.shape) != 2 or rec.ggml_type not in (GGMLType.Q8_0, GGMLType.Q4_0):
        return None
    rows, cols = rec.shape
    raw = f.raw(name)
    from tokenhawk_tpu.ops.qweight import QWeight, split_q4_scales

    if rec.ggml_type == GGMLType.Q8_0:
        qs, scales = native.q8_decode_transpose(raw, rows, cols)
        return QWeight(qs=jnp.asarray(qs),
                       scales=jnp.asarray(scales, dtype=scale_dtype),
                       mins=None, kind="q8_0")
    qs, scales = native.q4_decode_transpose_pack(raw, rows, cols)
    lo, hi = split_q4_scales(scales)
    return QWeight(qs=jnp.asarray(qs),
                   scales=jnp.asarray(lo, dtype=scale_dtype), mins=None,
                   scales_hi=jnp.asarray(hi, dtype=scale_dtype), kind="q4_0")


def load_model(
    path: str,
    n_ctx: int = 2048,
    dtype=jnp.bfloat16,
    mesh=None,
    parallel: str = "tp",  # with a mesh: "tp" (shard_map) or "gspmd"
    scale_dtype=jnp.bfloat16,  # quant scale dtype (bf16 halves scale traffic)
    retries: int = 2,
    **config_overrides,
) -> Tuple[LlamaConfig, LlamaParams, Tokenizer]:
    """Load a GGML model onto the device.

    `retries`: transient host->device failures (an interrupted
    transfer) retry with backoff from a fresh mmap; the
    reference just latches a loadFailed flag and gives up
    (/root/reference/th-llama-loader.cpp:473-476).
    """
    import time as _time

    last_exc = None
    for attempt in range(retries + 1):
        try:
            return _load_model_once(path, n_ctx, dtype, mesh, parallel,
                                    scale_dtype, **config_overrides)
        except (OSError, ValueError):
            raise  # corrupt/missing file: retrying cannot help
        except Exception as e:  # runtime/transfer errors: retry
            last_exc = e
            if attempt < retries:
                import sys

                print(f"load_model: attempt {attempt + 1} failed "
                      f"({type(e).__name__}: {e}); retrying",
                      file=sys.stderr)
                _time.sleep(1.0 * (attempt + 1))
    raise last_exc


def _load_model_once(
    path: str,
    n_ctx: int = 2048,
    dtype=jnp.bfloat16,
    mesh=None,
    parallel: str = "tp",
    scale_dtype=jnp.bfloat16,
    **config_overrides,
) -> Tuple[LlamaConfig, LlamaParams, Tokenizer]:
    import os as _os

    if _os.path.isdir(path):
        # TH chunk directory (reference CLI `-d`,
        # /root/reference/cli/main.cpp:44-49).
        from tokenhawk_tpu.ggml.chunked import ChunkedReader

        f = ChunkedReader(path)
    else:
        from tokenhawk_tpu.ggml.gguf import GGUFFile, is_gguf

        # Magic sniff: ggjt v1 (the reference's only format) or GGUF
        # (what llama.cpp has shipped since mid-2023) — same loader.
        f = GGUFFile(path) if is_gguf(path) else GGMLFile(path)
        for k, v in getattr(f, "config_overrides", {}).items():
            config_overrides.setdefault(k, v)
    # n_ff is not in the header; read it off the actual w1 tensor rather
    # than trusting the LLaMA-1 n_mult derivation (robust to any model).
    w1 = f.tensors.get("layers.0.feed_forward.w1.weight")
    if w1 is not None:
        config_overrides.setdefault("n_ff", w1.shape[0])
    # GQA is invisible in the ggjt header too: infer n_kv_head from the
    # wk projection's row count (n_kv_head * head_dim rows).
    wk = f.tensors.get("layers.0.attention.wk.weight")
    if wk is not None and f.hparams.n_embd and f.hparams.n_head:
        head_dim = f.hparams.n_embd // f.hparams.n_head
        config_overrides.setdefault("n_kv_head", wk.shape[0] // head_dim)
    cfg = config_from_hparams(f.hparams, n_ctx=n_ctx, **config_overrides)
    # GGUF files know their tokenizer model (SPM vs gpt2 byte-level BPE)
    # and bos/eos ids; ggjt/chunked files are SPM by construction.
    tokenizer = (f.build_tokenizer() if hasattr(f, "build_tokenizer")
                 else Tokenizer.from_vocab(f.vocab))

    tp = 1
    if mesh is not None and parallel == "tp":
        from tokenhawk_tpu.parallel.mesh import MODEL_AXIS

        tp = mesh.shape[MODEL_AXIS]

    _ROW_PARALLEL = ("attention.wo.weight", "feed_forward.w2.weight")
    from tokenhawk_tpu.ggml.format import GGMLType as _GT

    _KQ = (_GT.Q2_K, _GT.Q3_K, _GT.Q4_K, _GT.Q5_K, _GT.Q6_K)
    tensors = {}
    for name in f.tensors:
        if name != "tok_embeddings.weight":
            # q4 row-parallel weights need per-shard packing: the native
            # one-pass decoder packs globally, so route them through the
            # generic path when tp > 1.
            skip_fast = tp > 1 and name.endswith(_ROW_PARALLEL)
            fast = None if skip_fast else _fast_device_tensor(f, name, scale_dtype)
            if fast is not None:
                tensors[name] = fast
                continue
        rec = f.tensors[name]
        if (rec.ggml_type in _KQ and len(rec.shape) == 2
                and "norm" not in name and name != "tok_embeddings.weight"):
            if tp == 1 and _os.environ.get("THAWK_KQUANT_NATIVE", "1") == "1":
                # NATIVE k-quant device path: the super-block structure
                # reduces to per-group affine int codes the GEMV kernel
                # serves directly — ~5 bpw on device for Q4_K vs the
                # requantize detour's ~8.5.  Bit-exact at
                # scale_dtype=f32; the default bf16 rounds the affine
                # sides (see ops/qweight.from_kquant_raw).
                from tokenhawk_tpu.ops.qweight import from_kquant_raw

                tensors[name] = from_kquant_raw(
                    rec.ggml_type, bytes(f.raw(name)), rec.shape,
                    scale_dtype=scale_dtype)
                continue
            # TP fallback: requantize to Q8_0, which shards by rows
            # (q8 rounding is negligible vs the k-quant's).
            from tokenhawk_tpu.ggml.quants import quantize

            tensors[name] = quantize(
                np.asarray(f.load_tensor(name), np.float32), _GT.Q8_0)
            continue
        tensors[name] = f.load_tensor(name)

    params = params_from_ggml(cfg, tensors, dtype=dtype, row_parallel_shards=tp,
                              scale_dtype=scale_dtype)
    if _os.environ.get("THAWK_ROPE_HALF", "1") == "1":
        from tokenhawk_tpu.models.llama import rope_half_params

        # Load-time wq/wk column permutation: the reference's interleaved
        # RoPE becomes the layout-friendly "half" rotation (no per-step
        # even/odd lane shuffles); outputs are numerically identical.
        cfg, params = rope_half_params(cfg, params)
    if mesh is None:
        from tokenhawk_tpu.models.llama import fuse_params, unstack_params

        # Single chip: fused wqkv/w13 + unrolled per-layer buffers (no
        # scan -> the KV cache isn't rewritten as scan ys every step).
        params = unstack_params(fuse_params(params))
    if mesh is not None:
        if parallel == "tp":
            from tokenhawk_tpu.models.llama import unstack_params
            from tokenhawk_tpu.parallel.tp import (
                fuse_params_tp,
                shard_params_tp,
            )

            # Same decode-fast form as single chip: interleaved per-shard
            # fusion + unrolled layers (in-place KV updates, no scan-ys
            # whole-cache rewrite).
            params = fuse_params_tp(cfg, params, tp)
            params = unstack_params(params)
            params = shard_params_tp(cfg, params, mesh)
        else:
            from tokenhawk_tpu.parallel import shard_params

            params = shard_params(cfg, params, mesh)
    f.close()
    return cfg, params, tokenizer
