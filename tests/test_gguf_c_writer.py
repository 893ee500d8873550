"""GGUF container-level cross-check.

`thawk_write_tiny_gguf` (native/thawk_native.cpp) writes a complete tiny
GGUF v3 llama file from the container spec, independently of the Python
writer: header, every kv type the format needs (u32/f32/str/arrays of
str/f32/u32), ne0-fastest dims, non-default alignment (64), tied
embeddings, and GGUF f16-scale quant blocks with the
first-half/second-half nibble split.  The Python stack must parse it,
reproduce the LCG weights within quantization error, and serve it
end-to-end — two spec implementations agreeing is the strongest
container validation available in this zero-egress environment (no
llama.cpp binary, no real weight file).
"""

import numpy as np
import pytest

from tokenhawk_tpu.ggml import native

N_VOCAB, N_EMBD, N_HEAD, N_LAYER, N_FF, SEED = 300, 64, 2, 2, 128, 9

# Fixed write order (see thawk_write_tiny_gguf): per-tensor LCG seed is
# SEED * 1000003 + index.
ORDER = ["token_embd.weight", "output_norm.weight"]
for _l in range(N_LAYER):
    ORDER += [f"blk.{_l}.{t}.weight" for t in (
        "attn_norm", "attn_q", "attn_k", "attn_v", "attn_output",
        "ffn_norm", "ffn_gate", "ffn_down", "ffn_up")]


def _lcg_floats(seed: int, n: int) -> np.ndarray:
    """Replicates the C writer's LCG stream (Numerical Recipes consts)."""
    s = np.uint64(seed)
    a = np.uint64(6364136223846793005)
    c = np.uint64(1442695040888963407)
    out = np.empty(n, np.float32)
    mask24 = np.uint64(0xFFFFFF)
    with np.errstate(over="ignore"):
        for i in range(n):
            s = s * a + c
            out[i] = float((s >> np.uint64(33)) & mask24) / 16777216.0 - 0.5
    return out


@pytest.fixture(scope="module")
def cfile(tmp_path_factory):
    if not native.available():
        pytest.skip("native library unavailable")
    path = tmp_path_factory.mktemp("cw") / "cwriter.gguf"
    assert native.write_tiny_gguf(path, N_VOCAB, N_EMBD, N_HEAD, N_LAYER,
                                  N_FF, seed=SEED)
    return path


def test_c_gguf_parses_with_expected_structure(cfile):
    from tokenhawk_tpu.ggml.format import GGMLType
    from tokenhawk_tpu.ggml.gguf import GGUFFile

    with GGUFFile(cfile) as f:
        assert f.metadata["general.alignment"] == 64
        assert f.hparams.n_vocab == N_VOCAB
        assert f.hparams.n_layer == N_LAYER
        assert f.config_overrides["n_ff"] == N_FF
        assert len(f.vocab) == N_VOCAB
        # SPM byte-fallback pieces decoded from <0xHH> spelling
        assert f.vocab.tokens[3] == b"\x00"
        assert f.vocab.tokens[3 + 0x41] == b"A"
        # Tied embeddings: output.weight aliases token_embd
        emb = f.tensors["tok_embeddings.weight"]
        out = f.tensors["output.weight"]
        assert out.data_offset == emb.data_offset
        # Every tensor payload honors the 64-byte alignment
        for r in f.tensors.values():
            assert r.data_offset % 64 == 0
        assert f.tensors["layers.0.attention.wq.weight"].ggml_type == GGMLType.Q4_0
        assert f.tensors["layers.0.feed_forward.w1.weight"].ggml_type == GGMLType.Q8_0


def test_c_gguf_values_match_lcg(cfile):
    """Dequantized tensors reproduce the LCG stream within the quant
    step (q4_0: half-step d/2 for most values but up to a FULL step d ~
    0.065 at the +max clamp — q4_0's signed-absmax scheme maps the
    signed max to -8 so the opposite extreme clamps at +7; q8_0 ~0.003;
    f16 exact to half precision; f32 exact).  A LAYOUT error would
    mismatch ~everything by O(values), not a tail by <= d."""
    from tokenhawk_tpu.ggml.gguf import GGUFFile

    with GGUFFile(cfile) as f:
        for idx, gname in enumerate(ORDER):
            from tokenhawk_tpu.ggml.gguf import translate_name

            name = translate_name(gname)
            rec = f.tensors[name]
            n = int(np.prod(rec.shape))
            want = _lcg_floats(SEED * 1000003 + idx, n).reshape(rec.shape)
            got = f.load_tensor(name, dequant=True)
            if hasattr(got, "dequantize"):
                got = got.dequantize()
            got = np.asarray(got, np.float32)
            kind = rec.ggml_type.name
            atol = {"F32": 1e-7, "F16": 3e-4, "Q8_0": 4e-3, "Q4_0": 7e-2}[kind]
            np.testing.assert_allclose(got, want, atol=atol,
                                       err_msg=f"{name} ({kind})")


def test_c_gguf_serves_end_to_end(cfile):
    from tokenhawk_tpu.config import SamplingConfig
    from tokenhawk_tpu.runtime.engine import Engine
    from tokenhawk_tpu.runtime.loader import load_model

    cfg, params, tok = load_model(cfile, n_ctx=64)
    assert tok.bos_id == 1 and tok.eos_id == 2
    eng = Engine(cfg, params, tokenizer=tok,
                 sampling=SamplingConfig(temperature=0.0), max_seq=64)
    res = eng.generate([1, 5, 9, 13], max_new_tokens=4)
    assert 1 <= len(res.tokens) <= 4
