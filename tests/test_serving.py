import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from tokenhawk_tpu.config import LlamaConfig, SamplingConfig
from tokenhawk_tpu.models.llama import params_from_ggml
from tokenhawk_tpu.runtime.scheduler import Scheduler
from tokenhawk_tpu.serving.server import serve
from tokenhawk_tpu.tokenizer import byte_fallback_vocab

from helpers import make_ggml_weights

CFG = LlamaConfig.tiny(n_vocab=512, n_ctx=64)


@pytest.fixture(scope="module")
def server():
    rng = np.random.default_rng(11)
    params = params_from_ggml(CFG, make_ggml_weights(CFG, rng), dtype=jnp.float32)
    sched = Scheduler(
        CFG, params, sampling=SamplingConfig(temperature=0.0),
        max_batch=2, cache_dtype=jnp.float32, decode_chunk=4,
    )
    httpd = serve(sched, byte_fallback_vocab(), host="127.0.0.1", port=0,
                  model_info={"model": "tiny-test"})
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()
    httpd.serving_loop.stop()


def test_health(server):
    with urllib.request.urlopen(server + "/health", timeout=30) as r:
        data = json.loads(r.read())
    assert data["status"] == "ok"
    assert data["model"] == "tiny-test"


def test_index_served(server):
    with urllib.request.urlopen(server + "/", timeout=30) as r:
        body = r.read().decode()
    assert "tokenhawk" in body
    with urllib.request.urlopen(server + "/chat.js", timeout=30) as r:
        assert "generate" in r.read().decode()


def test_generate_streams_tokens(server):
    req = urllib.request.Request(
        server + "/generate",
        data=json.dumps({"prompt": "hi", "max_tokens": 6}).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        body = r.read().decode()
    frames = [f for f in body.split("\n\n") if f.strip()]
    assert any(f.startswith("event: done") for f in frames)
    data_frames = [f for f in frames if f.startswith("data: ")]
    # Each data frame carries a decoded token string.
    for f in data_frames:
        payload = json.loads(f[6:])
        assert "token" in payload


def test_bad_request(server):
    req = urllib.request.Request(
        server + "/generate", data=b"{}",
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        urllib.request.urlopen(req, timeout=30)
        assert False, "expected 400"
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_stop_sequence_over_http(server):
    req = urllib.request.Request(
        server + "/generate",
        data=json.dumps({"prompt": "Hi", "max_tokens": 12,
                         "stop": ["\x00"]}).encode(),
        headers={"Content-Type": "application/json"},
    )
    body = urllib.request.urlopen(req, timeout=120).read().decode()
    assert "event: done" in body
    # finish is either the stop match or a natural end; never an error
    assert "finish_reason" in body


def test_bad_stop_rejected(server):
    req = urllib.request.Request(
        server + "/generate",
        data=json.dumps({"prompt": "Hi", "stop": [1, 2]}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        urllib.request.urlopen(req, timeout=60)
        assert False, "expected 400"
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_cancel_on_client_disconnect():
    """A dropped SSE consumer frees its slot instead of generating to
    max_tokens."""
    import http.client
    import socket
    import struct
    import time

    rng = np.random.default_rng(12)
    params = params_from_ggml(CFG, make_ggml_weights(CFG, rng),
                              dtype=jnp.float32)
    # temperature > 0 so EOS is unlikely to cut generation short
    sched = Scheduler(CFG, params,
                      sampling=SamplingConfig(temperature=0.9, seed=5),
                      max_batch=1, max_seq=64, cache_dtype=jnp.float32,
                      decode_chunk=2)
    httpd = serve(sched, byte_fallback_vocab(), host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("POST", "/generate",
                  json.dumps({"prompt": "Hi", "max_tokens": 40}),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        r.read(10)  # stream established
        sock = r.fp.raw._sock
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        r.fp.close()
        sock.close()  # RST: the server's next write fails
        deadline = time.time() + 60
        while time.time() < deadline:
            if any(q.finish_reason == "cancelled" for q in sched.finished):
                break
            time.sleep(0.25)
        cancelled = [q for q in sched.finished
                     if q.finish_reason == "cancelled"]
        assert cancelled, [q.finish_reason for q in sched.finished]
        assert len(cancelled[0].output) < 40
    finally:
        httpd.shutdown()
        httpd.serving_loop.stop()


def test_paged_session_replay_with_prefix_cache():
    """Multi-turn on the paged scheduler: the serving loop replays the
    conversation text, and the prefix cache turns the replay into page
    reuse (second turn's TTFT prefills mostly new tokens)."""
    from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler

    rng = np.random.default_rng(14)
    params = params_from_ggml(CFG, make_ggml_weights(CFG, rng),
                              dtype=jnp.float32)
    sched = PagedScheduler(CFG, params,
                           sampling=SamplingConfig(temperature=0.0),
                           max_batch=2, max_seq=64, cache_dtype=jnp.float32,
                           decode_chunk=4, page_size=8, n_pages=24,
                           prefix_cache=True)
    httpd = serve(sched, byte_fallback_vocab(), host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        def post(payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            return urllib.request.urlopen(req, timeout=240).read().decode()

        b1 = post({"prompt": "hello there friend", "max_tokens": 3,
                   "session": "s1"})
        assert "event: done" in b1
        hits0 = sched.prefix_hits
        b2 = post({"prompt": " and more", "max_tokens": 3, "session": "s1"})
        assert "event: done" in b2
        # the replayed first turn reused cached pages
        assert sched.prefix_hits > hits0
        # reset clears the history
        b3 = post({"prompt": "[cmd] reset", "session": "s1"})
        assert "reset" in b3
        assert "s1" not in httpd.serving_loop._session_hist
    finally:
        httpd.shutdown()
        httpd.serving_loop.stop()


def test_openai_completions_json(server):
    req = urllib.request.Request(
        server + "/v1/completions",
        data=json.dumps({"prompt": "Hi", "max_tokens": 4}).encode(),
        headers={"Content-Type": "application/json"},
    )
    body = json.loads(urllib.request.urlopen(req, timeout=120).read())
    assert body["object"] == "text_completion"
    assert body["choices"][0]["finish_reason"] in ("stop", "length")
    assert isinstance(body["choices"][0]["text"], str)
    assert body["usage"]["completion_tokens"] >= 0


def test_openai_completions_stream(server):
    req = urllib.request.Request(
        server + "/v1/completions",
        data=json.dumps({"prompt": "Hi", "max_tokens": 4,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"},
    )
    body = urllib.request.urlopen(req, timeout=120).read().decode()
    assert body.rstrip().endswith("data: [DONE]")
    lines = [l for l in body.splitlines() if l.startswith("data: ")
             and l != "data: [DONE]"]
    chunks = [json.loads(l[6:]) for l in lines]
    assert all(c["object"] == "text_completion" for c in chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_openai_completions_bad_request(server):
    req = urllib.request.Request(
        server + "/v1/completions",
        data=json.dumps({"max_tokens": 4}).encode(),  # no prompt
        headers={"Content-Type": "application/json"},
    )
    try:
        urllib.request.urlopen(req, timeout=60)
        assert False, "expected 400"
    except urllib.error.HTTPError as e:
        assert e.code == 400
        assert json.loads(e.read())["error"]["type"] == "invalid_request_error"


def test_openai_models_endpoint(server):
    body = json.loads(urllib.request.urlopen(
        server + "/v1/models", timeout=60).read())
    assert body["object"] == "list"
    assert body["data"][0]["id"] == "tiny-test"


def test_openai_token_array_prompt(server):
    req = urllib.request.Request(
        server + "/v1/completions",
        data=json.dumps({"prompt": [1, 72, 105], "max_tokens": 3}).encode(),
        headers={"Content-Type": "application/json"},
    )
    body = json.loads(urllib.request.urlopen(req, timeout=120).read())
    assert body["usage"]["prompt_tokens"] == 3
    assert body["usage"]["total_tokens"] == 3 + body["usage"]["completion_tokens"]


def test_openai_error_mapping(server):
    # prompt longer than n_ctx -> scheduler error -> HTTP 400, not a
    # fake empty 'stop' completion
    req = urllib.request.Request(
        server + "/v1/completions",
        data=json.dumps({"prompt": [5] * 200, "max_tokens": 3}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        urllib.request.urlopen(req, timeout=120)
        assert False, "expected 400"
    except urllib.error.HTTPError as e:
        assert e.code == 400
        assert json.loads(e.read())["error"]["type"] == "invalid_request_error"


def test_openai_max_tokens_zero(server):
    req = urllib.request.Request(
        server + "/v1/completions",
        data=json.dumps({"prompt": "Hi", "max_tokens": 0}).encode(),
        headers={"Content-Type": "application/json"},
    )
    body = json.loads(urllib.request.urlopen(req, timeout=120).read())
    assert body["choices"][0]["text"] == ""
    assert body["usage"]["completion_tokens"] == 0
    assert body["choices"][0]["finish_reason"] == "length"


def test_openai_chat_completions(server):
    req = urllib.request.Request(
        server + "/v1/chat/completions",
        data=json.dumps({"messages": [
            {"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"}],
            "max_tokens": 4}).encode(),
        headers={"Content-Type": "application/json"},
    )
    body = json.loads(urllib.request.urlopen(req, timeout=120).read())
    assert body["object"] == "chat.completion"
    assert body["choices"][0]["message"]["role"] == "assistant"
    assert body["usage"]["prompt_tokens"] > 0


def test_openai_chat_stream(server):
    req = urllib.request.Request(
        server + "/v1/chat/completions",
        data=json.dumps({"messages": [{"role": "user", "content": "hi"}],
                         "max_tokens": 4, "stream": True}).encode(),
        headers={"Content-Type": "application/json"},
    )
    body = urllib.request.urlopen(req, timeout=120).read().decode()
    assert body.rstrip().endswith("data: [DONE]")
    lines = [json.loads(l[6:]) for l in body.splitlines()
             if l.startswith("data: ") and l != "data: [DONE]"]
    assert lines[0]["choices"][0]["delta"].get("role") == "assistant"
    assert lines[-1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_chat_template_rendering():
    """A GGUF-style chat template (jinja2) renders messages into the
    prompt the model's authors intended."""
    rng = np.random.default_rng(15)
    params = params_from_ggml(CFG, make_ggml_weights(CFG, rng),
                              dtype=jnp.float32)
    sched = Scheduler(CFG, params, sampling=SamplingConfig(temperature=0.0),
                      max_batch=1, cache_dtype=jnp.float32, decode_chunk=4)
    tmpl = ("{% for m in messages %}[{{ m.role }}]{{ m.content }}"
            "{% endfor %}{% if add_generation_prompt %}[assistant]{% endif %}")
    httpd = serve(sched, byte_fallback_vocab(), host="127.0.0.1", port=0,
                  model_info={"model": "t", "chat_template": tmpl})
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            data=json.dumps({"messages": [{"role": "user", "content": "yo"}],
                             "max_tokens": 2}).encode(),
            headers={"Content-Type": "application/json"})
        body = json.loads(urllib.request.urlopen(req, timeout=120).read())
        # the rendered prompt "[user]yo[assistant]" has 19 chars -> more
        # prompt tokens than the raw 2-char message under the byte vocab
        assert body["usage"]["prompt_tokens"] >= 15
    finally:
        httpd.shutdown()
        httpd.serving_loop.stop()


def test_openai_chat_bad_messages(server):
    req = urllib.request.Request(
        server + "/v1/chat/completions",
        data=json.dumps({"messages": "hi"}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        urllib.request.urlopen(req, timeout=60)
        assert False
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_chat_template_sandboxed(monkeypatch):
    """GGUF chat templates are attacker-supplied jinja source: attribute-
    chain escapes must raise, runaway loops must hit the render timeout,
    and absurd output sizes must be rejected (all -> 400 at the API)."""
    import jinja2

    from tokenhawk_tpu.serving import server as server_mod

    msgs = [{"role": "user", "content": "hi"}]
    with pytest.raises(jinja2.exceptions.SecurityError):
        server_mod._render_chat_template(
            "{{ messages.__class__.__mro__ }}", msgs)
    with pytest.raises(jinja2.TemplateError, match="too large"):
        server_mod._render_chat_template(
            "x" * (server_mod._TEMPLATE_MAX_BYTES + 1), msgs)
    # the sandbox already rejects absurd single ranges outright
    with pytest.raises(OverflowError):
        server_mod._render_chat_template(
            "{% for i in range(10**9) %}{% endfor %}", msgs)
    # nested in-cap loops spin instead -> bounded by the render timeout
    monkeypatch.setattr(server_mod, "_RENDER_TIMEOUT_S", 0.3)
    with pytest.raises(jinja2.TemplateError, match="timed out"):
        server_mod._render_chat_template(
            "{% for i in range(99999) %}{% for j in range(99999) %}"
            "{% endfor %}{% endfor %}", msgs)
    monkeypatch.setattr(server_mod, "_RENDER_MAX_CHARS", 100)
    with pytest.raises(jinja2.TemplateError, match="output too large"):
        server_mod._render_chat_template("{{ 'x' * 200 }}", msgs)
    # a benign template still renders
    assert server_mod._render_chat_template(
        "{% for m in messages %}{{ m.content }}{% endfor %}", msgs) == "hi"


def test_chat_template_without_jinja2_is_a_clear_error(monkeypatch):
    """jinja2 is optional: without it a templated chat request gets a
    message naming the missing package and the endpoints that work."""
    import sys

    from tokenhawk_tpu.serving import server as server_mod

    monkeypatch.setitem(sys.modules, "jinja2", None)
    monkeypatch.setitem(sys.modules, "jinja2.sandbox", None)
    with pytest.raises(RuntimeError, match="needs the jinja2 package"):
        server_mod._render_chat_template(
            "{{ messages }}", [{"role": "user", "content": "hi"}])


def test_malicious_chat_template_maps_to_400():
    """End-to-end: a model file carrying an escape-attempt template gets
    a clean 400 from /v1/chat/completions, not code execution."""
    rng = np.random.default_rng(16)
    params = params_from_ggml(CFG, make_ggml_weights(CFG, rng),
                              dtype=jnp.float32)
    sched = Scheduler(CFG, params, sampling=SamplingConfig(temperature=0.0),
                      max_batch=1, cache_dtype=jnp.float32, decode_chunk=4)
    evil = ("{{ messages.__class__.__mro__[1].__subclasses__() }}")
    httpd = serve(sched, byte_fallback_vocab(), host="127.0.0.1", port=0,
                  model_info={"model": "t", "chat_template": evil})
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            data=json.dumps({"messages": [{"role": "user", "content": "x"}],
                             "max_tokens": 2}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            assert False, "expected 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400
    finally:
        httpd.shutdown()
        httpd.serving_loop.stop()


def test_session_turns_serialized():
    """Two concurrent messages on one text-replay session must be
    serialized on the loop thread: the second turn's replayed prompt
    includes the first turn's output (no stale-history replay)."""
    from tokenhawk_tpu.runtime.paged_scheduler import PagedScheduler
    from tokenhawk_tpu.serving.server import _SENTINEL, ServingLoop

    rng = np.random.default_rng(17)
    params = params_from_ggml(CFG, make_ggml_weights(CFG, rng),
                              dtype=jnp.float32)
    sched = PagedScheduler(CFG, params,
                           sampling=SamplingConfig(temperature=0.0),
                           max_batch=2, max_seq=64, cache_dtype=jnp.float32,
                           decode_chunk=4, page_size=8, n_pages=24)
    tok = byte_fallback_vocab()
    loop = ServingLoop(sched, tok).start()
    try:
        # Submitted back-to-back from this (handler) thread: under the
        # old racy read both would replay empty history.
        q1 = loop.submit_text("A", max_tokens=3, session="s")
        q2 = loop.submit_text("B", max_tokens=3, session="s")

        def drain(q):
            parts = []
            while True:
                item = q.get(timeout=120)
                if item is _SENTINEL:
                    return "".join(parts)
                if isinstance(item, tuple):
                    continue
                parts.append(item)

        o1, o2 = drain(q1), drain(q2)
        # loop-thread-owned history reflects both turns, in order
        assert loop._session_hist["s"] == "A" + o1 + "B" + o2
        # and the second request saw the first turn in its prompt
        assert q2.n_prompt_tokens > q1.n_prompt_tokens
    finally:
        loop.stop()
