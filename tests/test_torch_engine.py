"""The port's dense continuous-batching engine and ``LLMServer``
(``ray_tpu_torch.serve.llm``) on ``device="cpu"``, against the JAX
package's ``generate``.

Greedy parity runs at f32 compute, where the two frameworks agree to f32
rounding and greedy tokens are identical (at bf16 a near-tie can flip a
token between frameworks; ``tests/test_torch_llama.py`` holds bf16 values
to their tolerance). The port's engine uses ``attn_impl="flash"`` with
buckets (16, 128), so prompts over 16 tokens prefill at 128 through the
flash path's plain version. The JAX side is ``generate`` with the default
``attn_impl="xla"`` at the exact prompt length, which is what it would
run under "flash" too: its prompts are all under 128 tokens, where the
reference's own rule takes plain attention.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as J  # noqa: E402
from ray_tpu_torch.models import llama as T  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.serve.llm import engine as E  # noqa: E402

_CACHE = {}
BUCKETS = (16, 128)


def _model():
    if "model" not in _CACHE:
        jc = J.LlamaConfig.tiny(dtype=jnp.float32)
        jp = J.init_params(jc, jax.random.key(0))
        tree = jax.tree_util.tree_map(np.asarray, jp)
        tc = T.LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash")
        _CACHE["model"] = (jc, jp, tc, params_from_numpy(tree, tc, "cpu"))
    return _CACHE["model"]


def _engine(slots=4, S=160, rng_seed=0, **kw):
    _, _, tc, tp = _model()
    return E.LLMEngine(tp, tc, E.EngineConfig(
        num_slots=slots, max_seq_len=S, prefill_buckets=BUCKETS, **kw),
        rng_seed=rng_seed, device="cpu")


def _specs(seed, pairs):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, p).tolist(), n) for p, n in pairs]


# Mixed prompt/output lengths over both buckets (20 and 40 prefill at 128).
_PARITY_PAIRS = [(3, 6), (8, 2), (20, 8), (16, 4), (5, 1), (40, 7)]


def _reference(prompt, n):
    """The JAX package's per-request ``generate``: the parity oracle."""
    key = (tuple(prompt), n)
    refs = _CACHE.setdefault("refs", {})
    if key not in refs:
        jc, jp, _, _ = _model()
        out = J.generate(jp, jnp.asarray([prompt], jnp.int32), jc,
                         max_new_tokens=n)
        refs[key] = np.asarray(out)[0].tolist()
    return list(refs[key])


@pytest.mark.parametrize("decode_block", [1, 2])
def test_greedy_parity_with_jax_generate(decode_block):
    specs = _specs(0, _PARITY_PAIRS)
    engine = _engine(slots=3, decode_block=decode_block)
    handles = [engine.submit(E.Request(prompt=p, max_tokens=n))
               for p, n in specs]
    engine.drain()
    for (p, n), h in zip(specs, handles):
        assert h.finish_reason == "length"
        assert h.tokens == _reference(p, n), (len(p), n)
    assert engine.stats()["prefills"] == len(specs)


def test_staggered_arrivals_and_slot_recycling():
    """Arrivals interleaved with decode progress give the same tokens,
    and 2 slots recycle across all requests."""
    specs = _specs(0, _PARITY_PAIRS)[:5]
    engine = _engine(slots=2)
    handles = []
    for i, (p, n) in enumerate(specs):
        handles.append(engine.submit(E.Request(prompt=p, max_tokens=n)))
        for _ in range(i + 1):
            engine.step()
    engine.drain()
    for (p, n), h in zip(specs, handles):
        assert h.tokens == _reference(p, n)
    st = engine.stats()
    assert st["completed"] == 5 and st["active_slots"] == 0
    assert st["queued"] == 0 and st["slot_reuses"] >= 3


def test_eos_stop_and_max_tokens():
    """EOS halts and is emitted; a stop token halts without being
    emitted; max_tokens bounds generation; the cache length caps it."""
    prompt = list(range(1, 9))
    ref = _reference(prompt, 8)
    t3 = ref[2]
    eng = _engine(eos_id=t3)
    h = eng.submit(E.Request(prompt=prompt, max_tokens=8))
    eng.drain()
    assert h.finish_reason == "eos" and h.tokens == ref[:3]

    eng2 = _engine()
    h2 = eng2.submit(E.Request(prompt=prompt, max_tokens=8, stop=(t3,)))
    h3 = eng2.submit(E.Request(prompt=prompt, max_tokens=3))
    eng2.drain()
    assert h2.finish_reason == "stop" and h2.tokens == ref[:2]
    assert h3.finish_reason == "length" and h3.tokens == ref[:3]

    eng3 = _engine(S=128)                      # prompt 120 + 8 = 128
    long_prompt = _specs(9, [(120, 0)])[0][0]
    h4 = eng3.submit(E.Request(prompt=long_prompt, max_tokens=50))
    eng3.drain()
    assert h4.finish_reason == "length" and len(h4.tokens) == 8


def test_sampler_matches_softmax_frequencies():
    """Temperature sampling draws from softmax(logits / T): empirical
    frequencies over many rows; temperature 0 rows are greedy."""
    n = 20000
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(n, 1)
    temp = torch.full((n,), 0.7)
    temp[:10] = 0.0
    gen = torch.Generator().manual_seed(0)
    out = E._sample(logits, temp, gen)
    assert (out[:10] == 0).all()
    freq = np.bincount(out[10:].numpy(), minlength=4) / (n - 10)
    want = torch.softmax(logits[0] / 0.7, -1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.015)


def test_sampled_decode_terminates_and_reproduces():
    """Temperature > 0 requests finish with valid tokens, and the same
    engine seed gives the same tokens."""
    outs = []
    for _ in range(2):
        eng = _engine(rng_seed=7)
        hs = [eng.submit(E.Request(prompt=[5, 6, 7], max_tokens=6,
                                   temperature=0.9)),
              eng.submit(E.Request(prompt=[1, 2], max_tokens=4))]
        eng.drain()
        assert len(hs[0].tokens) == 6
        assert all(0 <= t < 256 for t in hs[0].tokens)
        assert hs[1].tokens == _reference([1, 2], 4)   # greedy row intact
        outs.append(hs[0].tokens)
    assert outs[0] == outs[1]


def test_cancel_queued_and_live():
    eng = _engine(slots=1)
    live = eng.submit(E.Request(prompt=[1, 2, 3], max_tokens=20))
    queued = eng.submit(E.Request(prompt=[4, 5], max_tokens=5))
    eng.step()
    assert queued.cancel() and queued.finish_reason == "cancelled"
    assert live.cancel()
    eng.drain()
    assert live.finish_reason == "cancelled" and live.done()
    assert eng.stats()["active_slots"] == 0


def test_llm_server_from_three_threads():
    from ray_tpu_torch.serve.llm import LLMServer

    _, _, tc, tp = _model()
    server = LLMServer(model_config=tc,
                       engine_config={"num_slots": 2, "max_seq_len": 160,
                                      "prefill_buckets": BUCKETS},
                       params_loader=lambda: tp, quantize="bf16",
                       device="cpu")
    try:
        specs = _specs(0, _PARITY_PAIRS)
        results = [None] * len(specs)

        def client(i):
            for j in range(i, len(specs), 3):
                p, n = specs[j]
                results[j] = server({"prompt": p, "max_tokens": n})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for (p, n), res in zip(specs, results):
            assert res["tokens"] == _reference(p, n)
            assert res["finish_reason"] == "length"
            assert res["ttft_s"] >= 0 and res["tpot_s"] >= 0
        server.check_health()
        assert server.stats()["completed"] == len(specs)
        assert server.load()["free_slots"] == 2
    finally:
        server.shutdown()


def test_int8_server_default_quantizes():
    """quantize defaults to int8, as in the reference's serve default."""
    from ray_tpu_torch.serve.llm import LLMServer

    server = LLMServer(model_config=T.LlamaConfig.tiny(),
                       engine_config={"num_slots": 1, "max_seq_len": 32,
                                      "prefill_buckets": (8,)},
                       device="cpu")
    try:
        assert server.quantize == "int8"
        assert "wq_q" in server._engine.params["layers"]
        out = server({"prompt": [1, 2, 3], "max_tokens": 3})
        assert out["num_tokens"] == 3
    finally:
        server.shutdown()


def test_bf16_server_keeps_plain_weights():
    """quantize="bf16" is the one opt-out of the int8 default."""
    from ray_tpu_torch.serve.llm import LLMServer

    server = LLMServer(model_config=T.LlamaConfig.tiny(),
                       engine_config={"num_slots": 1, "max_seq_len": 32,
                                      "prefill_buckets": (8,)},
                       quantize="bf16", device="cpu")
    try:
        layers = server._engine.params["layers"]
        assert server.stats()["quantize"] == "bf16"
        assert "wq" in layers and "wq_q" not in layers
    finally:
        server.shutdown()


def test_server_rejects_unknown_quantize():
    from ray_tpu_torch.serve.llm import LLMServer

    with pytest.raises(ValueError, match="quantize"):
        LLMServer(quantize="fp4", device="cpu")


def _later_slice_cases():
    """(case, callable, what it must do: (exception, match) to raise, or
    a check of its return value)."""
    _, _, tc, tp = _model()

    def paged():
        return _engine(kv_layout="paged", kv_block_size=16)

    def state():
        return None

    return {
        "submit_adopted": (lambda: paged().submit_adopted(
            E.Request(prompt=[1, 2], max_tokens=2), state()),
            (TypeError, "KVState")),
        "prefill_only": (lambda: _engine().submit(E.Request(
            prompt=[1, 2], max_tokens=2, prefill_only=True)),
            (ValueError, "paged")),
        "export_prefix": (lambda: paged().export_prefix([1] * 32),
                          lambda out: out == []),
        "paged_moe": (lambda: T.decode_step_paged(
            tp, {}, torch.zeros((1, 1), dtype=torch.long),
            torch.zeros((1,), dtype=torch.long),
            torch.zeros((1,), dtype=torch.long),
            T.LlamaConfig.tiny(n_experts=4)), (NotImplementedError, "MoE")),
    }


@pytest.mark.parametrize("case", ["submit_adopted", "prefill_only",
                                  "export_prefix", "paged_moe"])
def test_later_slices_raise_not_implemented(case):
    """Paged KV, speculative decoding and the disaggregated tier are
    ported (their own tests are ``tests/test_torch_paged.py`` and
    ``tests/test_torch_disagg.py``): a paged engine and a speculative one
    build, and the disaggregated tier's entry points no longer raise
    NotImplementedError: each refuses a bad call as the reference does (a
    state that is no KVState, prefill_only on a dense engine) or runs (an
    export from an empty prefix cache is empty). Paged MoE still raises
    NotImplementedError, as in the reference."""
    _, _, tc, tp = _model()
    E.EngineConfig(kv_layout="paged")
    E.LLMEngine(tp, tc, E.EngineConfig(kv_layout="paged",
                                       max_seq_len=160,
                                       prefill_buckets=BUCKETS),
                draft_params=tp, draft_config=tc, device="cpu")
    fn, want = _later_slice_cases()[case]
    if callable(want):
        assert want(fn())
        return
    with pytest.raises(want[0], match=want[1]):
        fn()


def test_submit_validation():
    eng = _engine()
    with pytest.raises(ValueError):
        eng.submit(E.Request(prompt=[], max_tokens=1))
    with pytest.raises(ValueError):
        eng.submit(E.Request(prompt=[1] * 129, max_tokens=1))
    with pytest.raises(ValueError):
        eng.submit(E.Request(prompt=[1], max_tokens=0))
    with pytest.raises(ValueError):
        E.EngineConfig(max_seq_len=64, prefill_buckets=(128,))


def test_warmup_runs_every_bucket_and_leaves_the_engine_idle():
    eng = _engine(slots=2)
    eng.warmup()
    st = eng.stats()
    assert st["prefills"] == len(BUCKETS) and st["completed"] == len(BUCKETS)
    assert st["active_slots"] == 0 and st["queued"] == 0
    p, n = _specs(0, _PARITY_PAIRS)[2]
    h = eng.submit(E.Request(prompt=p, max_tokens=n))
    eng.drain()
    assert h.tokens == _reference(p, n)


def test_static_batch_generate_pads_and_truncates():
    """The lockstep baseline: prompts of the full pad length come back
    as generate gives them, truncated to each request's max_tokens."""
    _, _, tc, tp = _model()
    specs = _specs(4, [(12, 5), (12, 3), (12, 6)])
    reqs = [E.Request(prompt=p, max_tokens=n) for p, n in specs]
    outs, seconds = E.static_batch_generate(tp, tc, reqs, batch_size=2,
                                            pad_to=12, warmup=False)
    assert len(seconds) == 2
    for (p, n), out in zip(specs, outs):
        assert out == _reference(p, 6)[:n]
