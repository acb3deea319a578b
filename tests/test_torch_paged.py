"""The port's paged KV serving slice (``ray_tpu_torch.models.llama``'s
paged functions, the paged and speculative ``LLMEngine``, ``LLMServer(
speculative=)``) on ``device="cpu"``, against the JAX package.

Model functions take the same weights (the JAX tree through
``params_from_numpy``), the same pools and tables and the same tokens,
made from numpy seeds. The port's pool has one sink block past the
reference's (``init_paged_kv_cache``), so pools are compared on the
reference's ``NB`` blocks. Tolerances: 1e-4 in f32 (summation order
only), 5e-2 in bf16 (the reference's own bf16 bound).

Engines run ``LlamaConfig.tiny()`` in f32, where greedy tokens of the two
frameworks are identical; each is held to the JAX package's
``generate``. The bookkeeping test runs one request sequence through the
JAX paged engine and the port's and compares their host counters.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as J  # noqa: E402
from ray_tpu_torch.models import llama as T  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.serve.llm import engine as E  # noqa: E402

F32_TOL, BF16_TOL = 1e-4, 5e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
_CACHE = {}


def _np_tree(tree):
    def leaf(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return np.asarray(a.astype(jnp.float32))
        return np.asarray(a)
    return jax.tree_util.tree_map(leaf, tree)


def _pair(dtype):
    if dtype not in _CACHE:
        jd, td, _ = DTYPES[dtype]
        jc = J.LlamaConfig.tiny(dtype=jd)
        tc = T.LlamaConfig.tiny(dtype=td)
        jp = J.init_params(jc, jax.random.key(0))
        _CACHE[dtype] = (jc, jp, tc, params_from_numpy(_np_tree(jp), tc,
                                                        "cpu"))
    return _CACHE[dtype]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _f32(t):
    return t.float().numpy()


NB, BS = 12, 4                 # pool blocks, block size


def _pools(dtype, seed):
    """The same random pool contents for both packages: (jax pools,
    port pools with the sink block, numpy [L, NB, BS, n_kv, hd])."""
    jc, _, tc, _ = _pair(dtype)
    jd, td, _ = DTYPES[dtype]
    rng = np.random.RandomState(seed)
    shape = (tc.n_layers, NB, BS, tc.n_kv_heads, tc.head_dim)
    kv = {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}
    jpools = {n: jnp.asarray(a).astype(jd) for n, a in kv.items()}
    tpools = T.init_paged_kv_cache(tc, NB, BS, device="cpu")
    assert tpools["k"].shape[1] == NB + 1 and T.sink_block(tpools) == NB
    for n, a in kv.items():
        tpools[n][:, :NB] = torch.from_numpy(a).to(td)
    return jpools, tpools


# Row 3 is inactive and its stale table row aliases row 0's: at row 0's
# position it would write row 0's block at row 0's offset. Row 2 is
# inactive too, aliasing row 1's table one position past row 1's write.
TABLES = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7], [0, 1, 2, 3]],
                  np.int32)
POSITIONS = np.array([9, 14, 15, 9], np.int32)
ACTIVE = np.array([True, True, False, False])


def _write_targets(positions):
    return [(int(TABLES[b, p // BS]), int(p % BS))
            for b, p in enumerate(positions)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_step_paged_matches_reference(dtype):
    jc, jp, tc, tp = _pair(dtype)
    tol = DTYPES[dtype][2]
    jpools, tpools = _pools(dtype, 1)
    before = tpools["k"].clone()
    toks = np.random.RandomState(2).randint(0, 256, 4).astype(np.int32)
    jl, jpools = J.decode_step_paged(
        jp, jpools, jnp.asarray(TABLES), jnp.asarray(toks),
        jnp.asarray(POSITIONS), jc, active=jnp.asarray(ACTIVE))
    tl, tpools = T.decode_step_paged(
        tp, tpools, torch.from_numpy(TABLES), torch.from_numpy(toks).long(),
        torch.from_numpy(POSITIONS).long(), tc,
        active=torch.from_numpy(ACTIVE))
    _close(tl.numpy()[ACTIVE], np.asarray(jl)[ACTIVE], tol)
    for n in ("k", "v"):
        _close(_f32(tpools[n][:, :NB]), np.asarray(jpools[n], np.float32),
               tol)
    # The inactive rows' targets: row 3's aliases row 0's write, which
    # holds row 0's new value (the reference's); row 2's is untouched.
    targets = _write_targets(POSITIONS)
    assert targets[3] == targets[0]
    blk, off = targets[2]
    assert torch.equal(tpools["k"][:, blk, off], before[:, blk, off])
    blk, off = targets[0]
    assert not torch.equal(tpools["k"][:, blk, off], before[:, blk, off])
    # Everything but the live rows' two targets (and the sink) is as it was.
    changed = (tpools["k"][:, :NB] != before[:, :NB]).any(-1).any(-1)
    assert {(int(b), int(o)) for b, o in changed.any(0).nonzero()} == {
        targets[0], targets[1]}


def test_decode_step_paged_equals_dense_decode_on_the_same_contents():
    """The paged step on a pool equals the dense step on a cache that
    holds each row's dense view: same arithmetic, same bits."""
    _, _, tc, tp = _pair("f32")
    _, tpools = _pools("f32", 3)
    tables = torch.from_numpy(TABLES[:2]).long()
    dense = {n: torch.stack([T._paged_view(tpools[n][i], tables)
                             for i in range(tc.n_layers)])
             for n in ("k", "v")}
    toks = torch.tensor([3, 7])
    pos = torch.tensor([9, 14])
    pl, _ = T.decode_step_paged(tp, tpools, tables, toks, pos, tc)
    dl, dense = T.decode_step(tp, dense, toks, pos, tc)
    assert torch.equal(pl, dl)
    for n in ("k", "v"):
        view = torch.stack([T._paged_view(tpools[n][i], tables)
                            for i in range(tc.n_layers)])
        assert torch.equal(view, dense[n])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_verify_kv_paged_matches_reference(dtype):
    jc, jp, tc, tp = _pair(dtype)
    tol = DTYPES[dtype][2]
    jpools, tpools = _pools(dtype, 4)
    toks = np.random.RandomState(5).randint(0, 256, (4, 3)).astype(
        np.int32)
    pos = np.array([5, 9, 0, 5], np.int32)
    jl, jpools = J.verify_kv_paged(
        jp, jpools, jnp.asarray(TABLES), jnp.asarray(toks), jnp.asarray(pos),
        jc, active=jnp.asarray(ACTIVE))
    tl, tpools = T.verify_kv_paged(
        tp, tpools, torch.from_numpy(TABLES), torch.from_numpy(toks).long(),
        torch.from_numpy(pos).long(), tc, active=torch.from_numpy(ACTIVE))
    assert tl.shape == (4, 3, tc.vocab_size)
    _close(tl.numpy()[ACTIVE], np.asarray(jl)[ACTIVE], tol)
    for n in ("k", "v"):
        _close(_f32(tpools[n][:, :NB]), np.asarray(jpools[n], np.float32),
               tol)


def test_verify_rows_equal_sequential_decode_steps():
    """Row j of one verify call is what decode_step_paged gives after
    consuming inputs 0..j one at a time (f32: to rounding)."""
    _, _, tc, tp = _pair("f32")
    _, p1 = _pools("f32", 6)
    _, p2 = _pools("f32", 6)
    tables = torch.from_numpy(TABLES[:2]).long()
    toks = torch.tensor([[4, 9, 1], [8, 2, 6]])
    pos = torch.tensor([3, 7])
    vl, p1 = T.verify_kv_paged(tp, p1, tables, toks, pos, tc)
    for j in range(3):
        dl, p2 = T.decode_step_paged(tp, p2, tables, toks[:, j], pos + j, tc)
        _close(vl[:, j].numpy(), dl.numpy(), F32_TOL)
    _close(p1["k"].numpy(), p2["k"].numpy(), F32_TOL)


@pytest.mark.parametrize("dtype,start", [("f32", 8), ("f32", 0),
                                         ("bf16", 8), ("bf16", 0)])
def test_prefill_kv_paged_matches_reference(dtype, start):
    jc, jp, tc, tp = _pair(dtype)
    jd, td, tol = DTYPES[dtype]
    rng = np.random.RandomState(7)
    S_pad, Pb = 32, 8
    shape = (tc.n_layers, S_pad, tc.n_kv_heads, tc.head_dim)
    hist = [rng.randn(*shape).astype(np.float32) if start else
            np.zeros(shape, np.float32) for _ in range(2)]
    toks = rng.randint(0, 256, (1, Pb)).astype(np.int32)
    jx, jks, jvs = J.prefill_kv_paged(
        jp, jnp.asarray(toks), jnp.int32(start),
        *(jnp.asarray(h).astype(jd) for h in hist), jc)
    tx, tks, tvs = T.prefill_kv_paged(
        tp, torch.from_numpy(toks).long(), start,
        *(torch.from_numpy(h).to(td) for h in hist), tc)
    _close(_f32(tx), np.asarray(jx, np.float32), tol)
    _close(_f32(tks), np.asarray(jks, np.float32), tol)
    _close(_f32(tvs), np.asarray(jvs, np.float32), tol)
    if start == 0:      # no history: prefill_kv's function over the bucket
        dx, dks, _ = T.prefill_kv(tp, torch.from_numpy(toks).long(), tc)
        _close(_f32(tx), _f32(dx), tol)
        _close(_f32(tks), _f32(dks), tol)
    with pytest.raises(ValueError, match="past"):
        T.prefill_kv_paged(tp, torch.from_numpy(toks).long(), S_pad - 4,
                           *(torch.from_numpy(h).to(td) for h in hist), tc)


def test_paged_functions_refuse_moe():
    tc = T.LlamaConfig.tiny(n_experts=4)
    z = torch.zeros((1,), dtype=torch.long)
    for fn in (T.decode_step_paged, T.verify_kv_paged):
        with pytest.raises(NotImplementedError, match="MoE"):
            fn({}, {}, z[None], z[None] if fn is T.verify_kv_paged else z,
               z, tc)


# ------------------------------------------------------------------ engine

# Paged geometry of the engine tests: buckets (16, 32) at block size 8.
_GEO = dict(num_slots=3, max_seq_len=96, prefill_buckets=(16, 32),
            kv_layout="paged", kv_block_size=8)


def _model():
    """tiny f32 for both packages; the port's under attn_impl="flash"
    (CPU tensors take the flash path's plain version at 128 and above,
    plain attention below, as the reference's rule does)."""
    if "model" not in _CACHE:
        jc = J.LlamaConfig.tiny(dtype=jnp.float32)
        jp = J.init_params(jc, jax.random.key(0))
        tc = T.LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash")
        _CACHE["model"] = (jc, jp, tc, params_from_numpy(_np_tree(jp), tc,
                                                          "cpu"))
    return _CACHE["model"]


def _engine(draft=None, **overrides):
    _, _, tc, tp = _model()
    kw = {} if draft is None else dict(draft_params=draft[0],
                                       draft_config=draft[1])
    return E.LLMEngine(tp, tc, E.EngineConfig(**{**_GEO, **overrides}),
                       device="cpu", **kw)


_REF_N = 16


def _reference(prompt, n):
    """The JAX package's greedy ``generate``: _REF_N tokens per prompt,
    memoized, of which the first n (greedy tokens do not depend on how
    many follow)."""
    assert n <= _REF_N
    refs = _CACHE.setdefault("refs", {})
    if tuple(prompt) not in refs:
        jc, jp, _, _ = _model()
        out = J.generate(jp, jnp.asarray([prompt], jnp.int32), jc,
                         max_new_tokens=_REF_N)
        refs[tuple(prompt)] = np.asarray(out)[0].tolist()
    return refs[tuple(prompt)][:n]


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, n).tolist()


def _run(eng, prompt, n, **kw):
    h = eng.submit(E.Request(prompt=list(prompt), max_tokens=n, **kw))
    eng.drain()
    return h


_SYS = _prompt(7, 16)                    # a two-block shared prefix
_PROMPT = _prompt(8, 14)


def test_paged_greedy_parity_and_prefix_hit():
    """Mixed lengths over both buckets, token-exact against generate; a
    second prompt sharing a block-aligned prefix skips its prefill."""
    eng = _engine()
    specs = [(_prompt(1, 3), 6), (_prompt(2, 20), 8), (_PROMPT, 12),
             (_prompt(3, 9), 2)]
    handles = [eng.submit(E.Request(prompt=p, max_tokens=n))
               for p, n in specs]
    eng.drain()
    for (p, n), h in zip(specs, handles):
        assert h.finish_reason == "length" and h.tokens == _reference(p, n)
    p1, p2 = _SYS + _prompt(9, 4), _SYS + _prompt(10, 5)
    before = eng.stats()["prefix_cache"]
    h1 = _run(eng, p1, 4)
    h2 = _run(eng, p2, 4)
    after = eng.stats()["prefix_cache"]
    assert h1.tokens == _reference(p1, 4) and h2.tokens == _reference(p2, 4)
    assert after["hits"] >= before["hits"] + 1
    assert after["hit_tokens"] >= before["hit_tokens"] + len(_SYS)
    assert h2.prefilled_tokens == len(p2) - len(_SYS)
    assert eng.stats()["kv"]["used_blocks"] == after["entries"]


def test_paged_pool_exhaustion_queues_not_crash():
    """Block demand past the pool parks requests in the queue until
    finishing sequences free blocks; a request that can never fit fails
    at submit."""
    eng = _engine(num_slots=4, prefill_buckets=(8,), max_seq_len=32,
                  kv_block_size=4, num_kv_blocks=6, prefix_cache=False)
    with pytest.raises(ValueError, match="pool"):
        eng.submit(E.Request(prompt=[1] * 8, max_tokens=32))
    handles = [eng.submit(E.Request(prompt=_prompt(20 + i, 8),
                                    max_tokens=4)) for i in range(5)]
    eng.step()
    st = eng.stats()
    assert st["queued"] >= 1 and st["kv"]["admission_waits"] >= 1
    assert st["kv"]["used_blocks"] <= 6
    eng.drain()
    for i, h in enumerate(handles):
        assert h.tokens == _reference(_prompt(20 + i, 8), 4)
    assert eng.stats()["kv"]["used_blocks"] == 0


def test_export_adopt_round_trip_and_preempt_resume():
    """preempt() mid-decode exports the slot's blocks (the copy equals
    the pool rows bit for bit); readmission adopts them back (the pool
    rows equal the copy) and the tokens equal the uninterrupted run."""
    eng = _engine()
    h = eng.submit(E.Request(prompt=_PROMPT, max_tokens=12, slo="batch"))
    for _ in range(4):
        eng.step()
    assert 0 < len(h.tokens) < 12
    slot = next(s for s in range(3) if eng._slots[s].handle is h)
    n_valid = -(-int(eng._pos[slot]) // 8)
    ids = eng._tables[slot, :n_valid].tolist()
    rows = eng._cache["k"][:, ids].clone()
    free_before = eng._allocator.free_blocks
    eng.preempt(slot)
    st = h.kv_state
    assert st is not None and torch.equal(st.k_blocks, rows)
    assert st.k_blocks.device.type == "cpu"
    assert eng._allocator.free_blocks > free_before
    assert eng.stats()["preempted"] == 1
    eng.step()             # readmitted (adopted back), then one tick
    slot = next(s for s in range(3) if eng._slots[s].handle is h)
    ids = eng._tables[slot, :n_valid].tolist()

    def rows(t):            # the consumed rows; the tick wrote row pos
        return t.flatten(1, 2)[:, :st.pos]

    assert torch.equal(rows(eng._cache["k"][:, ids]), rows(st.k_blocks))
    assert torch.equal(rows(eng._cache["v"][:, ids]), rows(st.v_blocks))
    eng.drain()
    assert h.tokens == _reference(_PROMPT, 12) and h.kv_state is None
    assert eng.stats()["migration"]["blocks"] == n_valid


def test_interactive_pressure_preempts_batch():
    """Every slot held by batch decodes: a waiting interactive request
    trips the gate (hold 0, cooldown 0) and checkpoints the newest batch
    decode, which resumes exactly."""
    eng = _engine(num_slots=2, preempt_hold_s=0.0, preempt_cooldown_s=0.0)
    batch = [eng.submit(E.Request(prompt=_PROMPT, max_tokens=16,
                                  slo="batch")) for _ in range(2)]
    eng.step()
    assert eng.stats()["active_slots"] == 2
    inter = eng.submit(E.Request(prompt=_SYS, max_tokens=2))
    eng.step()
    eng.drain()
    assert eng.stats()["preempted"] >= 1
    assert inter.tokens == _reference(_SYS, 2)
    for b in batch:
        assert b.tokens == _reference(_PROMPT, 16)


def test_chunked_long_prompt_parity():
    """A prompt past the largest bucket is refused unless chunked; chunked,
    it prefills in bucket-sized chunks through the prefix cache (one per
    step) and decodes exactly as generate does."""
    long_prompt = _prompt(11, 70)
    eng = _engine()
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(E.Request(prompt=long_prompt, max_tokens=8))
    h = _run(eng, long_prompt, 8, chunked_prefill=True)
    assert h.tokens == _reference(long_prompt, 8)
    st = eng.stats()
    assert st["chunked_prefill"] == {"prompts": 1, "chunks": 3}
    assert h.prefilled_tokens == len(long_prompt)
    dense = E.LLMEngine(_model()[3], _model()[2], E.EngineConfig(
        max_seq_len=96, prefill_buckets=(16, 32)), device="cpu")
    with pytest.raises(ValueError, match="chunked_prefill"):
        dense.submit(E.Request(prompt=long_prompt, max_tokens=8,
                               chunked_prefill=True))


def _spill_all(eng):
    n = len(eng._prefix)
    assert eng._prefix.evict(n) == n
    return n


def test_spill_promote_bitwise_parity():
    """Prefill once, spill the chain to the host tier, re-admit: the
    promote copies the spilled rows back bit for bit and the tokens are
    the same, with only the suffix prefilled."""
    eng = _engine(kv_prefill_cost_per_token_ms=50.0)  # always promote
    h1 = _run(eng, _SYS + _PROMPT, 6)
    assert h1.tokens == _reference(_SYS + _PROMPT, 6)
    hist = eng._cache["k"][:, eng._prefix.match(_SYS + _PROMPT)].clone()
    eng._allocator.free(eng._prefix.match(_SYS + _PROMPT))   # undo refs
    eng._allocator.free(eng._prefix.match(_SYS + _PROMPT))
    assert _spill_all(eng) == 3
    st = eng.stats()["kv_tiers"]
    assert st["host"]["blocks"] == 3 and eng._prefix.stats()["spilled"] == 3
    h2 = eng.submit(E.Request(prompt=_SYS + _PROMPT, max_tokens=6))
    eng.step()
    slot = next(s for s in range(3) if eng._slots[s].handle is h2)
    assert torch.equal(eng._cache["k"][:, eng._tables[slot, :3].tolist()],
                       hist)
    eng.drain()
    assert h2.tokens == h1.tokens
    st = eng.stats()["kv_tiers"]
    assert st["promoted_blocks"] == 3 and st["host"]["blocks"] == 0
    assert h2.prefilled_tokens == len(_SYS + _PROMPT) - 3 * 8


def test_promote_all_or_nothing_under_exhaustion():
    """A promote the pool cannot cover is dropped whole (tier entries
    stay) and the request is a plain recompute with the same tokens."""
    eng = _engine(kv_prefill_cost_per_token_ms=50.0)
    ref = _run(eng, _SYS + _PROMPT, 6).tokens
    _spill_all(eng)
    real, calls = eng._allocator.alloc, {"n": 0}

    def flaky(n):
        calls["n"] += 1
        return None if calls["n"] <= 2 else real(n)

    eng._allocator.alloc = flaky
    try:
        h2 = _run(eng, _SYS + _PROMPT, 6)
    finally:
        eng._allocator.alloc = real
    assert calls["n"] >= 3 and h2.tokens == ref
    st = eng.stats()["kv_tiers"]
    assert st["promoted_blocks"] == 0 and st["host"]["blocks"] == 3
    assert h2.prefilled_tokens == len(_SYS + _PROMPT)


@pytest.mark.parametrize("spec_k", [2, 4])
def test_speculative_greedy_parity(spec_k):
    """Speculation is token-invisible: a random draft (from the port's
    build_draft) accepts about nothing, a self-draft about everything, and
    both emit generate's tokens, also across a preempt -> resume (the
    draft cache is re-prefilled from prompt + emitted tokens)."""
    from ray_tpu_torch.serve.llm.disagg.spec import (build_draft,
                                                     draft_config_for)

    _, _, tc, tp = _model()
    ref = _reference(_PROMPT, 12)
    rand = build_draft(tc, seed=1, device="cpu")
    assert rand[1] == draft_config_for(tc) and rand[1].head_dim == 16
    for draft in (rand, (tp, tc)):
        eng = _engine(draft=draft, spec_k=spec_k)
        hs = [eng.submit(E.Request(prompt=p, max_tokens=12))
              for p in (_PROMPT, _SYS)]
        for _ in range(3):
            eng.step()
        eng.preempt(next(s for s in range(3)
                         if eng._slots[s].handle is hs[0]))
        eng.drain()
        assert hs[0].tokens == ref
        assert hs[1].tokens == _reference(_SYS, 12)
        spec = eng.stats()["spec"]
        assert spec["rounds"] > 0
        assert spec["proposed"] >= (spec_k - 1) * spec["rounds"]
        if draft[0] is tp:
            assert spec["accept_ratio"] > 0.7


def test_llm_server_speculative_and_chunked():
    """LLMServer(speculative=...) in its three forms, and the
    chunked_prefill request key, give generate's tokens."""
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.serve.llm.disagg.spec import build_draft

    _, _, tc, tp = _model()
    long_prompt = _prompt(11, 70)
    forms = (True, {"draft_seed": 3},
             {"params_loader": lambda: build_draft(tc, 2, device="cpu")[0],
              "draft_config": dict(vars(tc))})
    for spec in forms:
        server = LLMServer(model_config=tc, engine_config=dict(_GEO),
                           params_loader=lambda: tp, quantize="bf16",
                           speculative=spec, device="cpu")
        try:
            out = server({"prompt": _PROMPT, "max_tokens": 8})
            assert out["tokens"] == _reference(_PROMPT, 8)
            assert server.stats()["spec"]["rounds"] > 0
            if spec is True:
                out = server({"prompt": long_prompt, "max_tokens": 4,
                              "chunked_prefill": True})
                assert out["tokens"] == _reference(long_prompt, 4)
        finally:
            server.shutdown()


# The bookkeeping differential: one request sequence through both paged
# engines, stepped in lock-step. Pool of 14 blocks of 8 rows, 2 slots;
# the cost model promotes runs of 4 blocks or more and skips shorter.
_DIFF_GEO = dict(num_slots=2, max_seq_len=96, prefill_buckets=(16, 48),
                 kv_layout="paged", kv_block_size=8, num_kv_blocks=14,
                 preempt_hold_s=0.0, preempt_cooldown_s=0.0,
                 kv_adopt_cost_fixed_ms=1.0, kv_adopt_cost_per_block_ms=0.1,
                 kv_prefill_cost_per_token_ms=0.05)
_A = _prompt(30, 40)                     # a five-block system prefix
_B = _prompt(31, 16)
# (step to submit at, prompt, max_tokens, lane)
_DIFF_SCHEDULE = [
    (0, _A + _prompt(32, 3), 4, "interactive"),
    (0, _B + _prompt(33, 3), 4, "interactive"),
    (6, _A + _prompt(34, 5), 4, "interactive"),       # pool hit on A
    (12, _prompt(35, 44), 30, "batch"),               # fill the pool:
    (12, _prompt(36, 44), 30, "batch"),               # A and B evicted
    (16, _B + _prompt(37, 2), 3, "interactive"),      # preempts a batch
    (40, _A + _prompt(38, 6), 3, "interactive"),      # tier hit on A
    (60, _B + _prompt(39, 4), 3, "interactive"),      # short tier hit on B
]


def _drive(eng, Request, n_steps=400):
    handles = []
    for step in range(n_steps):
        for at, prompt, n, lane in _DIFF_SCHEDULE:
            if at == step:
                handles.append(eng.submit(Request(prompt=prompt,
                                                  max_tokens=n, slo=lane)))
        eng.step()
        if step > _DIFF_SCHEDULE[-1][0] and not eng.has_work():
            break
    assert not eng.has_work()
    return handles


def _bookkeeping(st):
    tiers = st["kv_tiers"]
    return {"prefix_hits": st["prefix_cache"]["hits"],
            "prefix_hit_tokens": st["prefix_cache"]["hit_tokens"],
            "evictions": st["prefix_cache"]["evictions"],
            "spilled": st["prefix_cache"]["spilled"],
            "tier_spills": tiers["host"]["spills"],
            "tier_promotes": tiers["host"]["promotes"],
            "promoted_blocks": tiers["promoted_blocks"],
            "promote_skips": tiers["promote_skips"],
            "preempted": st["preempted"],
            "migrated_blocks": st["migration"]["blocks"],
            "used_blocks": st["kv"]["used_blocks"],
            "completed": st["completed"]}


def test_paged_bookkeeping_matches_the_reference_engine():
    """The same request sequence through the JAX package's paged
    LLMEngine and the port's: equal tokens and equal host counters
    (prefix hits and hit tokens, evictions, spills, promotes, promote
    skips, preemptions, adopted blocks, used blocks)."""
    from ray_tpu.serve.llm import engine as JE

    jc, jp, tc, tp = _model()
    jeng = JE.LLMEngine(jp, jc, JE.EngineConfig(**_DIFF_GEO))
    teng = E.LLMEngine(tp, tc, E.EngineConfig(**_DIFF_GEO), device="cpu")
    jh = _drive(jeng, JE.Request)
    th = _drive(teng, E.Request)
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert [h.finish_reason for h in th] == ["length"] * len(th)
    want, got = _bookkeeping(jeng.stats()), _bookkeeping(teng.stats())
    assert got == want
    for key in ("prefix_hits", "spilled", "promoted_blocks",
                "promote_skips", "preempted"):
        assert got[key] > 0, (key, got)
