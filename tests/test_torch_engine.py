"""The port's ``ServingEngine`` against the JAX engine on one trace, on
the same (JAX-seeded) parameters: identical tokens and finish reasons,
and every ``stats()`` key that is not a wall-clock reading equal to 1e-12
relative — the modeled J and gCO2 come from the same counts priced by the
same meter. The trace has prompts of 3-90 tokens (two longer than
max_len, which prefill at exact length through the ring branch of
``prefill_write_cache`` and then decode around the ring) and two
requests that stop on their EOS id."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JModel
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import EngineConfig, Request, ServingEngine

ARCH = "llama3.2-1b"          # GQA smoke: 4 q heads over 2 kv heads
ECFG = dict(max_batch=4, max_len=64, profile="h100_sxm", region="QC")
WALL_CLOCK = ("queue_wait_",)


def _trace():
    rng = np.random.default_rng(11)
    lens = [3, 90, 17, 40, 64, 8, 75, 29, 5, 51]       # two > max_len
    news = rng.integers(1, 25, len(lens))
    news[0] = 1                                        # prefill-only request
    return [(i, rng.integers(2, 512, L).tolist(), int(n))
            for i, (L, n) in enumerate(zip(lens, news))]


@pytest.fixture(scope="module")
def setup():
    jmodel = JModel(jax_get_config(ARCH, "smoke"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, "smoke")
    model = Model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    trace = _trace()
    # pick two EOS ids the model really emits: the 4th token of two
    # requests in an EOS-free run of the port (greedy tokens do not depend
    # on batch neighbours)
    probe = ServingEngine(model, params, EngineConfig(**ECFG), device="cpu")
    for rid, prompt, _ in trace:
        probe.submit(Request(rid=rid, prompt=prompt, max_new_tokens=24))
    toks = {r.rid: r.tokens for r in probe.run()}
    eos = {3: toks[3][3], 7: toks[7][3]}
    return jmodel, jparams, model, params, trace, eos


def _run(engine, make_req, trace, eos):
    for rid, prompt, n in trace:
        engine.submit(make_req(rid=rid, prompt=list(prompt),
                               max_new_tokens=24 if rid in eos else n,
                               eos_id=eos.get(rid)))
    return {r.rid: r for r in engine.run()}


def test_engine_matches_reference(setup):
    jmodel, jparams, model, params, trace, eos = setup
    jeng = JServingEngine(jmodel, jparams, JEngineConfig(**ECFG))
    teng = ServingEngine(model, params, EngineConfig(**ECFG), device="cpu")
    want = _run(jeng, JRequest, trace, eos)
    got = _run(teng, Request, trace, eos)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
        assert got[rid].energy_j == pytest.approx(want[rid].energy_j,
                                                  rel=1e-12)
    assert {got[r].finish_reason for r in eos} == {"eos"}
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key, val in js.items():
        if key.startswith(WALL_CLOCK):
            continue
        assert ts[key] == pytest.approx(val, rel=1e-12, abs=0.0), key
    assert teng.carbon_report() == jeng.carbon_report()
    assert teng.host_syncs == jeng.host_syncs


@pytest.mark.parametrize("knob", [
    dict(prefill_chunk=16),                     # chunked without paged
    dict(paged=True, page_size=24),             # max_len 64 % 24 != 0
    dict(preemption=True),                      # preemption without chunks
    dict(paged=True, prefix_sharing=True),      # sharing without chunks
    dict(max_queue=0), dict(shards=2),
    dict(defer_below_priority=1), dict(tenant_quota={"*": (0.5, 0.0)}),
])
def test_later_slice_knobs_raise(setup, knob):
    """A misuse of the paged ladder or the front door raises the
    reference's ValueError, with the reference's message (the front
    door's: preemption without chunked prefill, max_queue < 1, a tenant
    quota of capacity < 1). The fleet's knobs, ported now, build on both
    engines: the single-device engine ignores ``shards``, as the
    reference's does, and honours ``defer_below_priority``."""
    jmodel, jparams, model, params, _, _ = setup
    try:
        JServingEngine(jmodel, jparams, JEngineConfig(**ECFG, **knob))
    except ValueError as want:
        with pytest.raises(ValueError) as got:
            ServingEngine(model, params, EngineConfig(**ECFG, **knob),
                          device="cpu")
        assert str(got.value) == str(want)
        return
    assert set(knob) <= {"shards", "defer_below_priority"}
    eng = ServingEngine(model, params, EngineConfig(**ECFG, **knob),
                        device="cpu")
    assert eng.cfg == EngineConfig(**ECFG, **knob)


def test_submit_accepts_deadline(setup):
    """``deadline_s`` is served (the front door): a deadline far longer
    than the run changes nothing, and both engines take it."""
    jmodel, jparams, model, params, _, _ = setup
    got = {}
    for eng, make in ((JServingEngine(jmodel, jparams, JEngineConfig(**ECFG)),
                       JRequest),
                      (ServingEngine(model, params, EngineConfig(**ECFG),
                                     device="cpu"), Request)):
        eng.submit(make(rid=0, prompt=[5, 6, 7], max_new_tokens=4,
                        deadline_s=3600.0))
        got[make] = [(r.tokens, r.finish_reason) for r in eng.run()]
        assert eng.stats()["deadline_cancelled"] == 0
    assert got[Request] == got[JRequest] and got[Request][0][1] == "length"


def test_engine_config_fields_match_reference():
    fields = [(f.name, f.default) for f in dataclasses.fields(EngineConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JEngineConfig)]
    assert fields == want


# ---------------------------------------------------------------- paged ladder
# The same comparison on each rung of the paged ladder. max_len 128 holds
# the trace's longest prompt plus its budget (the paged table has no ring
# eviction); the default page size 16 and equal-memory pool of 32 pages.
PAGED = dict(ECFG, max_len=128)
SHARED_PREFIX = 32                   # two whole pages of 16


def _shared_trace():
    """Page-aligned shared prefixes. A long-lived donor (rid 0) opens with
    a 32-token system prompt; three unrelated requests hold the other
    slots until every prompt ahead of them has prefilled, so the rest
    queue and are admitted against the donor's registered pages: one IS
    the system prompt (a whole-prompt share that recomputes its tail token
    through copy-on-write; first of its wave, so its copy runs before any
    decode chunk), five repeat the system prompt with suffixes, one
    shares the first page only."""
    rng = np.random.default_rng(12)
    system = rng.integers(2, 512, SHARED_PREFIX).tolist()
    trace = [(0, system + rng.integers(2, 512, 5).tolist(), 60)]
    trace += [(rid, rng.integers(2, 512, 7 + rid).tolist(), 24)
              for rid in (1, 2, 3)]
    trace.append((4, list(system), 6))
    for rid, n_suffix in zip(range(5, 10), [17, 9, 30, 1, 12]):
        trace.append((rid, system + rng.integers(2, 512, n_suffix).tolist(),
                      int(rng.integers(4, 12))))
    trace.append((10, system[:16] + rng.integers(2, 512, 11).tolist(), 5))
    return trace


def _assert_engines_agree(jeng, teng, want, got):
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
        assert got[rid].rejected == want[rid].rejected, rid
        assert got[rid].energy_j == pytest.approx(want[rid].energy_j,
                                                  rel=1e-12)
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key, val in js.items():
        if key.startswith(WALL_CLOCK):
            continue
        assert ts[key] == pytest.approx(val, rel=1e-12, abs=0.0), key
    assert teng.carbon_report() == jeng.carbon_report()
    assert teng.host_syncs == jeng.host_syncs


def _both(setup, ecfg, trace, eos):
    jmodel, jparams, model, params, _, _ = setup
    jeng = JServingEngine(jmodel, jparams, JEngineConfig(**ecfg))
    teng = ServingEngine(model, params, EngineConfig(**ecfg), device="cpu")
    want = _run(jeng, JRequest, trace, eos)
    got = _run(teng, Request, trace, eos)
    _assert_engines_agree(jeng, teng, want, got)
    return jeng, teng


def _assert_pool_clean(teng):
    alloc = {k: v[0] for k, v in teng.caches["paged"].items()}   # S = 1
    P = alloc["free"].shape[0]
    assert int(alloc["top"]) == P
    assert (alloc["tbl"] == -1).all() and (alloc["ref"] == 0).all()
    assert sorted(alloc["free"].tolist()) == list(range(P))
    assert teng.free_pages == teng.num_pages


@pytest.mark.parametrize("rung", [
    dict(paged=True),
    dict(paged=True, prefill_chunk=16),
    dict(paged=True, prefill_chunk=16, prefill_pack=2),
], ids=["paged", "chunk16", "chunk16_pack2"])
def test_paged_rungs_match_reference(setup, rung):
    _, _, _, _, trace, eos = setup
    _, teng = _both(setup, dict(PAGED, **rung), trace, eos)
    st = teng.stats()
    assert st["peak_pages_reserved"] > 0
    assert {r.finish_reason for r in teng.responses.values()} >= {"eos"}
    _assert_pool_clean(teng)


@pytest.mark.parametrize("pack", [1, 2])
def test_prefix_sharing_rung_matches_reference(setup, pack):
    _, _, _, _, _, eos = setup
    rung = dict(PAGED, paged=True, prefill_chunk=16, prefill_pack=pack,
                prefix_sharing=True)
    _, teng = _both(setup, rung, _shared_trace(), {})
    st = teng.stats()
    assert st["prefix_hit_tokens"] > 0 and st["prefix_shared_requests"] > 0
    _assert_pool_clean(teng)
    assert not teng._prefix_index and not teng._page_ref


@pytest.mark.parametrize("case", ["pool_pressure", "never_fits"])
def test_paged_admission_limits_match_reference(setup, case):
    """A tight pool makes requests wait for reclaimed pages; a request
    whose prompt + budget can never fit the table is rejected up front
    (the reference's tests/test_chunked_parity.py cases)."""
    rng = np.random.default_rng(3)
    if case == "pool_pressure":
        ecfg = dict(PAGED, max_len=64, paged=True, page_size=8,
                    prefill_chunk=8, num_pages=7)
        trace = [(i, rng.integers(2, 512, 10).tolist(), 8) for i in range(6)]
    else:
        ecfg = dict(PAGED, max_len=64, paged=True, page_size=8,
                    prefill_chunk=8)
        trace = [(0, list(range(1, 63)), 5), (1, [1, 2, 3], 5)]
    _, teng = _both(setup, ecfg, trace, {})
    if case == "pool_pressure":
        assert teng.stats()["peak_pages_reserved"] <= 7
    else:
        assert teng.responses[0].finish_reason == "rejected"
    _assert_pool_clean(teng)


# ----------------------------------------- whole-prompt shares (CoW edges)
# The reference's tests/test_prefix_sharing.py and test_chunked_parity.py
# cases at page 4 / chunk 8 on the smoke model.
PS, CH = 4, 8
COW = dict(ECFG, max_batch=2, max_len=64, sync_every=4, paged=True,
           page_size=PS, prefill_chunk=CH, prefix_sharing=True)


def _alloc(eng):
    a = {k: np.asarray(v) for k, v in eng.caches["paged"].items()}
    if isinstance(eng, ServingEngine):
        a = {k: v[0] for k, v in a.items()}      # the port's S = 1 axis
    top = int(a["top"])
    return a["tbl"], a["free"][:top], top, a["ref"]


def _pages(eng, pages):
    """K and V rows of physical ``pages`` in every layer, as numpy."""
    if isinstance(eng, JServingEngine):
        layers = jax.tree_util.tree_map(np.asarray, eng.caches["unit"]["0"])
        return [np.asarray(layers[n])[:, :, pages]
                for n in ("k_pages", "v_pages")]
    return [np.stack([layer[n][:, pages].numpy()
                      for layer in eng.caches["layers"]])
            for n in ("k_pages", "v_pages")]


def test_whole_prompt_share_copies_on_write(setup):
    """A follower whose prompt is 3 whole shared pages recomputes its last
    token into the shared tail page: copy-on-write gives it a fresh page
    first, the donor's page drops back to refcount 1 with its rows
    unchanged, and both engines hold the same allocator state at every
    step and the unshared engine's tokens."""
    jmodel, jparams, model, params, _, _ = setup
    prompt = np.random.default_rng(13).integers(2, 512, 3 * PS).tolist()
    donor = dict(rid=0, prompt=prompt, max_new_tokens=10)
    follower = dict(rid=1, prompt=list(prompt), max_new_tokens=4)
    ecfg = dict(COW, num_pages=8)
    engines = (JServingEngine(jmodel, jparams, JEngineConfig(**ecfg)),
               ServingEngine(model, params, EngineConfig(**ecfg),
                             device="cpu"))
    steps = []
    for eng, make in zip(engines, (JRequest, Request)):
        eng.submit(make(**donor))
        eng._admit()
        while eng._prefilling:
            eng._prefill_quantum()
        d_row = _alloc(eng)[0][0]
        tail = _pages(eng, d_row[2:3])
        eng.submit(make(**follower))
        eng._admit()
        tbl, _, _, ref = _alloc(eng)
        f_slot = eng.slot_rid.index(1)
        assert tbl[f_slot, :3].tolist() == d_row[:3].tolist()
        assert all(ref[p] == 2 for p in d_row[:3])
        assert eng._prefilling[0][0].prefill_pos == 3 * PS - 1
        adopted = _alloc(eng)
        eng._prefill_quantum()                  # the 1-token CoW chunk
        tbl, _, _, ref = _alloc(eng)
        assert tbl[f_slot, :2].tolist() == d_row[:2].tolist()
        assert tbl[f_slot, 2] != d_row[2], "tail page was not copied"
        assert ref[d_row[2]] == 1 and ref[tbl[f_slot, 2]] == 1
        for before, after in zip(tail, _pages(eng, d_row[2:3])):
            np.testing.assert_array_equal(after, before)   # donor unchanged
        copy = _pages(eng, tbl[f_slot, 2:3])
        for d, c in zip(tail, copy):            # rows the copy carried over
            np.testing.assert_array_equal(c[..., :PS - 1, :],
                                          d[..., :PS - 1, :])
        steps.append((adopted, _alloc(eng),
                      {r.rid: r.tokens for r in eng.run()}))
    (ja, jc, jtok), (ta, tc, ttok) = steps
    for j, t in ((ja, ta), (jc, tc)):
        for jx, tx in zip(j, t):
            np.testing.assert_array_equal(tx, jx)
    jm = JServingEngine(jmodel, jparams,
                        JEngineConfig(**dict(ecfg, prefix_sharing=False)))
    want = _run(jm, JRequest, [(d["rid"], d["prompt"], d["max_new_tokens"])
                               for d in (donor, follower)], {})
    assert ttok == jtok == {rid: r.tokens for rid, r in want.items()}
    _assert_pool_clean(engines[1])


class _IndexedPagesFrozen(ServingEngine):
    """The port's engine asserting, after every quantum, that no page in
    the prefix index changed since it was registered: an indexed page may
    be mapped by any adopter, so nothing may write it in place."""

    def _register_prefix(self, req, slot, row):
        super()._register_prefix(req, slot, row)
        self.frozen = getattr(self, "frozen", {})
        for p in self._page_key:
            self.frozen.setdefault(p, _pages(self, [p]))

    def step(self, max_steps=10_000):
        ran = super().step(max_steps)
        for p, rows in list(getattr(self, "frozen", {}).items()):
            if p not in self._page_key:
                del self.frozen[p]          # left the index: recyclable
                continue
            for before, now in zip(rows, _pages(self, [p])):
                np.testing.assert_array_equal(now, before, err_msg=str(p))
        return ran


def test_waiting_whole_prompt_adopters_leave_shared_pages_alone(
        setup, monkeypatch):
    """Two whole-prompt twins adopt a donor's pages while a long prompt
    holds the prefill queue, so they wait across decode chunks with their
    write cursors inside a shared page; then their copy-on-write chunks
    reach the packer, at most one per launch. The decode step's write of
    a slot parked mid-prefill must not land in that shared page: the
    port routes it to the trash page, every indexed page stays unchanged,
    and the tokens equal the unshared engine's. (The reference's sharing
    engine writes the parked slot's next row in place; ROADMAP Queue 3.)
    Every modeled number still equals the reference sharing engine's."""
    from repro_torch.serving import engine as port_engine
    jmodel, jparams, model, params, _, _ = setup
    rng = np.random.default_rng(21)
    donor_prompt = rng.integers(2, 512, 2 * PS).tolist()
    long_prompt = rng.integers(2, 512, 6 * CH).tolist()
    cow_rows = []
    real_pack = port_engine.pack_chunks

    def spy(prefilling, chunk, pack):
        out = real_pack(prefilling, chunk, pack)
        cow_rows.append(sum(1 for req, _, _, _ in out if req.cow_pending))
        return out

    monkeypatch.setattr(port_engine, "pack_chunks", spy)

    def drive(eng, make):
        eng.submit(make(rid=0, prompt=list(donor_prompt), max_new_tokens=6))
        eng.submit(make(rid=1, prompt=list(long_prompt), max_new_tokens=4))
        eng.run(max_steps=2)                # donor registered + decoding
        for rid in (2, 3):
            eng.submit(make(rid=rid, prompt=list(donor_prompt),
                            max_new_tokens=3))
        return {r.rid: r.tokens for r in eng.run()}

    for pack in (1, 3):
        ecfg = dict(COW, max_batch=4, prefill_pack=pack)
        cow_rows.clear()
        teng = _IndexedPagesFrozen(model, params, EngineConfig(**ecfg),
                                   device="cpu")
        got = drive(teng, Request)
        assert teng.prefix_shared_requests >= 2
        assert sum(cow_rows) >= 2 and max(cow_rows) <= 1
        unshared = JServingEngine(jmodel, jparams, JEngineConfig(
            **dict(ecfg, prefix_sharing=False)))
        assert got == drive(unshared, JRequest)
        jeng = JServingEngine(jmodel, jparams, JEngineConfig(**ecfg))
        drive(jeng, JRequest)
        js, ts = jeng.stats(), teng.stats()
        assert set(ts) == set(js)
        for key, val in js.items():
            if not key.startswith(WALL_CLOCK):
                assert ts[key] == pytest.approx(val, rel=1e-12, abs=0.0), key
        _assert_pool_clean(teng)


# ------------------------------------------------- zamba2: a hybrid model
# zamba2-7b smoke (two mamba2 blocks and the shared attention block) on the
# contiguous and paged rungs. Its blocks do not chunk, so chunked prefill
# and prefix sharing raise as in the reference.
ZARCH = "zamba2-7b"
ZECFG = dict(max_batch=4, max_len=128, prefill_min_bucket=8,
             profile="h100_sxm", region="QC")
ZRUNGS = pytest.mark.parametrize("rung", [{}, dict(paged=True)],
                                 ids=["contiguous", "paged"])


@pytest.fixture(scope="module")
def zamba():
    jmodel = JModel(jax_get_config(ZARCH, "smoke"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ZARCH, "smoke")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    return jmodel, jparams, Model(cfg, "cpu"), params, None, None


@ZRUNGS
def test_zamba2_engine_matches_reference(zamba, rung):
    """Every prompt is exactly its power-of-two bucket (8-64 tokens), so
    the reference's padded prefill holds no pad token and is right: the
    engines agree token for token, modeled J and gCO2 to 1e-12."""
    rng = np.random.default_rng(31)
    lens = [8, 16, 32, 64, 8, 16, 32, 8, 64, 16]
    trace = [(i, rng.integers(2, 512, L).tolist(), int(n))
             for i, (L, n) in enumerate(zip(lens, rng.integers(1, 20,
                                                               len(lens))))]
    _, teng = _both(zamba, dict(ZECFG, **rung), trace, {})
    assert teng.prefill_batches > 0
    if rung:
        _assert_pool_clean(teng)


_ORACLE = {}


def _exact_length_greedy(jmodel, jparams, prompt, n_new, max_len):
    """The reference MODEL served one request alone: prefill of the prompt
    at its exact length, then greedy ``decode_step``s (memoized: both
    rungs ask for the same requests)."""
    key = (tuple(prompt), n_new, max_len)
    if key not in _ORACLE:
        _ORACLE[key] = _greedy(jmodel, jparams, prompt, n_new, max_len)
    return _ORACLE[key]


def _greedy(jmodel, jparams, prompt, n_new, max_len):
    vocab = jmodel.cfg.vocab
    logits, cache = jmodel.prefill(jparams, jnp.asarray([prompt], jnp.int32),
                                   max_len=max_len)
    toks = [int(np.argmax(np.asarray(logits)[0, :vocab]))]
    step = jax.jit(jmodel.decode_step)
    while len(toks) < n_new:
        logits, cache = step(jparams, cache,
                             jnp.asarray([[toks[-1]]], jnp.int32))
        toks.append(int(np.argmax(np.asarray(logits)[0, :vocab])))
    return toks


@ZRUNGS
def test_zamba2_ragged_trace_matches_exact_length_model(zamba, rung):
    """Prompts of ragged lengths prefill right-padded to their buckets. The
    reference engine decodes such a row from a conv state holding pad
    tokens (ROADMAP Queue 3), so the oracle here is the reference model
    run per request at exact length; the port's engine equals it token
    for token."""
    jmodel, jparams, model, params, _, _ = zamba
    rng = np.random.default_rng(32)
    lens = [5, 13, 29, 3, 47, 21, 9, 60]
    trace = [(i, rng.integers(2, 512, L).tolist(), int(n))
             for i, (L, n) in enumerate(zip(lens, rng.integers(2, 12,
                                                               len(lens))))]
    teng = ServingEngine(model, params, EngineConfig(**ZECFG, **rung),
                         device="cpu")
    got = _run(teng, Request, trace, {})
    for rid, prompt, n in trace:
        assert got[rid].tokens == _exact_length_greedy(
            jmodel, jparams, prompt, n, ZECFG["max_len"]), rid
    if rung:
        _assert_pool_clean(teng)


@pytest.mark.parametrize("knob", [
    dict(paged=True, prefill_chunk=16),
    dict(paged=True, prefill_chunk=16, prefix_sharing=True),
    dict(paged=True, prefix_sharing=True),
], ids=["chunk", "chunk+sharing", "sharing"])
def test_zamba2_refuses_chunked_prefill_like_reference(zamba, knob):
    """Recurrent blocks need carried-state chunk resume: a chunked (or
    sharing) engine on Zamba2 raises at construction, with the
    reference's message."""
    jmodel, jparams, model, params, _, _ = zamba
    assert not model.supports_chunked_prefill
    assert model.supports_paged_decode and model.supports_padded_prefill
    with pytest.raises(ValueError) as want:
        JServingEngine(jmodel, jparams, JEngineConfig(**ZECFG, **knob))
    with pytest.raises(ValueError) as got:
        ServingEngine(model, params, EngineConfig(**ZECFG, **knob),
                      device="cpu")
    assert str(got.value) == str(want.value)
