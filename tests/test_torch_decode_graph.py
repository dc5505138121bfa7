"""The fused decode step as one device program (``serving/graphs.py``) on
the CPU, where ``DecodeGraphs`` runs the same Python body on the same
fixed buffers with no capture and no replay.

* Addresses: every tensor the step reads (each cache leaf, the
  allocator's ``tbl``, ``free``, ``top`` and ``ref``, ``cur_tokens`` and
  the slot state) has the same ``data_ptr()`` at every chunk, through
  admission, chunked prefill, adoption of a whole shared prompt with its
  copy-on-write chunk, preemption and its ``disarm``, release, and chunks
  of several lengths; on a 2-shard fleet also through ``fail_shard``,
  ``rejoin`` and a migration. A captured graph reads these addresses at
  every replay.
* Tokens: the single engine (``llama3.2-1b`` smoke, float32, the paged +
  chunked + sharing + preemption rung) equals the JAX engine on the same
  parameters, token for token, every non-wall-clock ``stats()`` key to
  1e-12; the fleet equals the port's single engine, as
  ``tests/test_torch_fleet.py`` holds it.
* The allocator's in-place forms equal the allocating ones.
* Sampling at ``temperature > 0``: 20,480 tokens drawn over 20 chunks
  from fixed logits, their counts held to ``softmax(logits / T)`` by a
  chi-square test whose threshold is the 1 - 1e-4 quantile of chi-square
  with V - 1 degrees of freedom (a right sampler fails one seed in
  10,000; the seed is fixed).
* The decode cases of ``tests/test_decode_parity.py`` not mirrored
  elsewhere (``test_sliding_window``, ``test_mamba2_recurrent_decode``,
  ``test_rwkv6_state_decode``, ``test_zamba_shared_block``), through the
  port's fused step against the JAX model at the reference's tolerances:
  teacher-forced one-step chunks against the JAX model's full forward,
  and a greedy chunk against the JAX fused step, token for token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JModel
from repro.models import ModelConfig as JModelConfig
from repro.models import RWKVConfig as JRWKVConfig
from repro.models import SSMConfig as JSSMConfig
from repro.models.config import repeat_pattern as j_repeat_pattern
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import sampling as jsampling
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.models.config import (ModelConfig, RWKVConfig, SSMConfig,
                                       repeat_pattern)
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (EngineConfig, Request, ServingEngine,
                                 ShardedServingEngine)
from repro_torch.serving import graphs
from repro_torch.serving import paged as PG
from repro_torch.serving import sampling
from test_torch_cuda import CHUNKS, N_STEPS, SLOTS, chi_square, sample_counts

ARCH = "llama3.2-1b"
WALL_CLOCK = ("queue_wait_",)
RUNG = dict(max_batch=3, max_len=128, sync_every=4, paged=True, page_size=16,
            prefill_chunk=16, prefill_pack=2, prefix_sharing=True,
            preemption=True, profile="h100_sxm", region="QC")
FLEET = dict(max_batch=2, max_len=128, sync_every=4, paged=True, page_size=16,
             prefill_chunk=16, prefill_pack=2, prefix_sharing=True,
             shards=2, profile="h100_sxm", region="QC")


@pytest.fixture(scope="module")
def models():
    jmodel = JModel(jax_get_config(ARCH, "smoke"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, "smoke")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    return jmodel, jparams, Model(cfg, "cpu"), params


def _leaves(tree):
    return list(graphs._tensors(tree))


@pytest.fixture
def step_log(monkeypatch):
    """Every call of the fused step: (n_steps, the data_ptr of every
    tensor it reads)."""
    log = []
    real = sampling.fused_decode_steps

    def logged(model, params, caches, cur_tokens, state, generator, n_steps,
               *args, **kw):
        log.append((n_steps, tuple(t.data_ptr() for t in _leaves(caches)
                                   + [cur_tokens] + _leaves(state))))
        return real(model, params, caches, cur_tokens, state, generator,
                    n_steps, *args, **kw)

    monkeypatch.setattr(sampling, "fused_decode_steps", logged)
    return log


def _assert_fixed(log, lengths=2):
    assert len(log) > 1
    assert len({ptrs for _, ptrs in log}) == 1, "a step input moved"
    assert len({n for n, _ in log}) >= lengths, sorted({n for n, _ in log})


def _trace(vocab):
    """A 32-token system prompt and its sharers (one IS the system prompt:
    a whole-prompt adoption whose tail token is recomputed through a
    copy-on-write chunk, admitted first of its wave so the copy runs
    before any decode chunk), unrelated prompts, budgets of 3-43 so the
    last chunks are shorter than ``sync_every``; then a priority-1
    arrival that evicts a decoding slot."""
    rng = np.random.default_rng(21)
    system = rng.integers(2, vocab, 32).tolist()
    low = [(0, system + rng.integers(2, vocab, 5).tolist(), 43),
           (1, rng.integers(2, vocab, 9).tolist(), 6),
           (2, rng.integers(2, vocab, 20).tolist(), 10),
           (3, list(system), 6),
           (4, system + rng.integers(2, vocab, 17).tolist(), 9),
           (5, system[:16] + rng.integers(2, vocab, 11).tolist(), 3)]
    high = [(6, rng.integers(2, vocab, 7).tolist(), 5)]
    return low, high


def _drive(eng, make, vocab, warmup=3):
    low, high = _trace(vocab)
    for rid, prompt, n in low:
        eng.submit(make(rid=rid, prompt=prompt, max_new_tokens=n))
    for _ in range(warmup):
        eng.step()
    assert eng.decoding > 0
    for rid, prompt, n in high:
        eng.submit(make(rid=rid, prompt=prompt, max_new_tokens=n,
                        priority=1))
    return {r.rid: r for r in eng.run()}


def test_engine_step_reads_fixed_addresses_and_matches_jax(models, step_log):
    jmodel, jparams, model, params = models
    jeng = JServingEngine(jmodel, jparams, JEngineConfig(**RUNG))
    teng = ServingEngine(model, params, EngineConfig(**RUNG), device="cpu")
    want = _drive(jeng, JRequest, model.cfg.vocab)
    got = _drive(teng, Request, model.cfg.vocab)
    _assert_fixed(step_log)
    assert len(step_log) == teng.decode_chunks
    assert teng.preemption_count >= 1 and teng.prefix_hit_tokens > 0
    assert any(r.preemptions for r in got.values())
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
        assert got[rid].energy_j == pytest.approx(want[rid].energy_j,
                                                  rel=1e-12)
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key, val in js.items():
        if not key.startswith(WALL_CLOCK):
            assert ts[key] == pytest.approx(val, rel=1e-12, abs=0.0), key
    assert teng.carbon_report() == jeng.carbon_report()
    assert teng.free_pages == teng.num_pages and not teng._pins
    assert teng.graphs.captured == 0          # no capture on the CPU


def _fleet_reqs(vocab, seed, rids, lens, news):
    rng = np.random.default_rng(seed)
    system = rng.integers(2, vocab, 16).tolist()
    return [dict(rid=rid, prompt=(system if i % 2 else [])
                 + rng.integers(2, vocab, L).tolist(), max_new_tokens=n)
            for i, (rid, L, n) in enumerate(zip(rids, lens, news))]


def test_fleet_step_reads_fixed_addresses_and_matches_single(models,
                                                             step_log):
    _, _, model, params = models
    vocab = model.cfg.vocab
    eng = ShardedServingEngine(model, params, EngineConfig(**FLEET),
                               device="cpu")
    first = _fleet_reqs(vocab, 31, range(4), (5, 18, 9, 12), (14, 11, 9, 6))
    for r in first:
        eng.submit(Request(**r))
    for _ in range(3):
        eng.step()
    eng.fail_shard(0)                       # evacuates shard 0's requests
    eng.run()
    eng.rejoin(0)
    # three requests on four slots: the fuller shard drains into the
    # other's free slot (a live page migration)
    second = _fleet_reqs(vocab, 32, range(10, 13), (7, 13, 10), (22, 19, 17))
    for r in second:
        eng.submit(Request(**r))
    for _ in range(3):
        eng.step()
    src = max(range(eng.S), key=lambda s: sum(
        rid >= 0 for rid in eng.slot_rid[s]))
    eng.drain(src)
    eng.run()
    eng.audit()
    _assert_fixed(step_log)
    # the loss, then the drained shard handed to fail_shard
    assert eng.shard_down_events == 2 and eng.shard_rejoins == 1
    assert eng.migrations >= 1 and eng.shard_evacuated >= 1
    single = ServingEngine(model, params, EngineConfig(**dict(
        FLEET, shards=1, max_batch=4)), device="cpu")
    for r in first + second:
        single.submit(Request(**r))
    want = {r.rid: r.tokens for r in single.run()}
    got = {rid: r.tokens for rid, r in eng.responses.items()}
    assert got == want
    assert all(r.finished for r in eng.responses.values())


def test_decode_allocator_writes_in_place():
    """``alloc_decode_pages`` writes ``tbl``, ``top`` and ``ref`` where they
    lie and returns its argument; its values are the pure form's (a table
    pop on a copy); ``model_table`` and ``snapshot_cursors`` fill the
    buffers they are given with what they return fresh."""
    B, M, P, ps = 3, 4, 10, 4
    alloc = PG.init_allocator(B, M, P, "cpu")
    alloc = PG.alloc_prefill_pages(alloc, torch.tensor([0, 2]),
                                   torch.tensor([2, 1]))
    before = {k: v.clone() for k, v in alloc.items()}
    ptrs = {k: v.data_ptr() for k, v in alloc.items()}
    lengths = torch.tensor([8, 5, 4], dtype=torch.int32)
    active = torch.tensor([True, True, True])
    out = PG.alloc_decode_pages(alloc, lengths, active, ps)
    assert out is alloc
    assert {k: v.data_ptr() for k, v in alloc.items()} == ptrs
    # slots 0 and 2 start a page (8 and 4 cached): two pops, LIFO
    top0 = int(before["top"][0])
    popped = before["free"][0, top0 - 2:top0].flip(0)
    assert int(alloc["top"][0]) == top0 - 2
    assert alloc["tbl"][0, 0, 2] == popped[0] and \
        alloc["tbl"][0, 2, 1] == popped[1]
    assert (alloc["ref"][0, popped.long()] == 1).all()
    keep = before["tbl"].clone()
    keep[0, 0, 2], keep[0, 2, 1] = popped[0], popped[1]
    assert torch.equal(alloc["tbl"], keep)
    buf = torch.full((B, M), 7, dtype=torch.int32)
    for act in (None, torch.tensor([True, False, True])):
        fresh = PG.model_table(alloc, act)
        assert PG.model_table(alloc, act, buf) is buf
        assert torch.equal(buf, fresh)
    tree = {"t": torch.tensor([3, 1, 2], dtype=torch.int32),
            "layers": [{"pos_ids": torch.arange(6).reshape(3, 2),
                        "length": torch.tensor([1, 2, 3])}]}
    snap = PG.snapshot_cursors(tree)
    tree["t"] += 5
    tree["layers"][0]["length"] *= 2
    again = PG.snapshot_cursors(tree, snap)
    assert again is snap and torch.equal(snap["t"], tree["t"])
    assert torch.equal(snap["layers"][0]["length"],
                       tree["layers"][0]["length"])
    assert snap["t"].data_ptr() != tree["t"].data_ptr()


def test_recorded_launches_move_to_replays(monkeypatch):
    """A capture's counted launches leave the running count and come back
    once per replay."""
    from repro_torch.kernels import rmsnorm
    ops.reset_launches()
    rmsnorm.launches = 2
    with ops.recorded_launches() as rec:
        rmsnorm.launches += 5
    assert rmsnorm.launches == 2 and rec["rmsnorm"] == 5
    assert sum(rec.values()) == 5
    ops.add_launches(rec)
    ops.add_launches(rec)
    assert ops.launch_counts()["rmsnorm"] == 12
    ops.reset_launches()


# ------------------------------------------------------- sampling (T > 0)


def test_sampling_at_temperature_matches_softmax():
    counts, firsts, _ = sample_counts("cpu", torch.Generator().manual_seed(0))
    assert counts.sum() == CHUNKS * N_STEPS * SLOTS == 20_480
    stat, threshold = chi_square(counts)
    assert stat < threshold, (stat, threshold, counts.tolist())
    assert not torch.equal(firsts[0], firsts[1])


# ------------------------- tests/test_decode_parity.py through the fused step
BASE = dict(name="p", n_heads=4, n_kv_heads=4, d_model=64, d_ff=128,
            vocab=128, dtype="float32", vocab_pad_multiple=8)
MIRRORS = {
    "sliding_window": (dict(family="dense", n_layers=2, sliding_window=6),
                       ("dense",), 2, None, None, 3e-3),
    "mamba2_recurrent_decode": (dict(family="ssm", n_layers=3),
                                ("mamba2",), 3, "ssm", None, 1e-2),
    "rwkv6_state_decode": (dict(family="ssm", n_layers=3), ("rwkv6",), 3,
                           None, "rwkv", 1e-2),
    "zamba_shared_block": (dict(family="hybrid", n_layers=9),
                           ("mamba2", "mamba2", "shared"), 3, "ssm", None,
                           1e-2),
}


def _mirror(name, package):
    kw, unit, reps, ssm, rwkv, _ = MIRRORS[name]
    Config, Pattern, SSM, RWKV = (
        (JModelConfig, j_repeat_pattern, JSSMConfig, JRWKVConfig)
        if package == "jax" else
        (ModelConfig, repeat_pattern, SSMConfig, RWKVConfig))
    extra = {}
    if ssm:
        extra["ssm"] = SSM(state_dim=16, head_dim=16, chunk=4)
    if rwkv:
        extra["rwkv"] = RWKV(head_dim=16, decay_lora=8, mix_lora=8)
    return Config(**BASE, **kw, block_pattern=Pattern(unit, reps), **extra)


@pytest.mark.parametrize("name", sorted(MIRRORS))
def test_decode_parity_case_through_the_fused_step(name, monkeypatch):
    S, P, B = 12, 8, 2
    rtol = MIRRORS[name][-1]
    jm = JModel(_mirror(name, "jax"))
    jp = jm.init(jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, 128)
    full, _, _ = jm.forward(jp, tokens, {}, mode="train")
    cfg = _mirror(name, "torch")
    model = Model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                             "cpu")
    toks = torch.from_numpy(np.array(tokens, dtype=np.int32))

    def fresh(n_prompt):
        _, caches = model.prefill(params, toks[:, :n_prompt], max_len=S)
        cur = toks[:, n_prompt:n_prompt + 1].clone()
        state = sampling.init_slot_state(B, "cpu")
        state["active"].fill_(True)
        state["budget"].fill_(S)
        return caches, cur, state

    # teacher-forced: one-step chunks fed the reference's tokens, each
    # step's logits against the JAX model's full forward
    seen = []
    decode = model.decode_step

    def recorded(params, caches, tokens):
        logits, caches = decode(params, caches, tokens)
        seen.append(logits[:, :cfg.vocab].clone())
        return logits, caches

    monkeypatch.setattr(model, "decode_step", recorded)
    caches, cur, state = fresh(P)
    step = graphs.DecodeGraphs(model, params, cur, state, None)
    for i in range(S - P - 1):
        cur[:, 0] = toks[:, P + i]
        tok, _ = step.step(caches, n_steps=1, temperature=0.0)
        np.testing.assert_allclose(
            seen[-1].numpy(), np.asarray(full[:, P + i, :cfg.vocab]),
            rtol=rtol, atol=rtol, err_msg=f"step {i}")
        assert torch.equal(tok[0], seen[-1].argmax(-1).to(torch.int32))
    monkeypatch.undo()

    # greedy: one chunk of S - P - 1 steps from the last prompt token,
    # against the JAX fused step from the JAX prefill
    n = S - P - 1
    caches, cur, state = fresh(P - 1)
    _, jc = jm.prefill(jp, tokens[:, :P - 1], {}, max_len=S)
    tok, emit = graphs.DecodeGraphs(model, params, cur, state, None).step(
        caches, n_steps=n, temperature=0.0)
    jstate = {"active": jnp.ones((B,), bool),
              "budget": jnp.full((B,), S, jnp.int32),
              "eos": jnp.full((B,), -1, jnp.int32)}
    out = jsampling.fused_decode_steps(
        jm, jp, jc, tokens[:, P - 1:P].astype(jnp.int32), jstate,
        jax.random.PRNGKey(2), n_steps=n, temperature=0.0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(out[3]))
    assert bool(emit.all())
