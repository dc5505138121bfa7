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
    dict(paged=True), dict(prefill_chunk=16), dict(preemption=True),
    dict(prefix_sharing=True), dict(max_queue=4), dict(shards=2),
    dict(defer_below_priority=1), dict(tenant_quota={"*": (1.0, 0.0)}),
])
def test_later_slice_knobs_raise(setup, knob):
    _, _, model, params, _, _ = setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(model, params, EngineConfig(**ECFG, **knob),
                      device="cpu")


def test_engine_config_fields_match_reference():
    fields = [(f.name, f.default) for f in dataclasses.fields(EngineConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JEngineConfig)]
    assert fields == want
