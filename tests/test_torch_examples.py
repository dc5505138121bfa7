"""The port's examples against the JAX package's, on the CPU:
``examples/quickstart_torch.py`` and ``examples/serve_e2e_torch.py
--requests 4`` with ``--device cpu`` on the JAX examples' parameters
(``models/convert.params_from_jax``) print the JAX examples' output, with
every modeled ``stats()`` figure of each engine to 1e-12;
``examples/carbon_planner_torch.py`` prints ``examples/carbon_planner.py``'s
output exactly. The three import neither JAX nor the JAX package, and run
as scripts with both blocked."""
import contextlib
import importlib.util
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax

from repro_torch.models.convert import params_from_jax
from test_torch_imports import FORBIDDEN

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
PORTED = ("quickstart", "serve_e2e", "carbon_planner")
WALL_CLOCK = ("queue_wait_",)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return out.getvalue(), result


def _run_jax(name, monkeypatch, argv=()):
    """The JAX example's ``main()`` with its engines recorded: (printed
    text, [(model, params, engine)])."""
    mod = _load(name)
    seen = []

    class Recorded(mod.ServingEngine):
        def __init__(self, model, params, cfg):
            super().__init__(model, params, cfg)
            seen.append((model, params, self))

    monkeypatch.setattr(mod, "ServingEngine", Recorded)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    text, _ = _printed(mod.main)
    return text, seen


def _port_params(model, jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           model.cfg, "cpu")


def _same_stats(jeng, teng):
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key, val in js.items():
        if not key.startswith(WALL_CLOCK):
            assert ts[key] == pytest.approx(val, rel=1e-12, abs=0.0), key
    assert teng.carbon_report() == jeng.carbon_report()


def test_quickstart_prints_the_jax_examples_figures(monkeypatch):
    want, seen = _run_jax("quickstart", monkeypatch)
    (_, jparams, jeng), = seen
    mod = _load("quickstart_torch")
    model, _ = mod.build_model("cpu")
    engine, responses = mod.serve(model, _port_params(model, jparams))
    got, _ = _printed(mod.report, engine, responses)
    assert got == want
    _same_stats(jeng, engine)
    for r in responses:
        assert r.tokens == jeng.responses[r.rid].tokens, r.rid


def test_serve_e2e_prints_the_jax_examples_figures(monkeypatch):
    want, seen = _run_jax("serve_e2e", monkeypatch, ("--requests", "4"))
    assert len(seen) == 4
    mod = _load("serve_e2e_torch")
    model, _ = mod.build_model("cpu")
    params = _port_params(model, seen[0][1])
    got, results = _printed(mod.run, model, params, 4, 32)
    text, _ = _printed(mod.compare, results)
    assert got + text == want
    assert [r[:2] for r in results] == [s[:2] for s in mod.SCENARIOS]
    for (_, _, jeng), (_, _, _, teng) in zip(seen, results):
        _same_stats(jeng, teng)


def test_carbon_planner_prints_the_jax_examples_output():
    want, _ = _printed(_load("carbon_planner").main)
    got, _ = _printed(_load("carbon_planner_torch").main)
    assert got == want


@pytest.mark.parametrize("name", PORTED)
def test_example_imports_neither_jax_nor_the_reference(name):
    path = EXAMPLES / f"{name}_torch.py"
    assert not FORBIDDEN.findall(path.read_text())
    # run as a script with both blocked: the planner whole, the serving
    # examples as far as their model and weights (a few steps on the CPU)
    call = ("mod.main()" if name == "carbon_planner" else
            "mod.build_model('cpu')")
    code = ("import sys, importlib.util\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            f"{call}\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin"}, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stderr
