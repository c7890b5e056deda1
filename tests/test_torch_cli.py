"""The port's front doors against the JAX package's: the CLI (``python -m
repro_torch``) and its legacy shim, the energy model, and the examples."""
import json
import pathlib
import re
import runpy
import sys

import pytest

from repro import scope as jscope
from repro.__main__ import main as jmain
from repro.core import energy as jenergy
from repro.multimodel.cli import main as jshim
from repro_torch import scope as tscope
from repro_torch.__main__ import main as tmain
from repro_torch.core import energy as tenergy
from repro_torch.multimodel.cli import main as tshim

REPO = pathlib.Path(__file__).resolve().parents[1]

# The host seconds a solve took: the only fields of the JSON that differ
# between two runs of one package, so they are left out of the comparison.
HOST_SECONDS = frozenset({"dse_s"})


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in HOST_SECONDS}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _json_of(main, argv, capsys):
    main(argv)
    return _strip(json.loads(capsys.readouterr().out))


CLI_CASES = {
    "solve-single": ["solve", "--mix", "alexnet", "--hw", "mcm16", "--json"],
    "solve-multimodel-baselines": ["solve", "--mix", "alexnet:1,resnet18:1", "--hw", "mcm16",
                                   "--baselines", "--json"],
    "serve-mix": ["serve", "--mix", "alexnet:1,resnet18:1", "--hw", "mcm16",
                  "--requests", "200", "--baselines", "--json"],
    "serve-llm": ["serve", "--llm", "granite-3-8b:1,gemma2-9b:1", "--llm-smoke", "--hw",
                  "mcm16", "--requests", "100", "--baselines", "--json"],
}


@pytest.mark.parametrize("argv", CLI_CASES.values(), ids=CLI_CASES.keys())
def test_cli_json_equals_the_reference(argv, capsys):
    assert _json_of(tmain, argv, capsys) == _json_of(jmain, argv, capsys)


def test_cli_text_and_strategies_equal_the_reference(capsys):
    for argv in (["strategies"], ["solve", "--mix", "alexnet", "--hw", "mcm16"]):
        tmain(argv)
        got = capsys.readouterr().out
        jmain(argv)
        want = capsys.readouterr().out
        # the solve's text names its host seconds once ("searched in X s")
        sec = re.compile(r"searched in [0-9.]+s")
        assert got and sec.sub("", got) == sec.sub("", want)


def test_legacy_shim_equals_the_reference(capsys):
    argv = ["--mix", "alexnet:1,resnet18:1", "--hw", "mcm16", "--json"]
    assert _json_of(tshim, argv, capsys) == _json_of(jshim, argv, capsys)


def _energies(scope, energy):
    prob = scope.problem("resnet18", "mcm16")
    cost = prob.options.make_cost(prob.package.resolve())
    graph = prob.workload.graph
    sched = scope.solve(prob.with_options(strategy="scope")).schedule
    return energy.schedule_energy(cost, graph, sched), energy.sequential_energy(cost, graph)


def test_energy_equals_the_reference():
    """``schedule_energy`` of a Scope schedule and ``sequential_energy``,
    field for field with ``==``, each package on its own solve of one
    problem."""
    for got, want in zip(_energies(tscope, tenergy), _energies(jscope, jenergy), strict=True):
        assert (got.mac, got.sram, got.nop, got.dram) == (want.mac, want.sram, want.nop,
                                                          want.dram)
        assert got.total == want.total and got.normalized() == want.normalized()
        assert got.total > 0


def _run(script, argv, capsys, monkeypatch):
    """stdout of ``examples/<script>`` run in this process with ``argv``."""
    monkeypatch.setattr(sys, "argv", [script, *argv])
    capsys.readouterr()
    runpy.run_path(str(REPO / "examples" / script), run_name="__main__")
    return capsys.readouterr().out


def test_quickstart_prints_what_the_reference_prints(capsys, monkeypatch):
    """Line for line, the search's host seconds left out."""
    sec = re.compile(r"searched in [0-9.]+s")
    got = _run("quickstart_torch.py", [], capsys, monkeypatch)
    assert got and sec.sub("", got) == sec.sub("", _run("quickstart.py", [], capsys, monkeypatch))


@pytest.mark.parametrize("script,args", [
    ("serve_batched_torch.py", []),
    # 30 steps of 32 x 8 tokens, where the example's own check (a loss drop
    # of more than 1 nat) holds on the CPU: 8.739 -> 6.816
    ("train_lm_torch.py", ["--steps", "30", "--batch", "32", "--seq", "8"]),
    # 8 gloo ranks on the CPU; the example's own check is the reference's 2e-3
    ("scope_pipeline_torch.py", []),
], ids=["serve_batched", "train_lm", "scope_pipeline"])
def test_model_examples_run_on_the_cpu(script, args, capsys, monkeypatch):
    out = _run(script, ["--device", "cpu", *args], capsys, monkeypatch)
    assert out and "nan" not in out.lower()
