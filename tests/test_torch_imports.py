"""Import hygiene of the port: no JAX, nothing of the JAX package."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"] + [
    REPO / "scripts" / name
    for name in ("wkv6_strong_decay.py", "kernel_variants.py", "prefill_prediction.py",
                 "wkv6_bwd_conditioning.py", "wkv6_bwd_precision.py",
                 "mamba_bwd_conditioning.py", "mamba_bwd_phase.py", "sass_loops.py",
                 "flash_fwd_turns.py")] + [
    REPO / "examples" / name
    for name in ("quickstart_torch.py", "multimodel_serve_torch.py", "serve_batched_torch.py",
                 "train_lm_torch.py", "scope_pipeline_torch.py")]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = sorted({root for root in _imported_roots(path) if root in BANNED})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.runtime.planner, repro_torch.core, repro_torch.core.workloads, "
            "repro_torch.kernels.qmatmul.ops, repro_torch.api, repro_torch.serving, "
            "repro_torch.multimodel, repro_torch.obs, repro_torch.launch.train, "
            "repro_torch.runtime.train, repro_torch.runtime.compression, repro_torch.optim, "
            "repro_torch.ckpt, repro_torch.ft, repro_torch.data, repro_torch.launch.dryrun, "
            "repro_torch.launch.hlo_analysis, repro_torch.kernels.cost, repro_torch.core.energy, "
            "repro_torch.__main__, repro_torch.multimodel.cli, repro_torch.launch.mesh, "
            "repro_torch.runtime.collectives, repro_torch.runtime.sharding; "
            "from repro_torch import scope; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
