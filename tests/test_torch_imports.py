"""The port stands alone: neither src/repro_torch nor chip_smoke.py imports
jax or the reference package, and chip_smoke.py fails without a card or
outside a checkout instead of printing a result."""

import ast
import pathlib
import runpy
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, repro_torch, repro_torch.api, repro_torch.api.cache, repro_torch.convert, "
        "repro_torch.kernels.dispatch_table, "
        "repro_torch.serve.reservoir, repro_torch.kernels.ops, "
        "repro_torch.kernels.flash_attention, repro_torch.configs, repro_torch.configs.archs, "
        "repro_torch.models, repro_torch.models.counting, repro_torch.models.moe, "
        "repro_torch.models.mamba, repro_torch.models.xlstm, repro_torch.serve.engine, "
        "repro_torch.launch.serve, repro_torch.tune, repro_torch.serve.fleet, "
        "repro_torch.api.sharded, repro_torch.distributed, repro_torch.distributed.collectives, "
        "repro_torch.optim, repro_torch.data, repro_torch.train, repro_torch.train.watchdog, "
        "repro_torch.launch.train, repro_torch.launch.steps, repro_torch.launch.mesh, "
        "repro_torch.launch.dryrun, repro_torch.launch.roofline, repro_torch.launch.costs, "
        "repro_torch.tree; "
        "assert len(repro_torch.configs.list_configs()) == 10; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
        "assert not bad, bad"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_alone_fails_without_result(tmp_path, capsys):
    """Without a card the script stops before it imports the port, so a
    copy alone in an empty directory exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    with pytest.raises(SystemExit) as exit_info:
        runpy.run_path(str(script), run_name="__main__")
    assert exit_info.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
