"""The port stands alone: no JAX, nothing of ``repro``, and no silent CPU.

  * every module of ``repro_torch`` and ``chip_smoke.py``'s imports load in
    a process where ``import jax`` fails;
  * no file of ``src/repro_torch`` or ``chip_smoke.py`` imports ``jax`` or
    ``repro`` (AST walk);
  * the entry points default to the card and raise without one.
"""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
import repro_torch.configs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)], "repro_torch."))


def _files():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def test_port_modules_found():
    mods = _port_modules()
    for want in ("repro_torch.bridge", "repro_torch.kernels.paged_attention.ops",
                 "repro_torch.serve.loop", "repro_torch.serve.__main__"):
        assert want in mods


def test_imports_without_jax():
    mods = [m for m in _port_modules() if not m.endswith("__main__")]
    smoke_imports = sorted({
        (n.module if isinstance(n, ast.ImportFrom) else a.name)
        for n in ast.walk(ast.parse(SMOKE.read_text()))
        if isinstance(n, (ast.Import, ast.ImportFrom))
        for a in (n.names if isinstance(n, ast.Import) else [None])})
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods + smoke_imports!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _bad_imports(source: str, name: str):
    bad = []
    for node in ast.walk(ast.parse(source, name)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{name}:{node.lineno}: {n}")
    return bad


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    assert path.exists()
    assert _bad_imports(path.read_text(), str(path.relative_to(ROOT))) == []


def test_ast_check_catches_a_bad_import():
    src = ("import os\nfrom repro.models import layers\nimport jax.numpy as jnp\n"
           "from . import sibling\nimport repro_torch\n")
    assert _bad_imports(src, "bad.py") == ["bad.py:2: repro.models", "bad.py:3: jax.numpy"]


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device=`` the entry points ask for the card and raise when
    it is absent; they never drop to the CPU."""
    from repro_torch.models.model import build_model, build_model_by_name
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import PagedServeLoop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = repro_torch.configs.get_arch("starcoder2-3b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    model = build_model_by_name("starcoder2-3b", reduced=True, device="cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        PagedServeLoop(model, params)
    assert repro_torch.resolve_device("cpu").type == "cpu"


def test_kernel_wrapper_refuses_non_cpu_without_kernel():
    """A tensor that is not on the CPU never takes the plain version."""
    from repro_torch.kernels.paged_attention import ops

    meta = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_decode_attention(meta, torch.empty(3, 4, 2, 8, device="meta"),
                                   torch.empty(3, 4, 2, 8, device="meta"),
                                   torch.empty(2, 2, 8, device="meta"),
                                   torch.empty(2, 2, 8, device="meta"),
                                   torch.empty(2, 1, dtype=torch.int32, device="meta"),
                                   torch.empty(2, dtype=torch.int32, device="meta"),
                                   active=torch.empty(2, dtype=torch.bool, device="meta"))
