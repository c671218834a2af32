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

import numpy as np
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
                 "repro_torch.serve.loop", "repro_torch.serve.__main__",
                 "repro_torch.data.synthetic", "repro_torch.data.partition",
                 "repro_torch.data.device", "repro_torch.metrics.logger",
                 "repro_torch.configs.svm_mnist", "repro_torch.configs.cnn_mnist",
                 "repro_torch.configs.cnn_cifar10", "repro_torch.core.tree",
                 "repro_torch.kernels.vecavg.ref", "repro_torch.kernels.vecavg.ops",
                 "repro_torch.models.simple", "repro_torch.core.strategy",
                 "repro_torch.core.fedveca", "repro_torch.core.controller",
                 "repro_torch.core.engine", "repro_torch.core.driver",
                 "repro_torch.fed.simulator", "repro_torch.fed.__main__",
                 "repro_torch.kernels.flash_attention.ref",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.rmsnorm.ref", "repro_torch.kernels.rmsnorm.ops",
                 "repro_torch.checkpoint.io", "repro_torch.fed.train_lm",
                 "repro_torch.models.moe", "repro_torch.models.ssm",
                 "repro_torch.models.xlstm", "repro_torch.optim.optimizers",
                 "repro_torch.models.encdec", "repro_torch.configs.phi_3_vision_4_2b",
                 "repro_torch.configs.whisper_medium", "repro_torch.core.wire",
                 "repro_torch.core.buffered", "repro_torch.launch.mesh",
                 "repro_torch.launch.train", "repro_torch.sharding.api",
                 "repro_torch.sharding.partition", "repro_torch.train.steps",
                 "repro_torch.launch.dryrun", "repro_torch.launch.perf",
                 "repro_torch.analysis.sanitize"):
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
    from repro_torch.core.driver import make_dataset_evaluator
    from repro_torch.data import synthetic
    from repro_torch.data.device import DeviceShards, format_batch, host_stacked_batches
    from repro_torch.launch.mesh import make_federated_mesh
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.model import build_model, build_model_by_name
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import PagedServeLoop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = [synthetic.make_classification(8, (3,), 2, seed=i) for i in range(2)]
    for call in (lambda: DeviceShards.from_datasets(ds),
                 lambda: host_stacked_batches(ds, np.random.default_rng(0), 2, 2),
                 lambda: format_batch(ds[0].x, ds[0].y),
                 lambda: make_dataset_evaluator(lambda p, b: (0.0, {}), ds[0]),
                 lambda: make_federated_mesh(),
                 lambda: train_main(["--arch", "starcoder2-3b", "--reduced", "--rounds", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert DeviceShards.from_datasets(ds, device="cpu").device.type == "cpu"
    assert format_batch(ds[0].x, ds[0].y, device="cpu")["x"].device.type == "cpu"
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


def test_state_helpers_default_to_cuda(monkeypatch):
    """The recurrent state and RoPE helpers took ``device=None`` to mean the
    CPU; like the entry points they now ask for the card and raise without
    one, and build on the CPU only when asked."""
    from repro_torch.models import encdec, layers, ssm, xlstm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = repro_torch.configs.get_arch("xlstm-1.3b").reduced()
    hyb = repro_torch.configs.get_arch("hymba-1.5b").reduced()
    calls = [lambda **kw: xlstm.init_mlstm_state(cfg, 1, cfg.d_model, **kw),
             lambda **kw: xlstm.init_slstm_state(cfg, 1, cfg.d_model, **kw),
             lambda **kw: ssm.init_ssm_state(hyb, 1, hyb.d_model, **kw),
             lambda **kw: layers.rope_freqs(32, 1e4, **kw),
             lambda **kw: encdec.init_params(
                 repro_torch.configs.get_arch("whisper-medium").reduced(), **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
        out = call(device="cpu")
        leaves = out.values() if isinstance(out, dict) else (
            out if isinstance(out, tuple) else (out,))
        assert all(t.device.type == "cpu" for t in leaves)


def test_kernel_wrapper_refuses_non_cpu_without_kernel():
    """A tensor on a device the port has no kernel for (neither the CPU, nor
    CUDA, nor ``meta``) never takes the plain version: every wrapper
    raises. ``meta`` (the dry run) takes the plain version for its shapes
    and counts what the card would launch in ``meta_launches`` alone."""
    from _elsewhere import Elsewhere
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.vecavg import ops as va

    E, i32 = Elsewhere, torch.int32
    calls = {
        "paged_decode": lambda: ops.paged_decode_attention(
            E(2, 4, 8), E(3, 4, 2, 8), E(3, 4, 2, 8), E(2, 2, 8), E(2, 2, 8), E(2, 1, dtype=i32),
            E(2, dtype=i32), active=E(2, dtype=torch.bool)),
        "paged_insert": lambda: ops.paged_insert(E(1, 3, 4, 2, 8), E(1, 3, 4, 2, 8),
                                                 E(1, 1, 4, 2, 8), E(1, 1, 4, 2, 8),
                                                 E(1, dtype=i32)),
        "vecavg": lambda: va.vecavg(E(2, 5), E(2), 1.0),
        "vecavg_tree": lambda: va.vecavg_tree({"a": E(2, 5)}, E(2), 1.0),
        "rmsnorm": lambda: rn.RMSNorm.forward(E(4, 8), E(8), 1, 1e-6),
        "flash": lambda: fa._FlashAttention.forward(E(1, 4, 2, 16), E(1, 4, 2, 16),
                                                    E(1, 4, 2, 16), True, 0, 0),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="no kernel for xpu"):
            call()
    for mod in (ops, fa, rn, va):
        mod.reset_launches()
    m = dict(device="meta")
    out = ops.paged_decode_attention(
        torch.empty(2, 4, 8, **m), torch.empty(3, 4, 2, 8, **m), torch.empty(3, 4, 2, 8, **m),
        torch.empty(2, 2, 8, **m), torch.empty(2, 2, 8, **m),
        torch.empty(2, 1, dtype=i32, **m), torch.empty(2, dtype=i32, **m),
        active=torch.empty(2, dtype=torch.bool, **m))
    assert out.is_meta and out.shape == (2, 4, 8)
    assert rn.rmsnorm(torch.empty(3, 8, **m), torch.empty(8, **m)).is_meta
    assert fa.flash_attention(*(torch.empty(1, 4, 2, 16, **m) for _ in range(3))).is_meta
    dw, sqn = va.vecavg_tree({"a": torch.empty(2, 5, **m)}, torch.empty(2, **m), 1.0)
    assert dw["a"].shape == (5,) and sqn.shape == (2,)
    assert (ops.meta_launches["paged_decode"], rn.meta_launches["rmsnorm"],
            fa.meta_launches["flash_attention"], va.meta_launches["vecavg"]) == (1, 1, 1, 1)
    assert ops.launches["paged_decode"] == rn.launches["rmsnorm"] == 0
    assert fa.launches["flash_attention"] == va.launches["vecavg"] == 0
