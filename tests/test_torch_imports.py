"""The port stands alone: no jax, no ml_dtypes and nothing of ``repro`` in
``src/repro_torch`` or ``chip_smoke.py``, checked in the source (AST) and
in a fresh interpreter; and ``chip_smoke.py`` refuses to run where it has no
card or no repository beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(ln, m) for ln, m in _imported_modules(tree) if _forbidden(m)]
    assert bad == [], f"{path}: imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(PORT).as_posix() for p in FILES[:-1]}
    assert {"kernels/fp4_matmul.py", "kernels/flash_attn.py",
            "kernels/ref.py", "kernels/nvfp4_quant.py", "kernels/ops.py",
            "serve/engine.py", "launch/serve.py", "convert.py",
            "checkpoint/ckpt.py", "train/trainer.py", "models/moe.py",
            "configs/codeqwen1p5_7b.py", "configs/qwen2p5_32b.py",
            "configs/llama3_405b.py", "configs/mixtral_8x7b.py",
            "configs/qwen3_moe_235b_a22b.py", "distributed/specs.py",
            "distributed/mesh.py", "distributed/sharding.py",
            "distributed/compression.py", "distributed/pipeline.py"} <= names
    assert _forbidden("repro.core") and _forbidden("jax.numpy")
    assert _forbidden("ml_dtypes")
    assert not _forbidden("repro_torch.core")


def test_launcher_import_pulls_in_no_jax_or_repro():
    code = ("import sys, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.checkpoint, "
            "repro_torch.models.moe, repro_torch.distributed.sharding, "
            "repro_torch.distributed.compression, "
            "repro_torch.distributed.pipeline, repro_torch.train.step\n"
            "from repro_torch.configs import ARCH_IDS, get_config\n"
            "[get_config(a) for a in ARCH_IDS]\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    """A directory holding only chip_smoke.py (no card here either): the
    script exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
