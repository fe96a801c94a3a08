"""The port stands alone: horovod_tpu_torch and chip_smoke.py import no
JAX, Flax, Optax or horovod_tpu module, and chip_smoke.py refuses to run
without a CUDA device or without the package."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "horovod_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "horovod_tpu")

IMPORT_ALL = """
import sys
import horovod_tpu_torch
import horovod_tpu_torch.benchmarks.lm_bench
import horovod_tpu_torch.models
import horovod_tpu_torch.ops.flash_attention
import horovod_tpu_torch.parallel
bad = sorted(m for m in sys.modules
             if m in {forbidden} or m.startswith({prefixes}))
print(bad)
sys.exit(1 if bad else 0)
""".format(forbidden=set(FORBIDDEN),
           prefixes=tuple(f"{name}." for name in FORBIDDEN))


def _env(**extra):
    env = dict(os.environ, **extra)
    env.pop("PYTHONPATH", None)
    return env


def test_import_pulls_in_no_jax_or_reference_module():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]))
def test_no_source_imports_jax_or_the_reference(path):
    roots = set(_imported_roots(REPO / path))
    assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))


def test_every_kernel_source_names_the_tpu_kernel_it_replaces():
    from horovod_tpu_torch.ops import _build

    for name, tpu_kernel in zip(_build.KERNELS, (
            "_fwd_kernel", "_bwd_dq_kernel", "_bwd_dkv_kernel")):
        text = (PACKAGE / "csrc" / f"{name}.cu").read_text()
        assert (f"Replaces: horovod_tpu/ops/pallas_attention.py:"
                f"{tpu_kernel}") in text
        assert "What bounds it on an H100" in text


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No card here: chip_smoke.py exits non-zero and prints no result,
    from the repository and from a directory that holds only the script."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (REPO, alone):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=_env(CUDA_VISIBLE_DEVICES=""),
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout
