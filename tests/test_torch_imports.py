"""The port stands alone: no file of vlsa_tpu_torch/, nor chip_smoke.py,
host_ab.py or abmil_ab.py, imports JAX, Flax, Optax or anything of vlsa_tpu, nor a module that the
machine with the card lacks (transformers, ml_dtypes, regex, pandas,
sklearn, wandb, orbax, tensorstore, zstandard); PIL and h5py only when a
file needs them."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vlsa_tpu", "transformers", "ml_dtypes",
             "regex", "pandas", "sklearn", "wandb", "orbax", "tensorstore", "zstandard")


def _port_files():
    root = os.path.join(REPO, "vlsa_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".py")]
    return sorted(files) + [os.path.join(REPO, f)
                            for f in ("chip_smoke.py", "host_ab.py", "abmil_ab.py")]


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matches_exactly_or_by_prefix():
    assert _forbidden("vlsa_tpu") and _forbidden("vlsa_tpu.ops.coattn")
    assert _forbidden("jax.numpy") and not _forbidden("vlsa_tpu_torch.ops")
    assert not _forbidden("jaxtyping") and not _forbidden("regexp")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


LAZY = ("PIL", "h5py")  # the card's machine has neither: imported only to read such files


@pytest.mark.parametrize("module", ["vlsa_tpu_torch.data.extract", "vlsa_tpu_torch.runner.extract",
                                    "vlsa_tpu_torch.data.bags",
                                    "vlsa_tpu_torch.models.vision_tower"])
def test_extraction_imports_no_pil_or_h5py(module):
    """Importing the extraction path loads neither PIL nor h5py, nor JAX."""
    code = (f"import sys; import {module}; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {LAZY + ('jax',)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", f"{module} loads {out.stdout.strip()}"


LIFECYCLE = ("vlsa_tpu_torch.main", "vlsa_tpu_torch.eval", "vlsa_tpu_torch.runner.base",
             "vlsa_tpu_torch.runner.ckpt", "vlsa_tpu_torch.runner.orbax",
             "vlsa_tpu_torch.utils.zstd", "vlsa_tpu_torch.optim.optax_state",
             "vlsa_tpu_torch.runner.vlsa",
             "vlsa_tpu_torch.runner.sa", "vlsa_tpu_torch.optim.schedulers",
             "vlsa_tpu_torch.config_schema", "vlsa_tpu_torch.utils.observability",
             "vlsa_tpu_torch.utils.seed")


@pytest.mark.parametrize("module", LIFECYCLE)
def test_lifecycle_imports_load_no_forbidden_module(module):
    """Importing the run lifecycle loads nothing of FORBIDDEN, nor PyYAML
    (imported only to read or write a config file)."""
    code = (f"import sys; import {module}; "
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            f"{set(FORBIDDEN + ('yaml',))!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", f"{module} loads {out.stdout.strip()}"


INTERPRET = ("vlsa_tpu_torch.interpret", "vlsa_tpu_torch.interpret.shapley",
             "vlsa_tpu_torch.interpret.similarity", "vlsa_tpu_torch.interpret.cohort",
             "vlsa_tpu_torch.interpret.loader", "vlsa_tpu_torch.interpret.visualization")


@pytest.mark.parametrize("module", INTERPRET)
def test_interpret_imports_load_no_forbidden_module_nor_matplotlib(module):
    """Importing the interpretation modules loads nothing of FORBIDDEN, nor
    matplotlib or scipy (the plots import them inside their functions; the
    card's machine may have no matplotlib), nor PyYAML."""
    code = (f"import sys; import {module}; "
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            f"{set(FORBIDDEN + ('yaml', 'matplotlib', 'scipy'))!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", f"{module} loads {out.stdout.strip()}"
