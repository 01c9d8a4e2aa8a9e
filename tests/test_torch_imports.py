"""The port stands alone: importing every ``repro_torch`` module loads no
JAX and nothing of the reference package ``repro``, and no source line of
the port or of ``chip_smoke.py`` imports either."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.trainer" in res["modules"]
    for mod in ("aggregate", "update_mlp", "ops", "layout", "build",
                "flash_attention", "wkv6"):
        assert f"repro_torch.kernels.{mod}" in res["modules"]
    for mod in ("nn.mamba2", "models.zamba2", "configs.zamba2_2p7b"):
        assert f"repro_torch.{mod}" in res["modules"]
    assert res["bad"] == []


# `import jax`, `from jax...`, `import repro` / `import repro.x`,
# `from repro import` / `from repro.x import` — but not `repro_torch`
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")


def test_no_source_line_imports_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offending = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
                 for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if _IMPORT.match(line)]
    assert offending == []


def test_the_scan_tells_the_port_from_the_reference():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.gnn import models", "import repro",
                 "  from repro import x"):
        assert _IMPORT.match(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "from repro_torch import jax_free", "import jaxtyping"):
        assert not _IMPORT.match(line), line
