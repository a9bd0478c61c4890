"""The port imports neither JAX, flax, the JAX package, pandas nor msgpack,
and matplotlib only inside functions.

`dlwpbench_tpu_torch` starts with `dlwpbench_tpu`: only the `_torch`
package itself is allowed.  pandas, msgpack and matplotlib are not on the
card's machine.  The check reads every import statement (and every
`importlib.import_module` / `__import__` of a literal name) in the port
and in `chip_smoke.py`, then imports the port's modules in a fresh
interpreter in which `jax`, `flax`, `dlwpbench_tpu`, `pandas`, `msgpack`
and `matplotlib` cannot be imported.
"""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "dlwpbench_tpu_torch")
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|pandas|msgpack|dlwpbench_tpu(?!_torch))(\.|$)")
MODULE_LEVEL_FORBIDDEN = re.compile(r"^matplotlib(\.|$)")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [name for name in _imported_names(path) if FORBIDDEN.match(name)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_matplotlib_only_inside_functions(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    top = [a.name for node in tree.body if isinstance(node, ast.Import) for a in node.names]
    top += [node.module for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.level == 0]
    bad = [name for name in top if MODULE_LEVEL_FORBIDDEN.match(name)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad} at module level"


def test_forbidden_pattern():
    assert FORBIDDEN.match("jax.numpy") and FORBIDDEN.match("flax")
    assert FORBIDDEN.match("msgpack") and not FORBIDDEN.match("msgpack_lite")
    assert FORBIDDEN.match("dlwpbench_tpu") and FORBIDDEN.match("dlwpbench_tpu.models")
    assert FORBIDDEN.match("pandas") and FORBIDDEN.match("pandas.core")
    assert not FORBIDDEN.match("dlwpbench_tpu_torch.models")
    assert not FORBIDDEN.match("jaxtyping_free")


def test_port_loads_without_jax():
    modules = sorted(
        "dlwpbench_tpu_torch." + os.path.relpath(p, PORT)[:-3].replace(os.sep, ".")
        for p in _port_files()[1:]
    )
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'dlwpbench_tpu', 'pandas', 'msgpack', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, chip_smoke, dlwpbench_tpu_torch.evaluate\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.replace('.__init__', ''))\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
