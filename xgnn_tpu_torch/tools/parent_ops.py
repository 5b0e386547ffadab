"""Load another version's kernel wrappers beside this checkout's.

``load(root, "degree")`` imports ``ROOT/xgnn_tpu_torch/ops/degree.py`` (and
the ``_build.py`` beside it) as a package of its own, so that a timing tool
can call an older version's wrapper, with its own C interface, in the same
process as this checkout's, in turns.  The older version builds its
libraries into ``ROOT/build/xgnn_tpu_torch/``, as it does in its own
checkout; unpack it into a gitignored directory first, as in
``git archive <commit> | tar -x -C build/parent``.
"""

import importlib
import importlib.util
import sys
from pathlib import Path


def load(root, module: str):
    """The ``ops.<module>`` of the checkout at ``root``."""
    ops = Path(root).resolve() / "xgnn_tpu_torch" / "ops"
    if not (ops / f"{module}.py").exists():
        raise FileNotFoundError(f"no {module}.py under {ops}")
    name = f"_ops_of_{abs(hash(str(ops)))}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ops / "__init__.py", submodule_search_locations=[str(ops)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg  # the package itself is not executed
    return importlib.import_module(f"{name}.{module}")
