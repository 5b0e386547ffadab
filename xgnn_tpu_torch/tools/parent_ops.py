"""Load another version's kernel wrappers beside this checkout's.

``load(root, "degree")`` imports ``ROOT/xgnn_tpu_torch/ops/degree.py`` (and
the ``_build.py`` beside it), and ``load(root, "parallel.exchange")``
``ROOT/xgnn_tpu_torch/parallel/exchange.py``, inside ROOT's package loaded
under a name of its own (its ``__init__`` not executed, so only the
modules a wrapper imports are loaded), so that a timing tool can call an
older version's wrapper, with its own C interface, in the same process as
this checkout's, in turns.  The older version builds its libraries into
``ROOT/build/xgnn_tpu_torch/``, as it does in its own checkout; unpack it
into a gitignored directory first, as in
``git archive <commit> | tar -x -C build/parent``.
"""

import importlib
import importlib.util
import sys
from pathlib import Path


def load(root, module: str):
    """The ``ops.<module>`` of the checkout at ``root``, or its
    ``<module>`` where that names a package (``parallel.exchange``)."""
    top = Path(root).resolve() / "xgnn_tpu_torch"
    dotted = module if "." in module else f"ops.{module}"
    if not (top / (dotted.replace(".", "/") + ".py")).exists():
        raise FileNotFoundError(f"no {dotted} under {top}")
    name = f"_xgnn_of_{abs(hash(str(top)))}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, top / "__init__.py", submodule_search_locations=[str(top)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg  # the package itself is not executed
    return importlib.import_module(f"{name}.{dotted}")
