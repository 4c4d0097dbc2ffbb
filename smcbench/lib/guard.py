"""What a run may load and where it may write its caches."""

from __future__ import annotations

import os
import sys
from pathlib import Path

# top-level module names that no benchmark run may hold: JAX and the JAX
# package this program was ported from (``particles_tpu_torch`` is the
# program; names are compared whole, never by prefix)
FORBIDDEN = ("jax", "jaxlib", "flax", "particles_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default: those in
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops & set(FORBIDDEN))


def cache_env(root):
    """Point the compilers' caches at fixed directories inside the checkout
    ``root`` (set before torch is imported).  The program's own nvcc and
    g++ libraries go to ``particles_tpu_torch/_build/`` in the checkout
    already."""
    cache = Path(root) / ".smcbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    return cache
