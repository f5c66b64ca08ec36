"""The run's own check that nothing of JAX was loaded: every module in
``sys.modules`` is compared by its top-level name (the part before the
first dot) as a whole name. The program's package name begins with the
JAX package's, so a prefix test would refuse the program itself."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "video_style_transfer_tpu"})


def forbidden_modules(names=None):
    """The sorted top-level names among `names` (default: sys.modules)
    that are forbidden."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names}
                  & FORBIDDEN)
