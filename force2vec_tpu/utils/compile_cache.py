"""Where XLA's persistent compile cache lives.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, nothing is
set here.  Otherwise the cache goes to ``<checkout>/.jax_cache``: a fixed
path, because the path is part of what makes a later process find an entry.
"""

from __future__ import annotations

import os
from typing import Optional

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Point JAX's compile cache at ``<checkout>/.jax_cache`` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set.  Returns the directory it set,
    or None when it left the environment's choice in place."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
