"""Central JAX runtime configuration: the persistent compilation cache.

Every compiled (panel shape, tile size) program is kept on disk so that a
second process with the same panel skips the compile.  The directory is
`JAX_COMPILATION_CACHE_DIR` when that is set, and otherwise one fixed path
inside the checkout, `<repo>/.jax_cache/`: the path is part of the cache
key, so a directory that moves never hits.
"""

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")

_configured = False


def cache_dir():
    """The directory the program's compile cache lives in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def configure():
    global _configured
    if _configured:
        return
    _configured = True
    import jax

    jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
