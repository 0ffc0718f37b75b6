"""Persistent XLA compilation cache (compile once per shape across processes).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and
nothing here sets another directory. Otherwise the cache lives at a fixed
path inside the checkout (``.cache/xla``, listed in .gitignore) — fixed
because the path is part of what a later process looks up.

A CPU-only process gets no cache from here: reloading CPU AOT results
across runs has bitten for real — XLA's machine-feature check can reject
(or worse, wedge) an entry whose recorded target features don't match the
executing host's (cached cpu executables with ``+prefer-no-scatter`` hung
``np.asarray`` indefinitely on one host).
"""

import os

from .native_build import REPO_ROOT

_DONE = False

# compiles shorter than this are not written to the cache. On an H100 a
# per-bucket step compiles in about a second (a 2,000-read chip_smoke.py snp
# run took 6.3 s cold and 4.6 s once cached), so the old 5 s floor would
# have cached nothing; host-side helper jits compile well under a second.
MIN_COMPILE_SECS = 1.0


def compile_cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR, else ``<checkout>/.cache/xla``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".cache", "xla"))


def enable_compile_cache() -> None:
    """Idempotently point JAX at the on-disk compilation cache."""
    global _DONE
    if _DONE:
        return
    _DONE = True
    if os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = compile_cache_dir()
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECS)
