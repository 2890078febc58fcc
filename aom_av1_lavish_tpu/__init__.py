"""aom_av1_lavish_tpu — an AV1 encode/decode framework on JAX.

A re-design of the capabilities of aom-av1-lavish (libaom + psy tuning)
for an accelerator: JAX/XLA for the compute graph, Pallas for hot
kernels, jax.sharding for tile/frame parallelism, and a host-side
runtime for bitstream serialization and orchestration.

Subpackages
-----------
bitstream : entropy coding (multi-symbol range coder), OBU framing,
            sequence/frame headers, CDF contexts.
ops       : batched device kernels — transforms, quantization,
            intra/inter prediction, SAD/variance, in-loop filters.
models    : encoder/decoder pipelines ("model families"): all-intra
            lossless, all-intra lossy, inter/GOP, realtime.
parallel  : device-mesh sharding of tiles / superblock wavefronts /
            GOP frame-parallelism.
utils     : container I/O (y4m, IVF), image types, bit I/O.
runtime   : host-side orchestration, native (C) fast paths.
"""

import os as _os

__version__ = "0.1.0"

#: the default persistent compile cache: <checkout>/.jax_cache
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ) -> str | None:
    """Where this process keeps XLA's persistent compile cache.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins:
    the code then sets no other.  A process pinned to the CPU
    (JAX_PLATFORMS=cpu, as the tests are) keeps none, because CPU
    entries embed the host's machine features and must not travel with
    the checkout.  Otherwise the cache is DEFAULT_CACHE_DIR."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        return None
    return DEFAULT_CACHE_DIR


def _enable_compile_cache():
    path = compile_cache_dir(_os.environ)
    if path is None:
        return
    import jax
    _os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compile_cache()
