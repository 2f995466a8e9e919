"""The run's own look for JAX: the top-level name of every loaded module
(the part before the first dot), compared whole."""

FORBIDDEN = ("jax", "jaxlib", "flax", "ppeadepth_tpu")


def jax_modules(modules) -> list:
    """Sorted top-level names in `modules` that are JAX or the JAX
    package (`ppeadepth_tpu_torch` is neither)."""
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))
