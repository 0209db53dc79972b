from swtpu_torch.ops.variants import (  # noqa: F401
    VARIANTS,
    best_engine,
    best_ends_engine,
    cached_build,
    get_variant,
    resolve_engine,
)
