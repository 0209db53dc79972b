from swtpu_torch.ops.variants import (  # noqa: F401
    best_engine,
    best_ends_engine,
    cached_build,
    resolve_engine,
)
