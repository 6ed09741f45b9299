"""Device-memory budget heuristic (single source of truth).

Both the single-chip index (`index/service.py`) and the mesh layout
resolver (`parallel/sharded.py`) size their resident/scratch device-memory budgets
from the device's reported free memory.  The constants (fraction of free,
fallback for backends without memory stats, absolute floor) were
calibrated together — owning them here keeps the single-chip and mesh
"auto" decisions in lockstep when they are re-tuned.
"""

from __future__ import annotations


def free_memory_budget(numerator: int, denominator: int, fallback: int,
                       floor: int = 256 << 20, device=None) -> int:
    """``max(free * numerator // denominator, floor)`` where ``free`` =
    bytes_limit − bytes_in_use of ``device`` (default: first local device);
    ``fallback`` when the backend reports no memory stats (host CPU)."""
    budget = fallback
    try:
        if device is None:
            import jax
            device = jax.local_devices()[0]
        stats = device.memory_stats()
        if stats and stats.get("bytes_limit"):
            free = int(stats["bytes_limit"]) \
                - int(stats.get("bytes_in_use", 0))
            budget = max(free * numerator // denominator, floor)
    except Exception:
        pass
    return budget
