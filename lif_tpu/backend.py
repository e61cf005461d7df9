"""Platform choices, made in one place.

Every render tier runs a plain JAX implementation that XLA compiles for
any backend. One tier also has a hand-written kernel for NVIDIA GPUs
(the lateral snap-plane march, ops/sweep_march_gpu.py); `march_impl`
says which of the two a call takes, and `raycast_unroll` whether the
exact march unrolls its step loop. The compile cache location is set
here too, so scripts and apps share one rule for it.
"""

from __future__ import annotations

import os

import jax

__all__ = [
    "march_impl",
    "raycast_unroll",
    "configure_compile_cache",
    "CHECKOUT_CACHE_DIR",
]

# longest march a GPU build unrolls: the reference's production step
# count. Measured on an H100 (400 W limit) at 1280x800, 40 steps: 1.4 ms
# per frame unrolled vs 2.4 ms rolled, for 15 s vs 2 s of compile. The
# 640-step convergence oracle stays rolled (a 640-deep gather graph).
_UNROLL_MAX_STEPS = 40

# <checkout>/.jax_cache: a fixed path (the path is part of the cache key)
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def march_impl(platform: str | None = None) -> str:
    """Implementation of the lateral march on `platform` (default: the
    default backend): 'triton' for the Pallas kernel on a CUDA GPU,
    'xla' for the plain fori_loop twin everywhere else."""
    platform = platform or jax.default_backend()
    return "triton" if platform == "gpu" else "xla"


def raycast_unroll(num_steps: int, platform: str | None = None) -> bool:
    """Whether the exact ray march unrolls its `num_steps` loop: on a GPU
    for short marches only; never on the CPU, whose backend compiles an
    unrolled gather chain very slowly."""
    platform = platform or jax.default_backend()
    return platform == "gpu" and num_steps <= _UNROLL_MAX_STEPS


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at JAX_COMPILATION_CACHE_DIR
    when that is set, else at <checkout>/.jax_cache. Returns the path."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
