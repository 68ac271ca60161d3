"""Render configuration.

Counterpart of ``path_tracer_tpu.utils.config``. Defaults and validation
limits match the GUI: res_y default 300 (width = res_y*3/2), spp default
100, res_y in [1,2000], spp in [1,10000].

The device is not part of the configuration: ``render`` takes it as an
explicit argument. The JAX package's XLA-only knobs (``backend``,
``pixel_chunk``, ``f32_precision``) have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class Resolution:
    height: int = 300
    width: int = 450  # height * 3 / 2

    @staticmethod
    def from_height(res_y: int) -> "Resolution":
        return Resolution(height=res_y, width=res_y * 3 // 2)

    @property
    def num_pixels(self) -> int:
        return self.height * self.width


# Validation limits (main.rs:157-170)
RES_Y_RANGE = (1, 2000)
SPP_RANGE = (1, 10000)


@dataclass(frozen=True)
class RenderConfig:
    """Everything the renderer needs besides the scene and the device."""

    samples_per_pixel: int = 100
    resolution: Resolution = field(default_factory=Resolution)

    # Integrator constants (parity: mod.rs:28,661,676-683,737-758)
    max_depth: int = 12
    rr_start_depth: int = 5  # Russian roulette when new_depth > 5

    # RNG: the key of the counter-based generator (ops.rng)
    seed: int = 0
    # MOCK_RANDOM fixture and the literal estimator are wavefront-integrator
    # modes; render() raises NotImplementedError for them (ROADMAP Slice 1b)
    mock_random: bool = False
    estimator: str = "shipped"

    samples_per_pass: int = 0  # 0 = min(spp, 256)
    validate: bool = False  # enforce GUI ranges

    def validated(self) -> "RenderConfig":
        if self.estimator not in ("shipped", "literal"):
            raise ValueError(
                f"estimator must be 'shipped' or 'literal', got {self.estimator!r}"
            )
        if self.max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {self.max_depth}")
        if self.validate:
            if not RES_Y_RANGE[0] <= self.resolution.height <= RES_Y_RANGE[1]:
                raise ValueError(
                    f"res_y must be in {RES_Y_RANGE}, got {self.resolution.height}"
                )
            if not SPP_RANGE[0] <= self.samples_per_pixel <= SPP_RANGE[1]:
                raise ValueError(
                    f"spp must be in {SPP_RANGE}, got {self.samples_per_pixel}"
                )
        return self

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)
