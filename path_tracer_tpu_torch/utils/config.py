"""Render configuration.

Counterpart of ``path_tracer_tpu.utils.config``. Defaults and validation
limits match the GUI: res_y default 300 (width = res_y*3/2), spp default
100, res_y in [1,2000], spp in [1,10000].

The device is not part of the configuration: ``render`` takes it as an
explicit argument. ``backend`` picks the wavefront integrator (``exact``,
``fast``; ``jnp`` means ``fast``) or the kernel routes (``auto``, ``mxu``,
``pallas``) on either device. ``f32_precision`` takes only ``"highest"``:
the fast form's matmuls stay float32 (no TF32), and the TPU's
reduced-precision matmul passes (``"high"``, ``"default"``) are not ported.
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
BACKENDS = ("auto", "jnp", "exact", "fast", "mxu", "pallas")


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
    # MOCK_RANDOM fixture (mod.rs:31-55); a wavefront-integrator mode, as
    # is the literal estimator: both switch a kernel route to "fast"
    mock_random: bool = False
    # "shipped": t > 1e-4 + departed-triangle exclusion; "literal": the
    # reference's t > 0 acceptance (mod.rs:592)
    estimator: str = "shipped"

    # Execution: "auto" | "mxu" | "pallas" (the kernel routes), "exact" |
    # "fast" | "jnp" (the wavefront integrator)
    backend: str = "auto"
    samples_per_pass: int = 0  # 0 = auto (per route)
    pixel_chunk: int = 0  # wavefront pixels per dispatch; 0 = auto
    f32_precision: str = "highest"  # the only value ported
    validate: bool = False  # enforce GUI ranges

    def validated(self) -> "RenderConfig":
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.f32_precision != "highest":
            raise ValueError(
                f"f32_precision {self.f32_precision!r}: only 'highest' is "
                "supported; the TPU's reduced-precision matmul passes are not "
                "ported (the fast form's matmuls stay float32, never TF32)")
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
