"""The port imports and renders (cornell through K1's plain version and
the wavefront integrator, mesh through the portal scheduler) and imports
its viewer app, raster preview and native runtime without jax, the JAX
package or an imaging library."""

import subprocess
import sys

from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

# The child pins torch to one intra-op thread, as tests/test_torch_host.py
# pins every Tier-1 worker: with a thread a core it competed with the six
# workers and took 71 s of its 120 s limit at the end of a Tier-1 run.
CODE = """
import sys
import torch
torch.set_num_threads(1)
import path_tracer_tpu_torch as pt
from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution
scene = pt.load_scene("cornell", "scenes", "meshes")
done = pt.render(scene, RenderConfig(samples_per_pixel=4,
                 resolution=Resolution(8, 12)), device="cpu", out_dir=None,
                 verbose=False)
assert done.image.pixels.shape == (96, 3) and done.stats.num_rays > 0
wave = pt.render(scene, RenderConfig(samples_per_pixel=4, backend="fast",
                 resolution=Resolution(8, 12)), device="cpu", out_dir=None,
                 verbose=False)
assert wave.stats.extra["route"] == "wavefront" and wave.stats.num_rays > 0
mesh = pt.load_scene("mesh", "scenes", "meshes")
done = pt.render(mesh, RenderConfig(samples_per_pixel=1,
                 resolution=Resolution(4, 6)), device="cpu", out_dir=None,
                 verbose=False)
assert done.stats.extra["route"] == "portal" and done.stats.num_rays > 0
import path_tracer_tpu_torch.cli
import path_tracer_tpu_torch.ops.kernels.build
import path_tracer_tpu_torch.ops.kernels.portal
import path_tracer_tpu_torch.render.drive
import path_tracer_tpu_torch.render.portal
import path_tracer_tpu_torch.viewer.app
import path_tracer_tpu_torch.viewer.raster
import path_tracer_tpu_torch.native
import path_tracer_tpu_torch.utils.profiling
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "path_tracer_tpu", "PIL")]
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_without_jax(repo_root):
    proc = subprocess.run(
        [sys.executable, "-c", CODE], cwd=repo_root, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
