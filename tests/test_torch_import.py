"""The port imports and renders (cornell through K1's plain version, mesh
through the v2 portal scheduler, its glue route and the v1 scheduler) and
imports its viewer app without jax, the JAX package or an imaging
library."""

import subprocess
import sys

from tests.test_torch_host import per_test_limit  # noqa: F401  (autouse)

CODE = """
import sys
import path_tracer_tpu_torch as pt
from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution
scene = pt.load_scene("cornell", "scenes", "meshes")
done = pt.render(scene, RenderConfig(samples_per_pixel=4,
                 resolution=Resolution(8, 12)), device="cpu", out_dir=None,
                 verbose=False)
assert done.image.pixels.shape == (96, 3) and done.stats.num_rays > 0
mesh = pt.load_scene("mesh", "scenes", "meshes")
done = pt.render(mesh, RenderConfig(samples_per_pixel=1,
                 resolution=Resolution(4, 6)), device="cpu", out_dir=None,
                 verbose=False)
assert done.stats.extra["route"] == "portal" and done.stats.num_rays > 0
import os
from path_tracer_tpu_torch.render import portal as rp
rp.POOL_RESOLVE = False
glue = pt.render(mesh, RenderConfig(samples_per_pixel=1,
                 resolution=Resolution(4, 6)), device="cpu", out_dir=None,
                 verbose=False)
rp.POOL_RESOLVE = True
os.environ["PT_TPU_PORTAL_V1"] = "1"
v1 = pt.render(mesh, RenderConfig(samples_per_pixel=1,
               resolution=Resolution(4, 6)), device="cpu", out_dir=None,
               verbose=False)
assert v1.stats.extra["portal_runner"] == "v1"
assert glue.stats.num_rays == v1.stats.num_rays == done.stats.num_rays
import path_tracer_tpu_torch.cli
import path_tracer_tpu_torch.ops.kernels.build
import path_tracer_tpu_torch.ops.kernels.portal
import path_tracer_tpu_torch.render.drive
import path_tracer_tpu_torch.render.portal
import path_tracer_tpu_torch.viewer.app
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
