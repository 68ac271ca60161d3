"""The port imports and renders without jax and without the JAX package."""

import subprocess
import sys

CODE = """
import sys
import path_tracer_tpu_torch as pt
from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution
scene = pt.load_scene("cornell", "scenes", "meshes")
done = pt.render(scene, RenderConfig(samples_per_pixel=4,
                 resolution=Resolution(8, 12)), device="cpu", out_dir=None,
                 verbose=False)
assert done.image.pixels.shape == (96, 3) and done.stats.num_rays > 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "path_tracer_tpu")]
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
