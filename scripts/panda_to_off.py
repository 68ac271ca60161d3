#!/usr/bin/env python3
"""Pose the Franka Emika Panda arm's visual meshes and write them as one
OFF file a part, with a scene that stands the arm in the Cornell box.

    python3 scripts/panda_to_off.py [--assets DIR] [--template SCENE] [--out DIR]

The arm is the one Gymnasium-Robotics 1.4.1 ships for its Franka Kitchen
environment (``gymnasium_robotics/envs/assets/kitchen_franka/``, Apache-2.0,
from github.com/vikashplus/franka): the nine ``panda_viz`` geoms of
``franka_assets/chain.xml`` (links 0-7 and the hand, ``meshes/visual/*.stl``)
and the two fingers' ``finger_viz``, which ``franka_assets/assets.xml`` maps
to ``meshes/collision/finger.stl`` at scale (1.75, 1, 1.75): 11 meshes,
133,740 triangles. The pose is the environment's ``init_qpos[:9]``
(``envs/franka_kitchen/kitchen_env.py:246``: seven joints, two finger
slides).

- Body frames come from MuJoCo: ``kitchen_assets/kitchen_env_model.xml``
  with ``qpos[:9]`` set and ``mj_forward``. Each visual geom's pose in its
  body (``pos``, ``quat``) and its mesh's scale are read from ``chain.xml``
  and ``assets.xml``; the raw STL vertices (``stl_to_off.read_stl``) are
  scaled, put in the geom's frame and then in the body's, in float64.
- Each posed part is checked against MuJoCo's own ``geom_xpos`` and
  ``geom_xmat`` applied to its compiled vertices: every compiled vertex
  lies within 1e-6 of the arm's size of a posed one, and the other way
  round.
- The arm is turned from MuJoCo's z-up to the scene's y-up ((x, y, z) ->
  (x, z, -y)), scaled by ``SCALE``, stood on the box's floor (y = -2),
  centred in x, and its depth centred on z = 0 (where the mesh profile's
  ``mctri.off`` stands).
- A part's OFF file holds its vertices less its box's min corner, which the
  scene gives as the part's ``position`` (``MeshFile`` scale 1): the
  reference renderer's bounding sphere of a mesh (centre ``min + max *
  0.5``) then contains it, so the program tiles the scene and gates no
  triangle. Vertices are shared as ``stl_to_off.index`` shares them and
  written with ``%.9g``.
- The scene: the template's camera and every object of it but its
  ``MeshFile`` (the box's seven quads and its light), after the 11 parts,
  each with the template mesh's material.

The benchmark's ``panda_arm`` configuration was made with

    python3 scripts/panda_to_off.py --template bench_torch/configs/mesh13k/mesh13k.json \\
        --out bench_torch/configs/panda_arm

which writes ``meshes/panda_*.off`` and ``panda_arm.json`` there and prints
the inputs' sha256, the outputs' md5 and the placement as JSON.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import xml.etree.ElementTree as ET

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import stl_to_off  # noqa: E402

# kitchen_env.py:246, init_qpos[:9]: joints 1-7, then the two finger slides
INIT_QPOS = (1.48388023e-01, -1.76848573e00, 1.84390296e00, -2.47685760e00,
             2.60252026e-01, 7.12533105e-01, 1.59515394e00, 4.79267505e-02,
             3.71350919e-02)
SCALE = 6.0  # metres to scene units: the arm 4.03 wide in the 5.2-wide box
FLOOR_Y = -2.0
DEPTH_Z = 0.0
# MuJoCo's z-up to the scene's y-up: a rotation of -90 degrees about x
Z_UP_TO_Y_UP = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])
# a part's name from its body and mesh
PART_NAMES = {"hand_viz": "hand", "panda0_leftfinger": "finger_left",
              "panda0_rightfinger": "finger_right"}


def default_assets() -> str:
    spec = importlib.util.find_spec("gymnasium_robotics")
    if spec is None or not spec.submodule_search_locations:
        raise SystemExit("gymnasium_robotics is not installed: pass --assets")
    return os.path.join(list(spec.submodule_search_locations)[0], "envs",
                        "assets", "kitchen_franka")


def quat_matrix(q) -> np.ndarray:
    """The rotation of a (w, x, y, z) quaternion, normalized as MuJoCo does."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _floats(text, default):
    return np.array([float(v) for v in text.split()]) if text else np.array(default, float)


def visual_geoms(assets: str) -> list[dict]:
    """The ``panda_viz`` geoms of chain.xml in document order: body, mesh,
    STL path, mesh scale, and the geom's pos and quat in its body."""
    fr = os.path.join(assets, "franka_assets")
    meshes = {}
    for m in ET.parse(os.path.join(fr, "assets.xml")).getroot().iter("mesh"):
        meshes[m.get("name")] = (os.path.join(fr, "meshes", m.get("file")),
                                 _floats(m.get("scale"), (1, 1, 1)))
    out = []

    def walk(body):
        for child in body:
            if child.tag == "geom" and child.get("class") == "panda_viz":
                if child.get("euler") or child.get("axisangle"):
                    raise ValueError("a visual geom's pose other than pos/quat")
                path, scale = meshes[child.get("mesh")]
                out.append(dict(body=body.get("name"), mesh=child.get("mesh"),
                                stl=path, scale=scale,
                                pos=_floats(child.get("pos"), (0, 0, 0)),
                                quat=_floats(child.get("quat"), (1, 0, 0, 0))))
            elif child.tag == "body":
                walk(child)

    walk(ET.parse(os.path.join(fr, "chain.xml")).getroot())
    return out


def part_name(g: dict) -> str:
    return PART_NAMES.get(g["mesh"]) or PART_NAMES.get(g["body"]) or g["mesh"][:-4]


def pose(assets: str) -> tuple[list[dict], dict]:
    """The parts posed in MuJoCo's world frame (float64 vertices, shared as
    ``stl_to_off.index`` shares them, and faces), each checked against
    MuJoCo's compiled mesh, and the check's largest gap."""
    import mujoco
    from scipy.spatial import cKDTree

    model = mujoco.MjModel.from_xml_path(
        os.path.join(assets, "kitchen_assets", "kitchen_env_model.xml"))
    data = mujoco.MjData(model)
    data.qpos[:len(INIT_QPOS)] = INIT_QPOS
    mujoco.mj_forward(model, data)
    by_body = {}
    for gid in range(model.ngeom):
        if model.geom_type[gid] == mujoco.mjtGeom.mjGEOM_MESH and model.geom_group[gid] == 0:
            by_body.setdefault(model.body(model.geom_bodyid[gid]).name, []).append(gid)
    parts = []
    for g in visual_geoms(assets):
        with open(g["stl"], "rb") as fh:
            raw = fh.read()
        verts, faces = stl_to_off.index(stl_to_off.read_stl(raw))
        b = model.body(g["body"]).id
        local = quat_matrix(g["quat"]) @ (verts.astype(np.float64) * g["scale"]).T
        world = (data.xmat[b].reshape(3, 3) @ (local + g["pos"][:, None])).T + data.xpos[b]
        gid = next(i for i in by_body[g["body"]]
                   if model.mesh(model.geom_dataid[i]).name == g["mesh"])
        by_body[g["body"]].remove(gid)
        mid = model.geom_dataid[gid]
        adr, n = model.mesh_vertadr[mid], model.mesh_vertnum[mid]
        mj = (data.geom_xmat[gid].reshape(3, 3) @ model.mesh_vert[adr:adr + n].T.astype(
            np.float64)).T + data.geom_xpos[gid]
        gap = max(cKDTree(world).query(mj)[0].max(), cKDTree(mj).query(world)[0].max())
        parts.append(dict(name=part_name(g), body=g["body"], mesh=g["mesh"], stl=g["stl"],
                          sha256=hashlib.sha256(raw).hexdigest(), scale=g["scale"],
                          pos=g["pos"], quat=g["quat"], verts=world, faces=faces,
                          gap=float(gap)))
    lo = np.min([p["verts"].min(0) for p in parts], axis=0)
    hi = np.max([p["verts"].max(0) for p in parts], axis=0)
    size = float(np.linalg.norm(hi - lo))
    worst = max(p["gap"] for p in parts)
    if worst > 1e-6 * size:
        raise SystemExit(f"posed vertices part from MuJoCo's by {worst:.3g} m "
                         f"(arm diagonal {size:.4g} m)")
    return parts, dict(lo=lo, hi=hi, diagonal=size, gap=worst)


def place(parts: list[dict], box: dict) -> dict:
    """Turn, scale and move every part into the scene (in place); returns
    the arm's size in metres and the offset it was moved by."""
    lo = Z_UP_TO_Y_UP @ box["lo"]
    hi = Z_UP_TO_Y_UP @ box["hi"]
    lo, hi = np.minimum(lo, hi) * SCALE, np.maximum(lo, hi) * SCALE
    offset = np.array([-(lo[0] + hi[0]) / 2, FLOOR_Y - lo[1], DEPTH_Z - (lo[2] + hi[2]) / 2])
    for p in parts:
        p["verts"] = (Z_UP_TO_Y_UP @ p["verts"].T).T * SCALE + offset
    return dict(size_m=(hi - lo) / SCALE, size=hi - lo, offset=offset)


def write_scene(parts: list[dict], template: str, out: str) -> dict:
    """The OFF files and the scene file; returns each OFF file's md5 and
    position."""
    with open(template) as fh:
        tpl = json.load(fh)
    mesh = next(o for o in tpl["objects"] if "MeshFile" in o["type_"])
    os.makedirs(os.path.join(out, "meshes"), exist_ok=True)
    objects, written = [], {}
    for p in parts:
        corner = p["verts"].min(0)
        text = stl_to_off.write(p["verts"] - corner, p["faces"])
        rel = f"meshes/panda_{p['name']}.off"
        with open(os.path.join(out, rel), "w") as fh:
            fh.write(text)
        position = [float("%.9g" % c) for c in corner]
        objects.append({"type_": {"MeshFile": {"path": rel, "scale": 1.0}},
                        "position": position, "material": mesh["material"]})
        written[rel] = dict(md5=hashlib.md5(text.encode()).hexdigest(),
                            triangles=len(p["faces"]), position=position)
    objects += [o for o in tpl["objects"] if "MeshFile" not in o["type_"]]
    scene = {"id": "panda_arm", "objects": objects, "camera": tpl["camera"]}
    with open(os.path.join(out, "panda_arm.json"), "w") as fh:
        json.dump(scene, fh, indent=2)
        fh.write("\n")
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--assets", default=None,
                    help="gymnasium_robotics/envs/assets/kitchen_franka (default: installed)")
    ap.add_argument("--template", default="bench_torch/configs/mesh13k/mesh13k.json")
    ap.add_argument("--out", default="bench_torch/configs/panda_arm")
    args = ap.parse_args(argv)
    assets = args.assets or default_assets()
    parts, box = pose(assets)
    placed = place(parts, box)
    written = write_scene(parts, args.template, args.out)
    report = {
        "qpos": list(INIT_QPOS),
        "parts": [dict(name=p["name"], body=p["body"], mesh=p["mesh"],
                       stl=os.path.relpath(p["stl"], assets), sha256=p["sha256"],
                       scale=p["scale"].tolist(), pos=p["pos"].tolist(),
                       quat=p["quat"].tolist(), mujoco_gap_m=p["gap"]) for p in parts],
        "triangles": sum(len(p["faces"]) for p in parts),
        "arm_m": placed["size_m"].tolist(), "arm_scene": placed["size"].tolist(),
        "scale": SCALE, "offset": placed["offset"].tolist(),
        "mujoco_gap_m": box["gap"], "arm_diagonal_m": box["diagonal"],
        "off": written,
    }
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
