#!/usr/bin/env python3
"""A static count of K1's SASS by part, and the issue estimate it gives.

Builds ``csrc/trace_regen.cu`` of a checkout (this one, or ``--root DIR``,
e.g. the parent commit unpacked into a git-ignored directory) with the
production flags plus ``-lineinfo``, disassembles the kernel
(``nvdisasm --print-line-info-inline``) and
gives each instruction to a part of the kernel by the source line it came
from, walking out of inlined functions where needed:

  scan-setup   m = o x d and the scan's initial state, once a segment
  scan-loop    the per-primitive compare, select and loop count
  scan-sphere  one sphere test (executed once per sphere a segment)
  scan-quad    one triangle or quad test
  scan-gate    a gated row's bounding-sphere test (gate_hit; cornell has
               none, so its code is skipped there)
  hit          the hit-row read, hit point and normal, the state update
  shade-common Russian roulette, emission, the throughput update
  shade-diffuse, shade-specular (mirror or refract), shade-mirror,
  shade-refract  shading's branches
  regen        a fresh camera ray and its two draws
  draws        the four per-segment draws
  loop         the rest of the sample loop
  setup        once a thread (the pixel, its key, the stores)
  rare         lines marked "sass-rare" (a fallback cornell never takes)
  out-of-line  subroutines with no line in the repo's sources (the slow
               paths of IEEE division and square root)
  no-line      instructions without line information

For each part it prints the instructions, the loads among them (LDS, LDC,
ULDC, LDG, LDL), the MUFU instructions, and the instructions of CUDA's
math library (the IEEE fix-up sequences and sincosf) and slow-path calls.
The production build's SASS (no -lineinfo) is compared with the counted
one. Registers, stack frame and spills come from ``-Xptxas -v``.

With the coherence model (scripts/k1_coherence.py) the parts weigh into
the instructions a warp issues a step: every part once, the scan's parts
once per primitive of their kind, each branch by the share of warp-steps
that run it. Over the run's warp-steps and 132 SMs x 4 schedulers, one
warp-instruction a clock each, that gives an issue estimate: a static
count weighed by a model, not a lower bound (it misses slow paths that
run and counts inline code that does not):

  python3 scripts/k1_sass.py [--root DIR] [--model model.json]
      [--clock-mhz 1980]

Runs where nvcc is (the card's machine); prints one JSON object.
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from path_tracer_tpu_torch.ops.kernels import build as kbuild  # noqa: E402

CSRC = os.path.join("path_tracer_tpu_torch", "csrc")
SMS, SCHEDULERS = 132, 4
PARTS = ("scan-setup", "scan-loop", "scan-sphere", "scan-quad", "scan-gate",
         "hit",
         "shade-common", "shade-diffuse", "shade-specular", "shade-mirror",
         "shade-refract", "regen", "draws", "loop", "setup", "rare",
         "out-of-line", "no-line")
# function -> part, for the functions of the sources
FUNCTIONS = {
    "gate_hit": "scan-gate", "prim_scan": "scan-loop",
    "scan_split": "scan-loop", "closer": None,
    "prim_surface": "hit", "hit_surface": "hit", "shade": "shade-common",
    "camera_ray": "regen", "tent": "regen", "camera_ray1": "regen",
    "tent1": "regen",
    "pixel_xy": "setup", "pixel_key": "setup", "draw": "draws",
}
HELPERS = ("fmix32", "mix32", "to_uniform")  # belong to their caller
# blocks inside functions: (function, anchor regex, part); the block runs
# from the anchor's last "{" to its matching "}"
BLOCKS = (
    ("prim_scan", r"if \(r\[COL_KIND\] == 0\.0f\) \{", "scan-sphere"),
    ("prim_scan", r"^\s*\} else \{\s*$", "scan-quad"),
    ("prim_scan", r"if \(valid && gate >= 0\)", "scan-gate"),
    ("scan_split", r"if \(r4\.z >= 0\.0f && valid\)", "scan-gate"),
    ("shade", r"if \(rtype < 0\.5f\) \{", "shade-diffuse"),
    ("shade", r"^\s*\} else \{\s*$", "shade-specular"),
    ("shade", r"if \(rtype < 1\.5f\) \{", "shade-mirror"),
    ("shade", r"\} else \{\s*// refract", "shade-refract"),
    ("trace_regen_kernel", r"if \(!alive\) \{", "regen"),
    ("trace_regen_kernel", r"if \(best >= 0\) \{", "hit"),
)
LOADS = ("LDS", "LDC", "ULDC", "LDG", "LDL")
# the source of a test's own MUFU (its root or reciprocal, not a rare
# branch's): one a copy of the test in the code
TEST_MUFU = ("sqrtf(fmaxf(det", "rsqrt.approx", "1.0f / (dvalid",
             "__frcp_rn(dvalid", "rcp.approx")


def _functions(lines):
    """{name: (first, last)} line ranges (1-based) of the functions and
    kernels defined in a source, by brace matching."""
    out = {}
    for i, ln in enumerate(lines):
        m = re.match(r"^(?:template <[^>]*>\s*)?(?:__\w+__\s+|inline\s+|"
                     r"static\s+|void\s+|bool\s+|int\s+|float\s+|uint32_t\s+|"
                     r"__launch_bounds__\([^)]*\)\s+)*"
                     r"(\w+)\s*\(", ln)
        if not m or m.group(1) in ("if", "for", "while", "switch", "return"):
            continue
        name = m.group(1)
        j = i
        while j < len(lines) and "{" not in lines[j] and ";" not in lines[j]:
            j += 1
        if j >= len(lines) or "{" not in lines[j]:
            continue
        end = _match(lines, j, lines[j].index("{"))
        if end is not None and name not in out:
            out[name] = (i + 1, end + 1)
    # kernels: "trace_regen_kernel(" on its own line after __global__
    for i, ln in enumerate(lines):
        if re.match(r"^trace_regen_kernel\(", ln) and "trace_regen_kernel" not in out:
            j = i
            while "{" not in lines[j]:
                j += 1
            out["trace_regen_kernel"] = (i + 1, _match(lines, j,
                                                       lines[j].rindex("{")) + 1)
    return out


def _match(lines, i, col):
    """The line index of the "}" matching the "{" at lines[i][col]."""
    depth = 0
    for j in range(i, len(lines)):
        start = col if j == i else 0
        for ch in lines[j][start:]:
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    return j
    return None


def line_parts(path: str) -> dict[int, tuple[str, str]]:
    """line -> (part, function) for one source file."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    funcs = _functions(lines)
    out: dict[int, tuple[str, str]] = {}
    for name, (a, b) in funcs.items():
        part = FUNCTIONS.get(name, "helper" if name in HELPERS else
                             ("loop" if name == "trace_regen_kernel" else None))
        if part is None:
            continue
        for ln in range(a, b + 1):
            out[ln] = (part, name)
        if name in ("prim_scan", "scan_split"):  # once
            for ln in range(a, b + 1):
                if re.search(r"\bfor \(int p", lines[ln - 1]):
                    break
                out[ln] = ("scan-setup", name)
    if "trace_regen_kernel" in funcs:  # before and after the sample loop
        a, b = funcs["trace_regen_kernel"]
        w = next(i for i in range(a - 1, b) if "while (done < quota)" in lines[i])
        end = _match(lines, w, lines[w].rindex("{"))
        for ln in list(range(a, w + 1)) + list(range(end + 2, b + 1)):
            out[ln] = ("setup", "trace_regen_kernel")
    cur = None  # "// sass-part: NAME" ... "// sass-part: end" markers
    for i, ln in enumerate(lines):
        m = re.search(r"sass-part: ([\w-]+)", ln)
        if m:
            cur = None if m.group(1) == "end" else m.group(1)
        if cur:
            out[i + 1] = (cur, out.get(i + 1, (None, ""))[1])
    for name, anchor, part in BLOCKS:
        if name not in funcs:
            continue
        a, b = funcs[name]
        for i in range(a - 1, b):
            if re.search(anchor, lines[i]):
                if "{" in lines[i]:
                    end = _match(lines, i, lines[i].rindex("{"))
                else:  # a statement without braces: to its ";"
                    end = next(j for j in range(i, b) if ";" in lines[j])
                for ln in range(i + 1, end + 2):
                    out[ln] = (part, name)
                break
    for i, ln in enumerate(lines):
        if "sass-rare" in ln:
            out[i + 1] = ("rare", out.get(i + 1, (None, ""))[1])
    return out


def _tool(name: str) -> str:
    return os.path.join(os.path.dirname(kbuild.find_nvcc()), name)


def parse_nvdisasm(text: str) -> dict[str, list]:
    """nvdisasm's listing with --print-line-info-inline -> {kernel: [(opcode,
    text, [(file, line), ...] innermost first)]}. Before an instruction
    whose line changed, nvdisasm writes one "//## File ..." comment a frame,
    the innermost first, each "inlined at" the next."""
    out: dict[str, list] = {}
    cur, chain, fresh = None, [], True
    for line in text.splitlines():
        m = re.search(r"\.text\.([A-Za-z0-9_$]+)", line)
        if m and ("section" in line or line.rstrip().endswith(":")):
            cur = out.setdefault(m.group(1), [])
            chain, fresh = [], True
            continue
        if "//##" in line:
            frame = re.search(r'"([^"]+)", line (\d+)', line)
            if frame:
                if fresh:
                    chain, fresh = [], False
                chain.append((os.path.basename(frame.group(1)),
                              int(frame.group(2))))
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            text_ = m.group(1)
            op = re.sub(r"^@!?U?P[T0-9]+\s+", "", text_).split()[0]
            cur.append((op, text_, list(chain)))
            fresh = True
    return out


def disassemble(so_path: str) -> dict[str, list]:
    """{kernel: [(opcode, text, [(file, line), ...] innermost first)]}."""
    out: dict[str, list] = {}
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([_tool("cuobjdump"), "-xelf", "all", so_path], cwd=tmp,
                       check=True, capture_output=True)
        for cubin in sorted(glob.glob(os.path.join(tmp, "*.cubin"))):
            proc = subprocess.run(
                [_tool("nvdisasm"), "-c", "--print-line-info-inline", cubin],
                capture_output=True, text=True, check=True)
            out.update(parse_nvdisasm(proc.stdout))
    return out


def sass_opcodes(so_path: str) -> dict[str, list[str]]:
    """{kernel: opcodes} of a build without line info (cuobjdump -sass)."""
    dump = subprocess.run([_tool("cuobjdump"), "-sass", so_path],
                          capture_output=True, text=True, check=True).stdout
    out: dict[str, list[str]] = {}
    cur = None
    for line in dump.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[-1].strip(), [])
        elif cur is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                cur.append(re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(1)).split()[0])
    return out


def classify(chain, maps) -> tuple[str, bool]:
    """(part, whether the instruction lies in CUDA's headers) of one
    instruction, from its inline chain (innermost first)."""
    ours = [(maps[f][ln] if ln in maps[f] else ("loop", "")
             if f == "trace_regen.cu" else (None, ""), f) for f, ln in chain
            if f in maps]
    libm = bool(chain) and chain[0][0] not in maps
    if not ours:
        return ("out-of-line" if chain else "no-line"), libm
    if any(p == "regen" and f == "trace_regen.cu" for (p, _), f in ours):
        return "regen", libm
    for (part, fn), _ in ours:
        if part in (None, "helper"):
            continue
        return part, libm
    return "loop", libm


def count(so_path: str, sources: list[str]) -> dict:
    """The per-part counts of the K1 kernel in a library."""
    return tally(disassemble(so_path), sources)


def tally(listing: dict[str, list], sources: list[str]) -> dict:
    """The per-part counts of the K1 kernel in a disassembled library
    (``disassemble``), its lines read from ``sources``."""
    maps = {os.path.basename(p): line_parts(p) for p in sources}
    source_lines = {}
    for p in sources:
        with open(p) as fh:
            source_lines[os.path.basename(p)] = fh.read().splitlines()
    name = next(k for k in listing if "trace_regen_kernel" in k)
    parts = {p: {"instructions": 0, "loads": dict.fromkeys(LOADS, 0),
                 "mufu": 0, "tests": 0, "libm": 0, "calls": 0}
             for p in PARTS}
    inlined = 0
    for op, _, chain in listing[name]:
        part, libm = classify(chain, maps)
        rec = parts[part]
        rec["instructions"] += 1
        base = op.split(".")[0]
        if base in LOADS:
            rec["loads"][base] += 1
        rec["mufu"] += base == "MUFU"
        if base == "MUFU" and chain and chain[0][0] in source_lines:
            src = source_lines[chain[0][0]][chain[0][1] - 1]
            rec["tests"] += any(mark in src for mark in TEST_MUFU)
        rec["libm"] += libm
        rec["calls"] += base in ("CALL", "FCHK")
        inlined += len(chain) > 1
    return {"kernel": name, "instructions": len(listing[name]),
            "with_inline_chain": inlined, "parts": parts}


def per_warp_step(counts: dict, model: dict) -> dict:
    """Warp-instructions a warp issues a step, by part: every part once, the
    scan's per-primitive parts per primitive (the code's copies of a test,
    counted by their roots or reciprocals, divided out), each branch by its
    share of warp-steps."""
    sc = model["scene"]
    br = {b: v["warp_step_share"] for b, v in model["branches"].items()}
    parts = counts["parts"]
    # the copies of a test in the code: one root or reciprocal each (a scan
    # unrolled by two has two copies and a remainder, for each reciprocal)
    sph = max(1, parts["scan-sphere"].get("tests", 1))
    quad = max(1, parts["scan-quad"].get("tests", 1))
    weight = {
        "scan-setup": 1.0, "scan-loop": sc["prims"],
        "scan-sphere": sc["spheres"] / sph,
        "scan-quad": (sc["quads"] + sc["triangles"]) / quad,
        "scan-gate": sc["gated"] / quad,
        "hit": br["hit"], "shade-common": br["hit"],
        "shade-diffuse": br["diffuse"], "shade-specular": br["specular"],
        "shade-mirror": br["mirror"], "shade-refract": br["refract"],
        "regen": br["regen"], "draws": 1.0, "loop": 1.0, "setup": 0.0,
        "rare": 0.0, "out-of-line": 0.0, "no-line": 0.0,
    }
    by = {p: counts["parts"][p]["instructions"] * w for p, w in weight.items()}
    return {"by_part": by, "total": sum(by.values())}


def issue_estimate_ms(per_step: float, warp_steps: int, clock_mhz: float) -> float:
    """The issue estimate: the time 132 SMs x 4 schedulers, one
    warp-instruction a clock each, take to issue per_step warp-instructions
    on each of warp_steps warp-steps (per_step is a weighed static count,
    so this is no lower bound)."""
    return per_step * warp_steps / (SMS * SCHEDULERS * clock_mhz * 1e6) * 1e3


def ptxas(log: str) -> list[str]:
    return [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "stack frame" in ln]


def build_counted(root: str):
    """(the -lineinfo build, the production build) of root's K1."""
    src = os.path.join(root, CSRC, "trace_regen.cu")
    return kbuild.build(src, ("-lineinfo",)), kbuild.build(src)


def report(root: str, model: dict | None = None,
           clock_mhz: float = 1980.0) -> dict:
    """Everything the script prints, for the production build of a
    checkout."""
    lined, prod = build_counted(root)
    sources = [os.path.join(root, CSRC, f) for f in
               ("trace_regen.cu", "common.cuh", "k1_scan.cuh")]
    c = count(lined.path, [p for p in sources if os.path.exists(p)])
    ops = sass_opcodes(prod.path)
    prod_ops = next((v for k, v in ops.items() if c["kernel"] in k
                     or k in c["kernel"]), None)
    out = {"root": os.path.relpath(root, ROOT) or ".", **c,
           "ptxas": ptxas(prod.log),
           "production_instructions": len(prod_ops) if prod_ops else None,
           "lineinfo_build_same_opcodes": prod_ops == [
               op for op, _, _ in disassemble(lined.path)[c["kernel"]]]}
    if model is not None:
        step = per_warp_step(c, model)
        out["per_warp_step"] = step
        out["per_segment_issue_slots"] = step["total"] * model["warp_steps"] / (
            model["segments"] / 32)
        out["issue_estimate_ms"] = issue_estimate_ms(
            step["total"], model["warp_steps"], clock_mhz)
        out["clock_mhz"] = clock_mhz
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--model", default=None,
                    help="a JSON file of scripts/k1_coherence.py's output")
    ap.add_argument("--clock-mhz", type=float, default=1980.0)
    args = ap.parse_args()
    model = None
    if args.model:
        with open(args.model) as fh:
            model = json.load(fh)
    print(json.dumps(report(args.root, model, args.clock_mhz), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
