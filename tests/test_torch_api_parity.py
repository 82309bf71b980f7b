"""Every public name of the JAX package has its counterpart in the port.

Both packages are parsed with `ast`; neither is imported.  For each module
of dsrt_tpu/, every public function, class and method (and each class's
`__init__`) must exist under the same name in the same module of
dsrt_tpu_torch/ and take each of the JAX version's parameter names
(`*args` / `**kw` by their names too).  `DECLARED` lists the differences
kept on purpose, each with its reason; a gap it does not list fails, and
so does an entry that no longer matches a gap.  One case per module.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "dsrt_tpu")
PORT_PKG = os.path.join(ROOT, "dsrt_tpu_torch")

TPU = "TPU mechanism"
IDIOM = "replaced by PyTorch idiom"
DROPPED = "dropped, no caller"
TEST_REF = "test reference"

# (module, name, parameter) -> (kind, reason).  A name of None: the whole
# module; a parameter of None: the whole name.
DECLARED = {
    ("exec_opts.py", "ExecOptions.key", None): (
        TPU, "keys the Pallas kernels' jit cache on the knobs"),
    ("exec_opts.py", "opts_key", None): (
        TPU, "the knobs' jit cache key"),
    ("exec_opts.py", "use_pallas", None): (
        TPU, "picks the Pallas kernels over XLA; the port launches its CUDA "
             "kernel for every CUDA tensor"),
    ("oracle.py", None, None): (
        TEST_REF, "the NumPy oracle; the port's tests import it from the "
                  "JAX package"),
    ("ops/pallas_path.py", None, None): (
        TPU, "the Pallas path kernel; csrc/path_kernel.cuh behind "
             "ops/path_kernel.py"),
    ("ops/pallas_sphere.py", None, None): (
        TPU, "the Pallas sphere kernel; csrc/sphere_kernel.cu behind "
             "ops/sphere_kernel.py"),
    ("ops/pallas_trace.py", None, None): (
        TPU, "the Pallas traversal kernels; csrc/traverse_kernel.cu behind "
             "ops/traverse.py"),
    ("ops/trace.py", "packet_traverse", None): (
        TPU, "the block-union packet walk for the TPU's vector lanes; the "
             "port walks per ray"),
    ("ops/trace.py", "scene_hit_flat_lane", None): (
        TPU, "the lane-walk entry the packet router picks; the port's "
             "scene_hit_flat walks per ray"),
    ("models/mesh_gen.py", "iss_standin_scene", "wide_max_leaf"): (
        TPU, "the 8-ary collapse's leaf bound for the TPU kernels; the port "
             "derives its 8-ary table from the binary tree (pack_wide)"),
    ("models/scene.py", "SceneBuilder.__init__", "wide_max_leaf"): (
        TPU, "as iss_standin_scene's"),
    ("models/scene.py", "SceneBuilder.__init__", "tex_bf16"): (
        TPU, "the bf16 texel pool feeds the MXU gather at bf16 rate; the "
             "port's kernels read f32 and keep the bf16 rounding as a "
             "constant (no caller sets it False)"),
    ("ops/linalg.py", "v3", None): (IDIOM, "V3(...) of tensors directly"),
    ("ops/linalg.py", "splat", None): (
        IDIOM, "V3 components are built from tensors where they are used"),
    ("ops/linalg.py", "from_array", None): (IDIOM, "as splat"),
    ("ops/linalg.py", "to_array", None): (IDIOM, "as splat"),
    ("ops/linalg.py", "select_gather", None): (IDIOM, "as splat"),
    ("ops/linalg.py", "length2", None): (
        IDIOM, "dot, and linalg.sqrt, which takes the root in float64 and "
               "rounds once"),
    ("ops/linalg.py", "length", None): (IDIOM, "as length2"),
    ("ops/linalg.py", "lerp", None): (IDIOM, "written out where it is used"),
    ("orbit/kepler.py", "solve_kepler_E_jax", None): (
        IDIOM, "solve_kepler_E_torch, on --device"),
    ("orbit/kepler.py", "coe_to_rv_jax", None): (
        IDIOM, "coe_to_rv_torch, on --device"),
    ("orbit/trajectory.py", "generate_polar_rendezvous_trajectory",
     "use_jax"): (IDIOM, "the Kepler solve always runs in PyTorch on "
                         "`device`"),
    ("orbit/trajectory.py", "generate_pose_file", "use_jax"): (
        IDIOM, "as generate_polar_rendezvous_trajectory's"),
    ("parallel/mesh.py", "make_mesh", "devices"): (
        IDIOM, "ranks take the place of JAX's device list; `device` names "
               "where each rank renders"),
    ("models/esrgan.py", "rrdbnet_forward", None): (
        IDIOM, "RRDBNet is an nn.Module; its forward"),
    ("models/esrgan.py", "upscale_tiled", "params"): (
        IDIOM, "takes the RRDBNet module, which holds its weights"),
    ("models/esrgan.py", "upscale_tiled", "scale"): (
        IDIOM, "the module's own scale"),
    ("models/esrgan.py", "upscale_u8", "params"): (
        IDIOM, "as upscale_tiled's"),
    ("models/esrgan.py", "upscale_u8", "scale"): (IDIOM, "as upscale_tiled's"),
    ("ops/shade.py", "bounce_step", "count_rays"): (
        IDIOM, "the ray count is always returned"),
    ("ops/shade.py", "trace_paths", "count_rays"): (
        IDIOM, "the ray count is always returned"),
    ("ops/wavefront.py", "trace_accumulate", "count_rays"): (
        IDIOM, "the ray count is always returned"),
    ("ops/wavefront.py", "trace_queue", "count_rays"): (
        IDIOM, "the ray count is always returned"),
    ("ops/textures.py", "perlin_noise", "scene"): (
        IDIOM, "unused: JAX deletes it (dsrt_tpu/ops/textures.py:131)"),
    ("ops/textures.py", "perlin_turb", "scene"): (
        IDIOM, "passed on to perlin_noise only, which does not read it"),
    ("ops/shade.py", "sample_sphere_light_direction", None): (
        IDIOM, "sphere_light_from_uniforms takes the draws, as the kernels "
               "do"),
    ("render.py", "render_frame", "spp_batch"): (
        DROPPED, "JAX's throughput mode of the parity renderer; no caller "
                 "in either package"),
    ("utils/timing.py", "StageTimer.stage", "extra"): (
        IDIOM, "a span keeps its frame id and parent span, not free-form "
               "extras"),
    ("utils/timing.py", "StageTimer.log", "seconds"): (
        IDIOM, "a row keeps its start and end on the trace's clock: "
               "log(name, start_ns, frame) ends it now"),
    ("utils/timing.py", "StageTimer.log", "extra"): (
        IDIOM, "as StageTimer.stage's"),
    ("utils/timing.py", "StageTimer.total", None): (
        DROPPED, "no caller in the port"),
    ("utils/timing.py", "estimate_rays", None): (
        DROPPED, "an estimate; the driver prints the exact ray count, and "
                 "nothing in the port calls it"),
}


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def public_api(path: str) -> dict:
    """{name: parameter names} of a module's public functions and
    methods (Class.method, with __init__), {Class: None} for classes."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    api = {}
    for node in tree.body:
        if (not isinstance(node, funcs + (ast.ClassDef,))
                or node.name.startswith("_")):
            continue
        if isinstance(node, funcs):
            api[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            api[node.name] = None
            for m in node.body:
                if isinstance(m, funcs) and (not m.name.startswith("_")
                                             or m.name == "__init__"):
                    api[f"{node.name}.{m.name}"] = _params(m)
    return api


def gaps(module: str) -> set:
    """(module, name, parameter) of every JAX name or parameter the port
    lacks in that module."""
    port_path = os.path.join(PORT_PKG, module)
    if not os.path.exists(port_path):
        return {(module, None, None)}
    want = public_api(os.path.join(JAX_PKG, module))
    have = public_api(port_path)
    out = set()
    for name, params in want.items():
        if name not in have:
            out.add((module, name, None))
        elif params is not None:
            out.update((module, name, p) for p in params
                       if p not in (have[name] or ()))
    return out


MODULES = sorted(
    os.path.relpath(os.path.join(d, f), JAX_PKG)
    for d, _, files in os.walk(JAX_PKG) for f in files if f.endswith(".py"))


def test_declared_entries_name_modules_of_the_jax_package():
    assert {key[0] for key in DECLARED} <= set(MODULES)
    assert all(kind in (TPU, IDIOM, DROPPED, TEST_REF) and reason
               for kind, reason in DECLARED.values())


@pytest.mark.parametrize("module", MODULES)
def test_port_has_the_jax_api(module):
    found = gaps(module)
    declared = {key for key in DECLARED if key[0] == module}
    assert not found - declared, ("not in the port: "
                                  f"{sorted(found - declared, key=str)}")
    assert not declared - found, ("DECLARED entries that match no gap: "
                                  f"{sorted(declared - found, key=str)}")
