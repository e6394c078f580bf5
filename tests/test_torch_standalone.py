"""The port stands alone: it imports nothing of jax and nothing of the JAX
package, and carries its own copy of every host module it runs.

- A static scan (AST) of every module of svt_av1_psy_tpu_torch and of
  chip_smoke.py: no import of jax, jaxlib or svt_av1_psy_tpu, lazy ones
  included, and no such module name in a string (an importlib string, a
  ``-m`` argument, code handed to ``python -c``).
- Each copied module equals the reference module up to its import prefix,
  statement for statement (AST). In the modules the port re-does, only the
  listed functions, methods and module names may differ; the per-method
  guards of the test_torch_* files hold the copied parts of those.
- The configuration and the tables equal the reference's, and the two
  packages' native libraries are separate files in one process.
"""

import ast
import dataclasses
import enum
import inspect
import pathlib
import re
import sys
import textwrap

import numpy as np
import pytest

import svt_av1_psy_tpu.config as ref_config
import svt_av1_psy_tpu.constants as ref_constants
import svt_av1_psy_tpu.native as ref_native
import svt_av1_psy_tpu.ops.transforms as ref_transforms
import svt_av1_psy_tpu_torch.config as port_config
import svt_av1_psy_tpu_torch.constants as port_constants
import svt_av1_psy_tpu_torch.native as port_native
import svt_av1_psy_tpu_torch.ops.transforms as port_transforms
from svt_av1_psy_tpu_torch.utils.test_clip import make_frame

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "svt_av1_psy_tpu_torch"
REF = ROOT / "svt_av1_psy_tpu"
sys.path.insert(0, str(ROOT / "tools"))
import make_test_clip  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "svt_av1_psy_tpu")
# a whitespace-delimited token that names a forbidden module
_MODULE_TOKEN = re.compile(r"(?:jax|jaxlib|svt_av1_psy_tpu)(?:\.[A-Za-z_]\w*)*")

# the port's modules that re-do a reference module: the units (module
# names, functions, classes and methods, keyed as `Class.method`) that may
# differ from the reference's, or exist on one side only
PORTED = {
    "api.py": {"<imports>", "__all__", "Encoder.__init__"},
    "capi_bridge.py": {"make_encoder"},
    "app/cli.py": {"main"},
    "app/main.py": set(),                          # its docstring only
    "models/fast_intra.py": {
        "<imports>", "_jitted_decide", "_host_copy_async", "_jitted_hme",
        "_jitted_gop_search", "_jitted_gop_search_tf", "_k1_route",
        "_hme_plane", "_hme_packed", "hme_mv_sad",
        "FastIntraEncoder.__init__",
        "FastIntraEncoder.make_sharded_decide",
        "FastIntraEncoder._decide_dispatch",
        "FastIntraEncoder._decide_finish", "FastIntraEncoder.prefetch_decide",
        "FastIntraEncoder._encode_key", "FastIntraEncoder._encode_p",
        "FastIntraEncoder._encode_key_sc",
        "FastIntraEncoder._lr_apply_and_search",
        "FastIntraEncoder._search_apply_cdef",
        "FastIntraEncoder._deferred_filter_task",
        "FastIntraEncoder._pick_and_apply_dlf"},
    "models/intra_encoder.py": {
        "<imports>", "_jitted_block_costs", "IntraEncoder.__init__",
        "IntraEncoder._decide"},
    "models/lr_search.py": {
        "<imports>", "_DISTS", "_gram", "_shift2_dev", "_upload",
        "DeviceLrSearch.__init__", "DeviceLrSearch._build",
        "DeviceLrSearch.dispatch"},
    "models/ra.py": {
        "<imports>", "_sharded_gop_search", "RaDriver.__init__",
        "RaDriver._warmup_async", "RaDriver._tf_device_dispatch",
        "RaDriver._dispatch_gop", "RaDriver._walk_gop"},
    "models/temporal_filter.py": {"temporal_filter"},
    "models/tpl.py": {"tpl_sb_offsets", "tpl_gop_q"},
    "native.py": {"_BUILD", "_SO", "_STAMP", "_build", "get_lib"},
}
# modules of the port's own that share a reference module's name only
OWN = {"__init__.py", "utils/device.py", "utils/trace.py"}


def _rel(p):
    return p.relative_to(PORT).as_posix()


PORT_FILES = sorted(p for p in PORT.rglob("*.py") if "_build" not in p.parts)
COPIES = [_rel(p) for p in PORT_FILES
          if (REF / _rel(p)).exists() and _rel(p) not in OWN]

_PORT_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)svt_av1_psy_tpu_torch\b",
                          re.M)


def reference_source(fn) -> str:
    """The source of a function of the port with its import prefix renamed
    back to the reference's: what the per-method drift guards compare."""
    return _PORT_IMPORT.sub(r"\1svt_av1_psy_tpu", inspect.getsource(fn))


_TRACE_IMPORT = "from svt_av1_psy_tpu.utils import trace as _tr"
_TRACE_STMT = re.compile(r"^\s*(?:\w+ = )?_tr\.\w+\(.*\)$")
_TRACE_WITH = re.compile(r"^(\s*)with _tr\.\w+\(.*\):$")


def without_trace_lines(lines):
    """Source lines of a port method (from reference_source) with its
    tracing taken out: the import of the trace module as _tr, one-line
    statements that call it, and each `with _tr...:` line, whose block is
    moved back out by one indent. What is left is what a per-method
    drift guard compares with the reference, line by line."""
    out = []
    drop_to = None              # indent of an open `with _tr` line
    for ln in lines:
        ind = len(ln) - len(ln.lstrip())
        if drop_to is not None and ln.strip() and ind <= drop_to:
            drop_to = None
        if ln.strip() == _TRACE_IMPORT or _TRACE_STMT.match(ln):
            continue
        m = _TRACE_WITH.match(ln)
        if m:
            assert drop_to is None, "nested trace blocks"
            drop_to = len(m.group(1))
            continue
        out.append(ln[4:] if drop_to is not None and ln.strip() else ln)
    return out


def _is_trace_call(node):
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and \
        isinstance(node.func.value, ast.Name) and node.func.value.id == "_tr"


def _strip_trace_body(body):
    out = []
    for stmt in body:
        if isinstance(stmt, ast.ImportFrom) and \
                ast.unparse(stmt) == _TRACE_IMPORT:
            continue
        if isinstance(stmt, (ast.Expr, ast.Assign)) and \
                _is_trace_call(stmt.value):
            continue
        if isinstance(stmt, ast.With) and \
                all(_is_trace_call(i.context_expr) for i in stmt.items):
            out += _strip_trace_body(stmt.body)
            continue
        for field in ("body", "orelse", "finalbody"):
            if isinstance(getattr(stmt, field, None), list):
                setattr(stmt, field, _strip_trace_body(getattr(stmt, field)))
        for h in getattr(stmt, "handlers", []):
            h.body = _strip_trace_body(h.body)
        out.append(stmt)
    return out


def without_trace(source: str) -> str:
    """The AST dump of a function's source (from reference_source) with
    its tracing taken out, as without_trace_lines does, at any depth and
    whatever the line breaks."""
    tree = ast.parse(textwrap.dedent(source))
    tree.body = _strip_trace_body(tree.body)
    return ast.dump(tree)


def ref_cfg(cfg):
    """cfg built again from the reference's config module with the same
    arguments (each package has its own enum classes)."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(ref_config, type(v).__name__)[v.name]
        kw[f.name] = v
    return ref_config.EncoderConfig(**kw)


# --- the static scan --------------------------------------------------------

def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and \
                isinstance(node.body[0].value, ast.Constant):
            out.add(id(node.body[0].value))
    return out


def _membership_test(node, parents):
    """Whether a constant sits in the right operand of an `in` test (the
    check that no such module was loaded)."""
    while node in parents:
        node, child = parents[node], node
        if isinstance(node, ast.Compare):
            return child in node.comparators and \
                all(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops)
    return False


def forbidden_references(source: str, allow_membership: bool = False):
    """(line, what) of every import of a forbidden module and of every
    string that names one; docstrings are not scanned."""
    tree = ast.parse(source)
    parents = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}
    docs = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names
                      if a.name.split(".")[0] in FORBIDDEN]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module.split(".")[0] in FORBIDDEN:
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            tokens = [t for t in re.split(r"[\s\"',;()]+", node.value)
                      if _MODULE_TOKEN.fullmatch(t)]
            if tokens and not (allow_membership and
                               _membership_test(node, parents)):
                found.append((node.lineno, node.value))
    return found


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_reference_module(path):
    assert forbidden_references(
        path.read_text(), allow_membership=path.name == "chip_smoke.py") == []


@pytest.mark.parametrize("source, n", [
    ("import jax.numpy as jnp", 1),
    ("def f():\n    from svt_av1_psy_tpu.ops import quant", 1),
    ("import importlib\nimportlib.import_module('svt_av1_psy_tpu.api')", 1),
    ("args = [sys.executable, '-m', 'svt_av1_psy_tpu']", 1),
    ("code = 'import jaxlib; print(1)'", 1),
    ("x = 'svt_av1_psy_tpu/ops/jax_backend.py:689'", 0),
    ("import svt_av1_psy_tpu_torch.api", 0),
    ("bad = [m for m in sys.modules\n"
     "       if m.split('.')[0] in ('jax', 'svt_av1_psy_tpu')]", 2),
], ids=["import", "lazy", "importlib", "dash_m", "code", "path", "port",
        "membership"])
def test_static_scan_finds_references(source, n):
    """The scan itself: what it must find, and what it must let through
    (a file path is not a module name); only chip_smoke.py may name a
    module in a membership test."""
    assert len(forbidden_references(source)) == n
    if "sys.modules" in source:
        assert forbidden_references(source, allow_membership=True) == []


# --- the copies ---------------------------------------------------------------

def _rename_prefix(tree):
    """The port's import prefix renamed back to the reference's."""
    old, new = "svt_av1_psy_tpu_torch", "svt_av1_psy_tpu"
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == old:
                    a.name = new + a.name[len(old):]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] == old:
            node.module = new + node.module[len(old):]
    return tree


def _is_docstring(stmt):
    return isinstance(stmt, ast.Expr) and \
        isinstance(stmt.value, ast.Constant) and \
        isinstance(stmt.value.value, str)


def _key(stmt, i):
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return stmt.name
    if isinstance(stmt, (ast.Import, ast.ImportFrom)):
        return "<imports>"
    if isinstance(stmt, ast.Assign):
        return ",".join(ast.unparse(t) for t in stmt.targets)
    if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        return ast.unparse(stmt.target)
    return f"<statement {i}>"


def units(tree) -> dict:
    """{key: AST dump} of a module's statements, its docstring left out: a
    class gives its header (bases, decorators) and one unit per statement
    of its body (its docstring left out), keyed `Class.name`."""
    out = {}
    body = tree.body[1:] if tree.body and _is_docstring(tree.body[0]) \
        else tree.body
    for i, stmt in enumerate(body):
        key = _key(stmt, i)
        if isinstance(stmt, ast.ClassDef):
            out[key] = ast.dump(ast.ClassDef(
                name=stmt.name, bases=stmt.bases, keywords=stmt.keywords,
                body=[], decorator_list=stmt.decorator_list))
            cbody = stmt.body[1:] if _is_docstring(stmt.body[0]) \
                else stmt.body
            for j, member in enumerate(cbody):
                mkey = f"{key}.{_key(member, j)}"
                out[mkey] = out.get(mkey, "") + ast.dump(member)
        else:
            out[key] = out.get(key, "") + ast.dump(stmt)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_the_reference(rel):
    """A verbatim copy equals its reference module up to the import prefix,
    docstrings and all. A module the port re-does may differ only in its
    listed units, and each listed unit does differ."""
    port = _rename_prefix(ast.parse((PORT / rel).read_text()))
    ref = ast.parse((REF / rel).read_text())
    if rel not in PORTED:
        assert ast.dump(port) == ast.dump(ref)
        return
    got, want = units(port), units(ref)
    differ = {k for k in set(got) | set(want) if got.get(k) != want.get(k)}
    assert differ <= PORTED[rel], sorted(differ - PORTED[rel])
    assert differ == PORTED[rel], \
        f"listed but equal: {sorted(PORTED[rel] - differ)}"
    assert len(set(got) & set(want)) - len(differ) > 0


def test_every_ported_module_is_there():
    """The modules the port re-does all exist, and the copies cover every
    layer the port runs."""
    assert set(PORTED) <= set(COPIES)
    for layer in ("bitstream", "entropy", "decoder", "inter", "io", "ops",
                  "constants", "models"):
        assert any(c.startswith(layer + "/") for c in COPIES), layer


@pytest.mark.parametrize("name", ["av1_tables.npz", "txfm_stages.npz"])
def test_tables_equal_the_reference(name):
    """The port's NPZ tables hold the reference's arrays, and the port
    reads its own copy."""
    with np.load(PORT / "constants" / name) as got, \
            np.load(REF / "constants" / name) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    assert port_constants._NPZ.parent == PORT / "constants"
    assert port_transforms._STAGES_NPZ.resolve().parent == PORT / "constants"
    assert ref_transforms._STAGES_NPZ.resolve().parent == REF / "constants"
    got, want = port_constants.tables(), ref_constants.tables()
    assert sorted(got) == sorted(want)


def _enums(module):
    return {n: c for n, c in vars(module).items()
            if isinstance(c, type) and issubclass(c, enum.Enum) and
            c.__module__ == module.__name__}


@pytest.mark.parametrize("pair", [(port_config, ref_config),
                                  (port_constants, ref_constants)],
                         ids=["config", "constants"])
def test_enums_equal_the_reference(pair):
    port, ref = pair
    got, want = _enums(port), _enums(ref)
    assert sorted(got) == sorted(want) and want
    for name, cls in want.items():
        assert [(m.name, m.value) for m in got[name]] == \
            [(m.name, m.value) for m in cls], name
        assert got[name] is not cls


def test_encoder_config_equals_the_reference():
    """Fields, defaults and derived settings of the port's EncoderConfig are
    the reference's; the two packages' enums are separate classes."""
    got = dataclasses.fields(port_config.EncoderConfig)
    want = dataclasses.fields(ref_config.EncoderConfig)
    assert [f.name for f in got] == [f.name for f in want]
    a, b = port_config.EncoderConfig(), ref_config.EncoderConfig()
    for f in want:
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert va == vb and type(va).__name__ == type(vb).__name__, f.name
    for kw in ({}, {"enc_mode": 3}, {"enc_mode": 6, "hierarchical_levels": 5}):
        da = port_config.derive_settings(port_config.validate_config(
            port_config.EncoderConfig(**kw)))
        db = ref_config.derive_settings(ref_config.validate_config(
            ref_config.EncoderConfig(**kw)))
        assert dataclasses.asdict(da) == dataclasses.asdict(db)
    assert port_config.PredStructure is not ref_config.PredStructure


def test_ref_cfg_rebuilds_the_config():
    cfg = port_config.EncoderConfig(
        enc_mode=6, hierarchical_levels=3,
        pred_structure=port_config.PredStructure.LOW_DELAY_B)
    ref = ref_cfg(cfg)
    assert type(ref) is ref_config.EncoderConfig
    assert type(ref.pred_structure) is ref_config.PredStructure
    assert ref.pred_structure.name == "LOW_DELAY_B"
    assert ref == ref_config.EncoderConfig(
        enc_mode=6, hierarchical_levels=3,
        pred_structure=ref_config.PredStructure.LOW_DELAY_B)


def test_make_frame_copy_equals_the_tool():
    """utils/test_clip.make_frame is tools/make_test_clip.make_frame."""
    for bd, noise in ((8, 0.02), (10, 0.0)):
        ra, rb = np.random.default_rng(7), np.random.default_rng(7)
        for t in range(3):
            for x, y in zip(make_frame(96, 64, t, bd, noise, ra),
                            make_test_clip.make_frame(96, 64, t, bd, noise,
                                                      rb)):
                assert x.dtype == y.dtype and np.array_equal(x, y)


def test_native_libraries_are_separate():
    """Each package builds the C sources in native/ into a library of its
    own: the port's under svt_av1_psy_tpu_torch/_build, never in native/.
    Both load in one process as separate handles (ctypes loads with
    RTLD_LOCAL, so neither resolves the other's symbols)."""
    port, ref = port_native.get_lib(), ref_native.get_lib()
    assert port_native._SO.parent == PORT / "_build"
    assert port_native._STAMP.parent == PORT / "_build"
    assert port_native._NATIVE.resolve() == ROOT / "native"
    assert port._name != ref._name and port._handle != ref._handle
    assert port_native._STAMP.read_text().strip() == \
        port_native._src_digest()


def test_capi_shim_differs_only_in_the_module():
    """The port's C API shim is the reference's native/capi_backend.c with
    its two module literals pointed at the port's bridge, built under
    svt_av1_psy_tpu_torch/_build (never into native/)."""
    from svt_av1_psy_tpu_torch import capi_build
    ref = (ROOT / "native" / "capi_backend.c").read_text().splitlines()
    got = capi_build.patched_source().splitlines()
    assert len(got) == len(ref)
    changed = [(a, b) for a, b in zip(ref, got) if a != b]
    assert len(changed) == 2
    for a, b in changed:
        assert b == a.replace('"svt_av1_psy_tpu.capi_bridge"',
                              '"svt_av1_psy_tpu_torch.capi_bridge"')
    assert capi_build.SRC == ROOT / "native" / "capi_backend.c"
    for path in (capi_build.OUT, capi_build.PATCHED, capi_build.STAMP):
        assert path.parent == PORT / "_build"
