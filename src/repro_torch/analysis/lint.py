"""honeylint — repo-specific AST lint pass over the port (port of
``repro.analysis.lint``, retargeted at ``src/repro_torch``).

Each rule encodes a bug class this repo has already paid for at runtime
(the table in ``analysis/__init__`` sets each port rule beside the
reference rule it stands for).  The pass is pure ``ast`` — no
third-party linter — plus one runtime rule (``schema-golden-drift``)
that imports ``repro_torch.core``'s schema/codec modules and
fingerprints their layout against the port's own pinned golden
(``analysis/golden_schema.json``, a copy of the reference's).

Suppressions
============

Inline, on the offending line or the line above::

    t0 = time.perf_counter()  # honeylint: disable=no-raw-clock -- reason

Baseline (``analysis/baseline.json``): a list of entries

    {"rule": "...", "path": "src/...", "reason": "why this is justified"}

matching every finding of that rule in that file.  The baseline is for
debt the rule post-dates; new code suppresses inline with a reason.

CLI::

    python -m repro_torch.analysis.lint [--baseline PATH] [--json OUT] [ROOT...]
    python -m repro_torch.analysis.lint --pin-golden   # after schema bumps
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import re
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_ROOTS = ("src/repro_torch",)
BASELINE_PATH = Path(__file__).with_name("baseline.json")
GOLDEN_PATH = Path(__file__).with_name("golden_schema.json")

# the one module allowed to touch the raw clock (it OWNS telemetry.CLOCK)
CLOCK_OWNER = "core/telemetry.py"
RAW_CLOCK_ATTRS = {"time", "perf_counter", "perf_counter_ns",
                   "monotonic", "monotonic_ns"}

# snapshot-publish surfaces the aliasing rule patrols, and the function
# name shapes that mark a publish path inside them (``_dev`` is the
# shard's one host -> device conversion every publish goes through)
PUBLISH_FILES = ("core/shard.py", "core/replica.py", "core/read_path.py")
PUBLISH_FN = re.compile(r"publish|stage|export|flip|snapshot|^_dev$")
# torch calls that wrap a host array's memory without copying it
TORCH_WRAPS = {"from_numpy", "as_tensor"}
# calls that may return a view of their argument (or receiver), so a name
# bound to one still aliases the live host array
VIEW_CALLS = {"ascontiguousarray", "asarray", "asanyarray", "view",
              "reshape", "ravel", "squeeze", "transpose", "swapaxes"}
# torch dtype names: ``.to(torch.int32)`` converts a type, not a device
TORCH_DTYPES = {"float16", "float32", "float64", "bfloat16", "half",
                "float", "double", "int8", "int16", "int32", "int64",
                "uint8", "uint16", "uint32", "uint64", "bool", "long",
                "int", "short", "complex64", "complex128"}

# kernel argument names the magic-offset rule treats as packed-image handles
IMAGE_REF = re.compile(r"(^|_)(img|image|out|dst|node)_?ref$|^image$|^img$")
# names whose attributes mark a layout-derived index expression
OFFSET_SOURCES = {"offs", "off", "offsets", "layout", "slot", "cfg", "self"}
MAGIC_MIN = 8   # literals below this are lane/step arithmetic, not offsets

_SUPPRESS_RE = re.compile(
    r"#\s*honeylint:\s*disable=([a-z0-9_,-]+)(?:\s*--\s*(.*))?")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str           # repo-relative
    line: int
    message: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _suppressions(source: str) -> dict[int, set[str]]:
    """line number -> rule ids disabled there (a directive also covers
    the NEXT line, so it can sit above long statements)."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out.setdefault(i, set()).update(rules)
            out.setdefault(i + 1, set()).update(rules)
    return out


# ------------------------------------------------------------ rule helpers
def _is_raw_clock(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and node.attr in RAW_CLOCK_ATTRS
            and isinstance(node.value, ast.Name)
            and node.value.id == "time")


def _names_in(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute):
            base = n
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name):
                yield base.id


def _int_literals(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, int) \
                and not isinstance(n.value, bool):
            yield n


def _broad_handler(h: ast.ExceptHandler) -> bool:
    t = h.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    return any(isinstance(n, ast.Name)
               and n.id in ("Exception", "BaseException") for n in names)


class _FileLinter(ast.NodeVisitor):
    """One pass over one module; accumulates findings for all AST rules."""

    def __init__(self, rel: str, source: str):
        self.rel = rel
        self.findings: list[Finding] = []
        self._publish_depth = 0
        # per-function map of local names bound to aliasing expressions
        # (attribute chains / sliced views of live host arrays)
        self._alias_stack: list[set[str]] = []
        # ids of torch-wrap calls a copying .clone()/.to(copy=True) follows
        self._cleared: set[int] = set()
        self.in_publish_file = any(self.rel.endswith(p)
                                   for p in PUBLISH_FILES)
        self.in_kernels = "/kernels/" in self.rel
        self.is_clock_owner = self.rel.endswith(CLOCK_OWNER)

    def emit(self, rule: str, node: ast.AST, message: str):
        self.findings.append(Finding(rule, self.rel,
                                     getattr(node, "lineno", 1), message))

    # ------------------------------------------------------- no-raw-clock
    def visit_Call(self, node: ast.Call):
        if not self.is_clock_owner and _is_raw_clock(node.func):
            self.emit(
                "no-raw-clock", node,
                f"time.{node.func.attr}() bypasses telemetry.CLOCK — the "
                f"one injectable clock (freeze/advance in tests); import "
                f"CLOCK from repro_torch.core.telemetry")
        if self._publish_depth:
            self._check_publish_call(node)
        self.generic_visit(node)

    # ------------------------------------------------- no-aliased-publish
    def _check_publish_call(self, node: ast.Call) -> None:
        """Inside a publish function: a copying ``.clone()`` or
        ``.to(..., copy=True)`` clears the wrap it is called on (visited
        first: the outer call precedes its receiver); a torch wrap of a
        live host array that nothing cleared, and a ``.to(device)``
        without ``copy=True``, are findings."""
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Call) \
                and self._copies(node):
            self._cleared.add(id(f.value))
        if self._is_torch_wrap(node) and id(node) not in self._cleared:
            arg = node.args[0] if node.args else None
            if arg is not None and self._aliases_host(arg):
                self.emit(
                    "no-aliased-publish", node,
                    f"torch.{f.attr}() of a live host array inside a "
                    f"snapshot publish path shares the array's memory: a "
                    f"CPU snapshot would see every later host write — "
                    f"follow it by .clone() or .to(device, copy=True)")
        elif self._is_device_move(node) and not self._copies(node):
            self.emit(
                "no-aliased-publish", node,
                ".to(device) without copy=True inside a snapshot publish "
                "path returns the SAME tensor when it already lies on that "
                "device (always, for a CPU store) — pass copy=True")

    @staticmethod
    def _is_torch_wrap(node: ast.Call) -> bool:
        f = node.func
        return (isinstance(f, ast.Attribute) and f.attr in TORCH_WRAPS
                and isinstance(f.value, ast.Name) and f.value.id == "torch")

    @staticmethod
    def _copies(node: ast.Call) -> bool:
        """``x.clone()`` or ``x.to(..., copy=True)``."""
        f = node.func
        if not isinstance(f, ast.Attribute):
            return False
        if f.attr == "clone":
            return True
        return f.attr == "to" and any(
            k.arg == "copy" and isinstance(k.value, ast.Constant)
            and k.value.value is True for k in node.keywords)

    @staticmethod
    def _is_device_move(node: ast.Call) -> bool:
        """``x.to(dev)``: a ``.to`` call that names no dtype (a
        ``torch.<dtype>``, an ``.dtype`` attribute or ``dtype=``)."""
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr == "to"):
            return False
        if any(k.arg == "dtype" for k in node.keywords):
            return False
        if not node.args:
            return any(k.arg == "device" for k in node.keywords)
        a = node.args[0]
        if isinstance(a, ast.Attribute) and (
                a.attr == "dtype" or (a.attr in TORCH_DTYPES
                                      and isinstance(a.value, ast.Name)
                                      and a.value.id == "torch")):
            return False
        return True

    def _aliases_host(self, expr: ast.AST) -> bool:
        """Could ``expr`` be a view of a live host array?  Attribute
        chains (``h.ntype``), ``getattr(...)`` and slice subscripts alias,
        and so do the publish function's own parameters; a call produces
        a fresh buffer unless it may return a view of what it was given
        (``np.ascontiguousarray``, ``.view``, ``.reshape``, ...); local
        names inherit what they were bound to (one-pass forward dataflow
        per function)."""
        if isinstance(expr, ast.Attribute):
            return True
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name) and f.id == "getattr":
                return True
            if isinstance(f, ast.Attribute) and f.attr in VIEW_CALLS:
                src = (expr.args[0] if expr.args and isinstance(
                    f.value, ast.Name) and f.value.id in ("np", "numpy")
                    else f.value)
                return self._aliases_host(src)
            return False
        if isinstance(expr, ast.Subscript):
            return any(isinstance(n, ast.Slice) for n in ast.walk(expr.slice))
        if isinstance(expr, ast.Name) and self._alias_stack:
            return expr.id in self._alias_stack[-1]
        return False

    def visit_Assign(self, node: ast.Assign):
        if self._alias_stack:
            aliases = self._alias_stack[-1]
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if self._aliases_host(node.value):
                        aliases.add(t.id)
                    else:
                        aliases.discard(t.id)
        self.generic_visit(node)

    # --------------------------------------------------- no-bare-except
    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if _broad_handler(node):
            what = "bare except" if node.type is None else "except Exception"
            self.emit(
                "no-bare-except", node,
                f"{what} swallows protocol violations (including EpochSan "
                f"assertions) — name the exception types this handler "
                f"actually recovers from")
        self.generic_visit(node)

    # ------------------------------------------- publish-path bookkeeping
    def visit_FunctionDef(self, node: ast.FunctionDef):
        is_pub = self.in_publish_file and bool(PUBLISH_FN.search(node.name))
        self._publish_depth += is_pub
        params = {a.arg for a in (*node.args.posonlyargs, *node.args.args,
                                  *node.args.kwonlyargs)} - {"self", "cls"}
        self._alias_stack.append(params if is_pub else set())
        self.generic_visit(node)
        self._alias_stack.pop()
        self._publish_depth -= is_pub

    visit_AsyncFunctionDef = visit_FunctionDef

    # -------------------------------------------- no-magic-image-offsets
    def visit_Subscript(self, node: ast.Subscript):
        if self.in_kernels and isinstance(node.value, ast.Name) \
                and IMAGE_REF.search(node.value.id):
            self._check_index(node, node.slice)
        self.generic_visit(node)

    def _check_index(self, node: ast.AST, index: ast.AST):
        bad = [c for c in _int_literals(index) if c.value >= MAGIC_MIN]
        if bad and not (set(_names_in(index)) & OFFSET_SOURCES):
            self.emit(
                "no-magic-image-offsets", bad[0],
                f"integer literal {bad[0].value} used as a packed-image "
                f"offset: kernel indices must derive from NodeImageLayout "
                f"offsets / log_replay_offsets(), which re-layout when "
                f"NODE_SCHEMA changes")

    # ------------------------------------------------- stats-must-collect
    def visit_ClassDef(self, node: ast.ClassDef):
        is_dc = any("dataclass" in ast.dump(d) for d in node.decorator_list)
        if is_dc and node.name.endswith("Stats"):
            methods = {n.name for n in node.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            if "collect" not in methods:
                self.emit(
                    "stats-must-collect", node,
                    f"{node.name} is a *Stats dataclass without collect(): "
                    f"every stats surface must speak the telemetry registry "
                    f"protocol (core/telemetry.samples_from) so its meters "
                    f"export")
        self.generic_visit(node)


# --------------------------------------------------------- golden schema
def schema_fingerprint() -> dict:
    """Canonical description of the device-visible layouts: the packed
    node image (NODE_SCHEMA -> NodeImageLayout offsets at the default
    geometry) and the op wire codec (core/api.py).  Any drift here
    changes what crosses the bus / what followers replay — the golden
    must be re-pinned deliberately (``--pin-golden``), never silently."""
    from ..core import api, schema
    from ..core.config import HoneycombConfig

    cfg = HoneycombConfig()
    layout = schema.NodeImageLayout.for_config(cfg)
    detail = {
        "node_schema": [
            {"name": f.name, "dims": list(f.dims), "host": f.host,
             "device": f.device, "fill": f.fill}
            for f in schema.NODE_SCHEMA
        ],
        "image_offsets": {name: [int(off), int(width)]
                          for name, (off, width)
                          in sorted(layout.offsets().items())},
        "image_words": int(layout.image_words),
        "log_entry_words": int(layout.log_entry_words),
        "wire_entry_overhead": int(api.WIRE_ENTRY_OVERHEAD),
        "wire_header_format": api._WIRE_HEADER.format,
        "wire_u16_format": api._WIRE_U16.format,
        "op_codes": {cls.__name__: code
                     for code, cls in sorted(api.OPS_BY_CODE.items())},
    }
    blob = json.dumps(detail, sort_keys=True).encode()
    return {"sha256": hashlib.sha256(blob).hexdigest(), "detail": detail}


def pin_golden(path: Path = GOLDEN_PATH) -> dict:
    fp = schema_fingerprint()
    path.write_text(json.dumps(fp, indent=1, sort_keys=True) + "\n")
    return fp


def check_golden(path: Path = GOLDEN_PATH) -> list[Finding]:
    rel = str(path.relative_to(REPO_ROOT)) if path.is_relative_to(REPO_ROOT) \
        else str(path)
    if not path.exists():
        return [Finding("schema-golden-drift", rel, 1,
                        "golden schema fingerprint missing — run "
                        "`python -m repro_torch.analysis.lint --pin-golden`")]
    golden = json.loads(path.read_text())
    fp = schema_fingerprint()
    if fp["sha256"] == golden.get("sha256"):
        return []
    drift = []
    old, new = golden.get("detail", {}), fp["detail"]
    for k in sorted(set(old) | set(new)):
        if old.get(k) != new.get(k):
            drift.append(k)
    return [Finding(
        "schema-golden-drift", rel, 1,
        f"NODE_SCHEMA / wire-codec layout drifted from the pinned golden "
        f"(changed: {', '.join(drift) or 'unknown'}): the device image and "
        f"the replica feed wire format are cross-version contracts — "
        f"re-pin deliberately with --pin-golden after auditing replayers")]


# ------------------------------------------------------------------ run
def load_baseline(path: Path | None = BASELINE_PATH) -> list[dict]:
    if path is None or not Path(path).exists():
        return []
    return json.loads(Path(path).read_text())


def _baselined(f: Finding, baseline: list[dict]) -> bool:
    return any(b.get("rule") == f.rule and b.get("path") == f.path
               for b in baseline)


def lint_file(path: Path, root: Path = REPO_ROOT) -> list[Finding]:
    rel = str(path.relative_to(root)) if path.is_relative_to(root) \
        else str(path)
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Finding("syntax-error", rel, e.lineno or 1, str(e.msg))]
    linter = _FileLinter(rel, source)
    linter.visit(tree)
    sup = _suppressions(source)
    return [f for f in linter.findings
            if f.rule not in sup.get(f.line, ())]


def run_lint(roots=DEFAULT_ROOTS, *, root: Path = REPO_ROOT,
             baseline: Path | None = BASELINE_PATH,
             golden: Path | None = GOLDEN_PATH
             ) -> tuple[list[Finding], int]:
    """Lint every .py under ``roots``.  Returns (findings, n_baselined)."""
    base = load_baseline(baseline)
    findings: list[Finding] = []
    suppressed = 0
    for r in roots:
        top = root / r if not Path(r).is_absolute() else Path(r)
        files = sorted(top.rglob("*.py")) if top.is_dir() else [top]
        for path in files:
            for f in lint_file(path, root):
                if _baselined(f, base):
                    suppressed += 1
                else:
                    findings.append(f)
    if golden is not None:
        findings.extend(check_golden(golden))
    return findings, suppressed


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.lint")
    ap.add_argument("roots", nargs="*", default=list(DEFAULT_ROOTS))
    ap.add_argument("--baseline", default=str(BASELINE_PATH))
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--json", help="write findings as JSON to this path")
    ap.add_argument("--pin-golden", action="store_true",
                    help="re-pin the schema/wire golden and exit")
    args = ap.parse_args(argv)
    if args.pin_golden:
        fp = pin_golden()
        print(f"pinned golden schema fingerprint {fp['sha256'][:12]} "
              f"-> {GOLDEN_PATH}")
        return 0
    baseline = None if args.no_baseline else Path(args.baseline)
    findings, suppressed = run_lint(args.roots or DEFAULT_ROOTS,
                                    baseline=baseline)
    for f in findings:
        print(f)
    if args.json:
        Path(args.json).write_text(json.dumps(
            {"findings": [f.to_json() for f in findings],
             "baselined": suppressed}, indent=1) + "\n")
    print(f"honeylint: {len(findings)} finding(s), "
          f"{suppressed} baselined")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
