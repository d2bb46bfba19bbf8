"""Host-side determinism lint of the port.

The port's counterpart of `bitcoinconsensus_tpu/analysis/host_lint.py`. The
interval prover covers traced torch functions; this covers the plain-Python
consensus path (`core/`: script interpreter, tx and block checks, sighash;
`models/`: batch and block orchestration whose decisions feed verdicts).
Those modules must be bit-exact, replayable functions of their inputs:

- no float literals or float arithmetic (script semantics are integer; a
  float sneaking into a fee or size comparison is a consensus fault that no
  test vector may cover),
- no `random` / `secrets` (verdicts must not depend on entropy),
- no reading clocks (`time.time`, `datetime.now`, `time.perf_counter`, ...).

The clock rule also runs alone over `crypto/`, `parallel/`,
`resilience/`, `serving/` and `cell/` (host-side policy with wall-clock
deadlines: floats are fine there, reading a clock outside `obs.monotonic`
is not; sleeping is not reading a clock). The sanctioned clock readers are `obs/spans.py` (spans and
`monotonic`) and `utils/profiling.py` (`Phases`, `accumulate`,
`monotonic`), which times through it: ad-hoc `time.perf_counter()` pairs
must not drift in beside them.

The `sync` rule runs over `crypto/torch_backend.py`,
`resilience/inflight.py`, `parallel/mesh.py`, `serving/ingress.py` and
`models/sigstore.py`, the counterparts of the reference's
`jax_backend.py`, `inflight.py`, `mesh.py`, `ingress.py` and `sigstore.py`
(the network edge and the persistent store sit upstream of the dispatch
path and may never force a device buffer to the host): forcing a device tensor to the host
(`.cpu()`, `.item()`, `.tolist()`, `.numpy()`, `np.asarray`, `np.array`) or
waiting for the device (`torch.cuda.synchronize`, an event's
`.synchronize()`) is a hidden synchronisation point that serialises the
pipeline and passes the guards by. Only the functions of
`SYNC_ALLOWED_FUNCS` may, each for the reason it states: as in the
reference, the settle seam `_materialize_guarded`, `settle_array` and
`make_mesh`; the port's settle seams (`_guard_launch`, and the mesh's
`_ShardedLaunch.settle`) and its host staging.

The scalar-coverage rule (`lint_scalar_recoders`) requires every
recoder-shaped function of `ops/`, `crypto/glv.py` and the `VT_FN`
functions of `csrc/verify_tiles.cu` to be registered with the scalar-schedule
prover (`scalar_check.REGISTERED_RECODERS`).

The region-coverage rule (`lint_kernel_regions`) requires every kernel the
port can launch to map to a region of `ops/regions.KERNEL_REGIONS`, so that
a capture (`obs/xprof.py`) charges its device time to a name: every
`__global__` kernel of `csrc/*.cu`, every kernel a launcher launches, and
the launcher of every `launch.bind(source, symbol)` in `ops/` and
`analysis/kernel_check.py`. The reference traces each registry kernel's
jaxpr for its name stack (`region_coverage`); a hand-written kernel has no
name stack, one launch being one region, so the port's rule reads the
sources.

Rules of the reference that wait: the `precision` and `pallas` rules have no
torch or CUDA counterpart in the port today.

Pure-AST checks (and a regex scan of the `.cu`): no imports of the scanned
modules, so a syntax-valid file is lintable even when its dependencies are
not importable.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterator, List, Sequence, Tuple

ALL_RULES = frozenset({"float", "nondeterminism", "time"})
TIMING_RULES = frozenset({"time"})
SYNC_RULES = frozenset({"sync"})

# Functions (qualified names) allowed to synchronise with the device, each
# with its reason.
SYNC_ALLOWED_FUNCS: Dict[str, str] = {
    "TorchSecpVerifier._materialize_guarded": "the settle seam: the one "
    "place a dispatch's verdicts reach the host, waited for once and held "
    "to the guards before anything reads them",
    "settle_array": "resilience/inflight.py: the sanctioned device->host "
    "copy outside the settle seam",
    "TorchSecpVerifier._prepare_ticket": "host staging: numpy views of the "
    "host buffers it has just filled, to write the sentinel lanes; no "
    "device tensor is touched",
    "TorchSecpVerifier.__init__": "set-up, once per verifier before any "
    "dispatch: the warm-up launch is waited for so a verify call's time is "
    "its own",
    "TorchSecpVerifier._guard_launch": "the settle seam's wait and guards, "
    "shared by the base settle and the mesh's single-device rung",
    "make_mesh": "parallel/mesh.py: host shaping of the device list, as in "
    "the reference",
    "ShardedSecpVerifier._prepare_ticket": "host staging, as the base's: "
    "numpy views of the host buffers it has just filled, to lay the shards "
    "out and write their sentinels; no device tensor is touched",
    "_ShardedLaunch.settle": "parallel/mesh.py: the mesh's settle seam, one "
    "wait a stream of a sharded dispatch, then numpy views of its pinned "
    "results, held to the guards shard by shard before anything reads them",
}
# module.attr calls that force a device->host copy.
SYNC_BANNED_CALLS = {
    ("np", "asarray"), ("numpy", "asarray"),
    ("np", "array"), ("numpy", "array"),
}
# method calls that force a copy to the host or wait for the device.
SYNC_BANNED_METHODS = {"cpu", "item", "tolist", "numpy", "synchronize"}

BANNED_IMPORTS = {"random", "secrets"}
# module.attr calls whose mere presence is a violation
BANNED_CALLS = {
    ("time", "time"), ("time", "time_ns"), ("time", "monotonic"),
    ("time", "monotonic_ns"), ("time", "perf_counter"),
    ("time", "perf_counter_ns"), ("time", "process_time"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}
FLOAT_CAST = {"float"}


@dataclass
class LintFinding:
    path: str
    line: int
    rule: str
    msg: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, rules: FrozenSet[str] = ALL_RULES):
        self.path = path
        self.rules = rules
        self.findings: List[LintFinding] = []
        self._stack: List[str] = []  # enclosing classes and functions

    def _flag(self, node, rule, msg):
        self.findings.append(
            LintFinding(self.path, getattr(node, "lineno", 0), rule, msg))

    def visit_Constant(self, node: ast.Constant):
        if "float" in self.rules and isinstance(node.value, float):
            self._flag(node, "float-literal",
                       f"float literal {node.value!r} in consensus host "
                       "code (integer semantics only)")
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import):
        if "nondeterminism" in self.rules:
            for alias in node.names:
                if alias.name.split(".")[0] in BANNED_IMPORTS:
                    self._flag(node, "nondeterminism",
                               f"import of `{alias.name}` (entropy source)")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        root = (node.module or "").split(".")[0]
        if "nondeterminism" in self.rules and root in BANNED_IMPORTS:
            self._flag(node, "nondeterminism",
                       f"import from `{node.module}` (entropy source)")
        self.generic_visit(node)

    def _scoped(self, node):
        self._stack.append(node.name)
        try:
            self.generic_visit(node)
        finally:
            self._stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _scoped

    def _sync_allowed(self) -> bool:
        return any(".".join(self._stack[:i]) in SYNC_ALLOWED_FUNCS
                   for i in range(1, len(self._stack) + 1))

    def visit_Call(self, node: ast.Call):
        fn = node.func
        if "sync" in self.rules and isinstance(fn, ast.Attribute) \
                and not self._sync_allowed():
            if isinstance(fn.value, ast.Name) \
                    and (fn.value.id, fn.attr) in SYNC_BANNED_CALLS:
                self._flag(node, "sync",
                           f"{fn.value.id}.{fn.attr}() on the dispatch path "
                           "forces a hidden device->host copy: settle "
                           "through the settle seam or settle_array")
            elif fn.attr in SYNC_BANNED_METHODS:
                self._flag(node, "sync",
                           f".{fn.attr}() on the dispatch path waits for the "
                           "device or copies to the host: only the settle "
                           "seams may (SYNC_ALLOWED_FUNCS)")
        if "time" in self.rules and isinstance(fn, ast.Attribute) \
                and isinstance(fn.value, ast.Name):
            key = (fn.value.id, fn.attr)
            if key in BANNED_CALLS:
                self._flag(node, "time-dependence",
                           f"call to {key[0]}.{key[1]}(): host time flows "
                           "through utils/profiling only (consensus verdicts "
                           "must not read clocks, and ad-hoc timing bypasses "
                           "the phase timers)")
        if "float" in self.rules and isinstance(fn, ast.Name) \
                and fn.id in FLOAT_CAST:
            self._flag(node, "float-op", "float() cast in consensus host code")
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp):
        if "float" in self.rules and isinstance(node.op, ast.Div):
            self._flag(node, "float-op",
                       "true division `/` yields float; use `//` for "
                       "integer consensus arithmetic")
        self.generic_visit(node)


def _iter_py(root: str) -> Iterator[str]:
    for dirpath, _dirnames, filenames in os.walk(root):
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _files(paths: Sequence[str]) -> Iterator[str]:
    for root in paths:
        yield from (_iter_py(root) if os.path.isdir(root) else [root])


def lint_paths(paths: Sequence[str],
               rules: FrozenSet[str] = ALL_RULES) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for path in _files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            findings.append(LintFinding(path, e.lineno or 0, "syntax", str(e)))
            continue
        v = _Visitor(path, rules)
        v.visit(tree)
        findings.extend(v.findings)
    return findings


def _pkg(repo_root: str) -> str:
    return os.path.join(repo_root, "bitcoinconsensus_tpu_torch")


def lint_consensus_host(repo_root: str) -> List[LintFinding]:
    """Full rules over core/ + models/; the clock rule alone over crypto/,
    parallel/, resilience/, serving/ and cell/; the sync rule over the
    verifier's dispatch path, the mesh, the in-flight queue, the network
    edge and the persistent store."""
    pkg = _pkg(repo_root)
    findings = lint_paths([os.path.join(pkg, "core"),
                           os.path.join(pkg, "models")])
    findings += lint_paths([os.path.join(pkg, "crypto"),
                            os.path.join(pkg, "parallel"),
                            os.path.join(pkg, "resilience"),
                            os.path.join(pkg, "serving"),
                            os.path.join(pkg, "cell")], rules=TIMING_RULES)
    findings += lint_paths([os.path.join(pkg, "crypto", "torch_backend.py"),
                            os.path.join(pkg, "parallel", "mesh.py"),
                            os.path.join(pkg, "resilience", "inflight.py"),
                            os.path.join(pkg, "serving", "ingress.py"),
                            os.path.join(pkg, "models", "sigstore.py")],
                           rules=SYNC_RULES)
    return findings


# -- scalar-recoder schedule coverage ---------------------------------------
#
# Any digit-recoding / scalar-split function of ops/, crypto/glv.py or the
# verify kernel's `.cu` must be registered with the scalar-schedule prover
# (analysis/scalar_check.REGISTERED_RECODERS): a new recoder landing without
# a certificate would silently reopen the window-order / carry-fold hole the
# prover closes. A Python function counts as a recoder when its name carries
# a scalar-decomposition hint, or its body extracts windowed digits: a
# `(x >> amt) & mask` whose shift amount is not a plain integer constant
# (fixed-shift carry propagation in the field ops is NOT a recoder). A `VT_FN`
# function of the `.cu` counts by the same two tests, or when it calls one
# that does (the lane program consumes the recoded digits).

SCALAR_RECODER_NAME_HINTS = (
    "digit", "window", "recode", "split_lambda", "scalar_bits",
    "to_limbs", "limbs_to",
)

# (path suffix, function) -> why it is not a recoder.
SCALAR_COVERAGE_EXEMPT: Dict[Tuple[str, str], str] = {
    ("ops/contract.py", "window_span"):
        "a launch-contract helper: the element span a block's tensor window "
        "covers on one axis (the `window` of a BlockSpec); it recodes no "
        "scalar",
}


def _is_var_shift_extract(node: ast.AST) -> bool:
    """`(expr >> amt) & mask` with a non-constant shift amount."""
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitAnd)):
        return False
    return any(isinstance(side, ast.BinOp) and isinstance(side.op, ast.RShift)
               and not isinstance(side.right, ast.Constant)
               for side in (node.left, node.right))


def _named(name: str) -> bool:
    return any(h in name.lower() for h in SCALAR_RECODER_NAME_HINTS)


def scalar_recoder_functions(paths: Sequence[str]):
    """All (path, line, name) recoder-shaped functions under `paths` (Python
    files, and `.cu` sources given by path)."""
    hits = []
    for path in _files(paths):
        if path.endswith(".cu"):
            hits += cuda_recoder_functions(path)
            continue
        with open(path, "r", encoding="utf-8") as fh:
            try:
                tree = ast.parse(fh.read(), filename=path)
            except SyntaxError:
                continue  # lint_paths reports syntax errors
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                    _named(node.name)
                    or any(_is_var_shift_extract(n) for n in ast.walk(node))):
                hits.append((path, node.lineno, node.name))
    return hits


_VT_FN = re.compile(r"^VT_FN\s+[^\n(]*?\b(\w+)\s*\(", re.M)
_C_VAR_SHIFT_EXTRACT = re.compile(r"\([^()]*>>\s*[A-Za-z_]\w*[^()]*\)\s*&")


def _c_body(text: str, start: int) -> str:
    """The braces-balanced body of the function whose signature starts at
    `start` ("" for a declaration)."""
    i = text.find("{", start)
    semi = text.find(";", start)
    if i < 0 or (0 <= semi < i):
        return ""
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    return text[i:]


def cuda_recoder_functions(path: str):
    """(path, line, name) of the recoder-shaped `VT_FN` functions of a `.cu`
    source: a name hint or a variable-shift extraction, or a call to such a
    function, closed under calls."""
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    fns = [(m.group(1), text.count("\n", 0, m.start()) + 1,
            _c_body(text, m.end())) for m in _VT_FN.finditer(text)]
    shaped = {name for name, _, body in fns
              if _named(name) or _C_VAR_SHIFT_EXTRACT.search(body)}
    grew = True
    while grew:
        grew = False
        for name, _, body in fns:
            if name not in shaped and any(
                    re.search(rf"\b{re.escape(r)}\s*\(", body) for r in shaped):
                shaped.add(name)
                grew = True
    return [(path, line, name) for name, line, _ in fns if name in shaped]


def _exempt(path: str, name: str) -> bool:
    p = path.replace(os.sep, "/")
    return any(p.endswith(suffix) and name == fn
               for suffix, fn in SCALAR_COVERAGE_EXEMPT)


def lint_scalar_recoders(repo_root: str = None, paths: Sequence[str] = None,
                         registered=None) -> List[LintFinding]:
    """One finding per recoder-shaped function not registered with the
    scalar-schedule prover (nor exempt). `paths` / `registered` override the
    defaults (the planted-fixture tests feed an unregistered toy recoder
    through the same gate)."""
    if paths is None:
        pkg = _pkg(repo_root)
        paths = [os.path.join(pkg, "ops"),
                 os.path.join(pkg, "crypto", "glv.py"),
                 os.path.join(pkg, "csrc", "verify_tiles.cu")]
    if registered is None:
        from . import scalar_check
        registered = scalar_check.REGISTERED_RECODERS
    findings: List[LintFinding] = []
    for path, line, name in scalar_recoder_functions(paths):
        if name not in registered and not _exempt(path, name):
            findings.append(LintFinding(
                path, line, "scalar-coverage",
                f"`{name}` looks like a digit recoder / scalar split but "
                "is not registered with the scalar-schedule prover: add "
                "it to analysis/scalar_check.REGISTERED_RECODERS mapped "
                "to the target that certifies it (and extend the prover "
                "if no target covers it yet)"))
    return findings


# -- kernel region coverage --------------------------------------------------
#
# Every kernel the port launches must map to a region of
# `ops/regions.KERNEL_REGIONS`, or the xprof capture charges its device time
# to `unattributed`. Read from the sources: the `__global__` kernels of each
# `csrc/*.cu`, the kernels each `extern "C"` launcher (or launcher macro
# instance) launches with `<<<`, and the launchers the wrappers bind.

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_EXTERN_C = re.compile(r'extern\s+"C"\s+int\s+([\w#]+)\s*\(')
_LAUNCH = re.compile(r"([\w#]+)\s*<<<")
_MACRO = re.compile(r"#define\s+(\w+)\(([^)]*)\)((?:[^\n]*\\\n)*[^\n]*)")


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def cuda_launchers(text: str) -> Dict[str, Tuple[List[str], int]]:
    """launcher symbol -> (kernels it launches, line) of a `.cu` source: each
    `extern "C" int f(...)` body's `k<<<` launches, and each instance of a
    launcher macro (`TK_LAUNCHER(positive, ...)`) with its `##` pasting and
    its kernel parameter expanded."""
    out: Dict[str, Tuple[List[str], int]] = {}
    macros = {}
    for m in _MACRO.finditer(text):
        body = m.group(3)
        params = [p.strip() for p in m.group(2).split(",")]
        name = _EXTERN_C.search(body)
        if name:
            macros[m.group(1)] = (params, name.group(1), _LAUNCH.findall(body))
    for m in _EXTERN_C.finditer(text):
        if m.group(1) in {v[1] for v in macros.values()}:
            continue  # the macro's own template, expanded below
        out[m.group(1)] = (_LAUNCH.findall(_c_body(text, m.end())),
                           _line_of(text, m.start()))
    for macro, (params, name_t, launched) in macros.items():
        for inst in re.finditer(rf"^{macro}\(([^)]*)\)", text, re.M):
            args = [a.strip() for a in inst.group(1).split(",")]
            env = dict(zip(params, args))

            def expand(tok: str) -> str:
                parts = [env.get(p, p) for p in tok.split("##")]
                return env.get(tok, "".join(parts))

            out[expand(name_t)] = ([expand(k) for k in launched],
                                   _line_of(text, inst.start()))
    return out


def _bound_launchers(paths: Sequence[str]):
    """(path, line, source, symbol) of every `launch.bind("source",
    "symbol")` with constant arguments; an f-string symbol (the toys'
    `f"tk_{kernel}"`) binds a launcher of that source's table, checked by
    the source scan."""
    out = []
    for path in _files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            try:
                tree = ast.parse(fh.read(), filename=path)
            except SyntaxError:
                continue
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "bind" and len(node.args) == 2
                    and all(isinstance(a, ast.Constant) for a in node.args)):
                out.append((path, node.lineno, node.args[0].value,
                            node.args[1].value))
    return out


def lint_kernel_regions(repo_root: str = None, sources: Dict[str, str] = None,
                        wrappers: Sequence[str] = None,
                        regions: Dict[str, str] = None) -> List[LintFinding]:
    """One finding per kernel without a region: a `__global__` kernel of a
    `.cu` source, or a kernel a launcher launches, missing from `regions`
    (`ops/regions.KERNEL_REGIONS`); a wrapper binding a launcher its
    source does not define; a region entry naming no kernel of any source.
    `sources` (name -> text), `wrappers` (paths) and `regions` override the
    tree (the negative-fixture tests feed an unmapped kernel through the
    same gate); the stale-entry check runs over the tree's sources only."""
    if regions is None:
        from ..ops.regions import KERNEL_REGIONS as regions
    whole_tree = sources is None
    if sources is None:
        csrc = os.path.join(_pkg(repo_root), "csrc")
        sources = {}
        for f in sorted(os.listdir(csrc)):
            if f.endswith(".cu"):
                with open(os.path.join(csrc, f), "r", encoding="utf-8") as fh:
                    sources[f[:-3]] = fh.read()
    if wrappers is None:
        pkg = _pkg(repo_root)
        wrappers = [os.path.join(pkg, "ops"),
                    os.path.join(pkg, "analysis", "kernel_check.py")]
    findings: List[LintFinding] = []
    defined = set()
    launchers_by_source = {}
    for name, text in sources.items():
        path = f"csrc/{name}.cu"
        for m in _GLOBAL.finditer(text):
            defined.add(m.group(1))
            if m.group(1) not in regions:
                findings.append(LintFinding(
                    path, _line_of(text, m.start()), "region",
                    f"kernel `{m.group(1)}` has no region in "
                    "ops/regions.KERNEL_REGIONS: a capture would charge its "
                    "device time to `unattributed`"))
        launchers = cuda_launchers(text)
        launchers_by_source[name] = launchers
        for launcher, (kernels, line) in launchers.items():
            for k in kernels:
                if k not in regions:
                    findings.append(LintFinding(
                        path, line, "region",
                        f"launcher `{launcher}` launches `{k}`, which has no "
                        "region in ops/regions.KERNEL_REGIONS"))
    for path, line, source, symbol in _bound_launchers(wrappers):
        if symbol not in launchers_by_source.get(source, {}):
            findings.append(LintFinding(
                path, line, "region",
                f"binds `{symbol}` of csrc/{source}.cu, which defines no such "
                "launcher: the kernel it launches cannot be mapped to a region"))
    for k in sorted(set(regions) - defined) if whole_tree else ():
        findings.append(LintFinding(
            "ops/regions.py", 0, "region",
            f"KERNEL_REGIONS maps `{k}`, which no csrc/*.cu defines"))
    return findings
