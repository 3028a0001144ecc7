"""Precision-flow linter: AST rules that enforce the paper's dtype discipline.

Counterpart of `repro.analysis.lint`, re-derived for torch and CUDA idiom.
The mixed-precision claim (fp64/fp32 band, fp32/bf16 off-band "without any
deterioration of numerical accuracy") rests on every cast flowing from a
`PrecisionPolicy`, never from an ad-hoc literal, and on every low-precision
product summing in the accumulator.  This module makes that a checked
invariant over `src/repro_torch/` (its Python and `csrc/*.cu`):

  no-implicit-downcast  (the reference's rule of the same name)
      In the policy-governed numerics packages (`core/`, `covariance/`)
      every cast must take an expression (a policy field, a dtype
      variable, `x.dtype`), never a literal: `.to(torch.<dtype>)`,
      `.to(dtype=torch.<dtype>)`, `.type(torch.<dtype>)` and the method
      casts `.half()`, `.bfloat16()`, `.float()` and `.double()` are
      findings there.  Elsewhere only *narrowing* literals (bf16, fp16,
      the fp8 kinds, int8, uint8) are findings -- a widening `.float()` is
      the documented accumulate idiom and stays legal.

  accum-dtype  (the reference's rule of the same name)
      A matmul-family call (`@`, `torch.matmul` / `mm` / `bmm` / `addmm` /
      `baddbmm` / `einsum` / `tensordot` and their method forms) whose
      operand's *outermost* cast is to a lo tier is a finding: a bf16 x
      bf16 product comes back rounded to bf16, and cuBLAS may sum its
      split-K partials in bf16.  A lo tier is a narrow literal, `*.lo` /
      `*.lo2` / `solve_dtype`, or a local bound to one (tracked through
      locals as the reference does); views (`.mT`, `.T`, `.t()`,
      `.reshape`, slicing, ...) and device moves are looked through.  The
      port's idiom, `a.to(lo).to(acc) @ ...` (`core.precision.lo_matmul`),
      is clean, and so is an explicit `out_dtype=` that is not a narrow
      literal (the counterpart of `preferred_element_type=`).  Setting
      `allow_bf16_reduced_precision_reduction` or
      `allow_fp16_reduced_precision_reduction` to anything but `False` is
      also a finding.

  tf32-guard  (replaces `x64-guard`)
      On JAX an fp64 literal outside x64 truncates to fp32 in silence; in
      torch fp64 is fp64, and the silent truncation is TF32 instead: an
      fp32 product on the tensor cores that keeps ten mantissa bits.
      Findings in Python: assigning anything but `False` to
      `torch.backends.cuda.matmul.allow_tf32` or
      `torch.backends.cudnn.allow_tf32`, anything but `"ieee"` to an
      `fp32_precision` setting, `torch.set_float32_matmul_precision(...)`
      with anything but `"highest"`, and a Triton `tl.dot` without
      `input_precision="ieee"` (or `allow_tf32=False`) unless both operands
      are visibly cast to a narrow type.  In `csrc/*.cu` a scan of the code
      (comments and their "no TF32" remarks left out) flags a `.tf32`
      operand type in an `mma` / `wgmma` instruction,
      `wmma::precision::tf32`, `CUBLAS_COMPUTE_32F_FAST_TF32` and
      `CUBLAS_TF32_TENSOR_OP_MATH`; a `// repro: disable=tf32-guard --
      reason` pragma on the line suppresses it.

  kernel-contract  (replaces `pallas-blockspec-contract`)
      For each `kernels/<name>/` package, `ops.py` (the wrapper that
      launches the CUDA kernel on a card tensor) and `ref.py` (its plain
      PyTorch version) must both exist; each public function of `ops.py`
      with a counterpart in `ref.py` -- a function of the same name (the
      port's layout) or `<name>_ref` -- must have the same positional
      parameters, and the counterpart may not take a keyword-only
      parameter the op lacks; a package where nothing matches is a
      finding.  The reference's BlockSpec half (index-map arity, block
      ranks, out-spec counts) has no Python counterpart: the port's
      launches are C++ (grid and block come from the `.cu` launchers), so
      there is nothing of that shape for an AST rule to read, and this
      rule does not stand in for it.

  obs-span-context  (unchanged)
      Every `span(...)` / `maybe_span(...)` telemetry call must be
      context-managed (`with obs.span(...):` or handed to
      `enter_context(...)`).  A bare call opens a timer that is never
      closed.  `obs/` itself (which defines and returns span objects) is
      exempt.

Suppression: per-line `# repro: disable=<rule>[,<rule>] -- reason` pragmas
(any line of a multi-line statement), or entries in the committed
`baseline.json` (see baseline.py) for kept findings.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

RULES = (
    "no-implicit-downcast",
    "accum-dtype",
    "tf32-guard",
    "kernel-contract",
    "obs-span-context",
)

# Packages where ANY literal-dtype cast is a violation (dtypes must flow
# from a PrecisionPolicy or a dtype-valued variable/parameter).
STRICT_PACKAGES = ("core", "covariance")

# torch's spellings of each dtype -> its canonical name
_DTYPE_ALIASES = {"half": "float16", "float": "float32", "double": "float64"}
# Narrowing storage dtypes: flagged as literals everywhere.
NARROW_DTYPES = frozenset({
    "bfloat16", "float16", "half", "float8_e4m3fn", "float8_e5m2",
    "float8_e4m3fnuz", "float8_e5m2fnuz", "float8_e8m0fnu", "int8", "uint8",
})
# Additional literals banned in STRICT_PACKAGES (all float literals).
FLOAT_DTYPES = NARROW_DTYPES | {"float32", "float", "float64", "double"}
# method casts -> the dtype they cast to
METHOD_CASTS = {"half": "float16", "bfloat16": "bfloat16",
                "float": "float32", "double": "float64"}
# modules whose attributes name dtypes (torch.bfloat16, tl.float16)
_DTYPE_MODULES = frozenset({"torch", "tl"})

MATMUL_FUNCS = frozenset({"matmul", "mm", "bmm", "addmm", "baddbmm",
                          "einsum", "tensordot"})
# receivers of the function forms (torch.matmul, torch.linalg.matmul)
_FUNC_MODULES = frozenset({"torch", "linalg"})
REDUCED_REDUCTION_FLAGS = frozenset({
    "allow_bf16_reduced_precision_reduction",
    "allow_fp16_reduced_precision_reduction"})

# Telemetry span constructors (repro_torch.obs): must be context-managed.
SPAN_FUNCS = frozenset({"span", "maybe_span"})

# Attribute / name spellings that mark a cast target as "lo tier".
LO_TIER_NAMES = frozenset({"lo", "lo2", "solve_dtype"})

# what an operand's outermost cast is looked for through
_VIEW_ATTRS = frozenset({"mT", "T", "mH", "H"})
_VIEW_METHODS = frozenset({
    "t", "transpose", "contiguous", "reshape", "view", "permute",
    "unsqueeze", "squeeze", "flatten", "expand", "expand_as", "narrow",
    "clone", "detach", "movedim", "swapaxes", "tril", "triu", "diagonal",
    "unflatten", "view_as", "reshape_as"})

_PRAGMA_RE = re.compile(
    r"#\s*repro:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)")
_CU_PRAGMA_RE = re.compile(
    r"//\s*repro:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)")
# TF32 math in CUDA C++ / PTX (matched on code with comments blanked)
_CU_TF32_RES = (
    (re.compile(r"\bw?mma[\w.]*\.tf32\b"), "a .tf32 operand type in an mma "
     "instruction"),
    (re.compile(r"\bwmma\s*::\s*precision\s*::\s*tf32\b"),
     "wmma::precision::tf32 fragments"),
    (re.compile(r"\bCUBLAS_COMPUTE_32F_FAST_TF32\b"),
     "cuBLAS compute type CUBLAS_COMPUTE_32F_FAST_TF32"),
    (re.compile(r"\bCUBLAS_TF32_TENSOR_OP_MATH\b"),
     "cuBLAS math mode CUBLAS_TF32_TENSOR_OP_MATH"),
)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # posix path relative to the package root's parent
    line: int
    message: str
    code: str          # stripped source line (baseline match key)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# pragma handling
# ---------------------------------------------------------------------------

def _pragmas(source: str, regex) -> dict[int, frozenset[str]]:
    out: dict[int, frozenset[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = regex.search(text)
        if m:
            out[i] = frozenset(r.strip() for r in m.group(1).split(",")
                               if r.strip())
    return out


def pragma_lines(source: str) -> dict[int, frozenset[str]]:
    """line number (1-based) -> set of rule names disabled on that line."""
    return _pragmas(source, _PRAGMA_RE)


def _suppressed(pragmas: dict[int, frozenset[str]], node: ast.AST, rule: str) -> bool:
    lo = getattr(node, "lineno", None)
    hi = getattr(node, "end_lineno", lo)
    if lo is None:
        return False
    return any(rule in pragmas.get(ln, ()) for ln in range(lo, (hi or lo) + 1))


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------

def _func_attr_name(func: ast.AST) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _dtype_literal_name(node: ast.AST) -> str | None:
    """The canonical dtype name if `node` is a literal `torch.<dtype>` (or
    Triton's `tl.<dtype>`)."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id in _DTYPE_MODULES and node.attr in FLOAT_DTYPES):
        return _DTYPE_ALIASES.get(node.attr, node.attr)
    return None


def _is_device_expr(node: ast.AST) -> bool:
    """`"cuda"`, `device`, `x.device`, `torch.device(...)`: a `.to(...)` of
    one of these moves a tensor and casts nothing."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    if isinstance(node, ast.Call):
        return _func_attr_name(node.func) == "device"
    name = _func_attr_name(node)
    return name is not None and "device" in name


def _cast_target(node: ast.AST):
    """For a cast call, (dtype expression or None, method-cast dtype name or
    None); None if `node` is not a cast."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return None
    attr = node.func.attr
    kw = {k.arg: k.value for k in node.keywords if k.arg}
    if attr in METHOD_CASTS and not node.args and "dtype" not in kw:
        return None, METHOD_CASTS[attr]
    if attr == "type" and (node.args or "dtype" in kw):
        return (node.args[0] if node.args else kw["dtype"]), None
    if attr != "to":
        return None
    if "dtype" in kw:
        return kw["dtype"], None
    if len(node.args) >= 2:                     # .to(device, dtype)
        return node.args[1], None
    if len(node.args) == 1 and not _is_device_expr(node.args[0]):
        return node.args[0], None
    return None


def _is_lo_tier_expr(node: ast.AST, lo_vars: set[str]) -> bool:
    """True if the expression names a lo-tier dtype (policy.lo, `lo`, narrow
    literal, or a local variable bound to one)."""
    name = _dtype_literal_name(node)
    if name is not None and name in NARROW_DTYPES:
        return True
    if isinstance(node, ast.Attribute) and node.attr in LO_TIER_NAMES:
        return True
    if isinstance(node, ast.Name) and (node.id in LO_TIER_NAMES or node.id in lo_vars):
        return True
    return False


def _strip_views(node: ast.AST) -> ast.AST:
    """Look through views, slices and device moves to the expression whose
    dtype they carry."""
    while True:
        if isinstance(node, ast.Attribute) and node.attr in _VIEW_ATTRS:
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and (node.func.attr in _VIEW_METHODS
                   or (node.func.attr == "to" and _cast_target(node) is None))):
            node = node.func.value
        else:
            return node


def _is_lo_operand(node: ast.AST, lo_vars: set[str], lo_arrays: set[str]) -> bool:
    """The operand's outermost cast is to a lo tier, or it is a local bound
    to such a value."""
    node = _strip_views(node)
    cast = _cast_target(node)
    if cast is not None:
        expr, method = cast
        if method is not None:
            return method in NARROW_DTYPES
        return _is_lo_tier_expr(expr, lo_vars)
    return isinstance(node, ast.Name) and node.id in lo_arrays


def _matmul_operands(node: ast.AST) -> tuple[str, list] | None:
    """(name, operand expressions) of a matmul-family call, else None."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
        return "@", [node.left, node.right]
    if not isinstance(node, ast.Call):
        return None
    fname = _func_attr_name(node.func)
    if fname not in MATMUL_FUNCS:
        return None
    args = [a for a in node.args
            if not (isinstance(a, ast.Constant) and isinstance(a.value, str))]
    func = node.func
    if isinstance(func, ast.Attribute) and not (
            isinstance(func.value, (ast.Name, ast.Attribute))
            and _func_attr_name(func.value) in _FUNC_MODULES):
        args = [func.value] + args              # a.matmul(b), c.addmm(a, b)
    return fname, args


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_const(node, value) -> bool:
    if not isinstance(node, ast.Constant):
        return False
    if isinstance(value, bool):
        return node.value is value
    return node.value == value


def _assignments(tree: ast.AST):
    """(attribute target, value, statement) for every attribute assignment."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute):
                    yield tgt, node.value, node
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Attribute):
            yield node.target, node.value, node


# ---------------------------------------------------------------------------
# per-module rule passes
# ---------------------------------------------------------------------------

def _check_downcasts(tree: ast.AST, relpath: str, source_lines: list[str],
                     pragmas, strict: bool) -> list[Finding]:
    banned = FLOAT_DTYPES if strict else NARROW_DTYPES
    findings = []
    for node in ast.walk(tree):
        cast = _cast_target(node)
        if cast is None:
            continue
        expr, method = cast
        name = method if method is not None else _dtype_literal_name(expr)
        if name is None or name not in banned:
            continue
        rule = "no-implicit-downcast"
        if _suppressed(pragmas, node, rule):
            continue
        where = ("policy-scoped module: dtype must flow from a PrecisionPolicy "
                 "field or dtype variable" if strict
                 else "narrowing cast must flow from a policy/tier variable")
        spelled = f".{node.func.attr}()" if method is not None \
            else f".{node.func.attr}({name})"
        findings.append(Finding(
            rule, relpath, node.lineno,
            f"literal dtype cast {spelled} -- {where}",
            source_lines[node.lineno - 1].strip()))
    return findings


def _check_accum(tree: ast.AST, relpath: str, source_lines: list[str],
                 pragmas) -> list[Finding]:
    findings = []

    def flag(node, msg):
        if not _suppressed(pragmas, node, "accum-dtype"):
            findings.append(Finding("accum-dtype", relpath, node.lineno, msg,
                                    source_lines[node.lineno - 1].strip()))

    for fn in [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        # taint-track simple local assignments: dtype vars bound to lo tiers
        # and tensor vars bound to lo-cast values
        lo_vars: set[str] = set()
        lo_arrays: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt = node.targets[0].id
                if _is_lo_tier_expr(node.value, lo_vars):
                    lo_vars.add(tgt)
                elif _is_lo_operand(node.value, lo_vars, lo_arrays):
                    lo_arrays.add(tgt)
        for node in ast.walk(fn):
            hit = _matmul_operands(node)
            if hit is None:
                continue
            fname, operands = hit
            out_dtype = None
            if isinstance(node, ast.Call):
                out_dtype = {k.arg: k.value for k in node.keywords
                             if k.arg}.get("out_dtype")
            if out_dtype is not None:
                name = _dtype_literal_name(out_dtype)
                if name in NARROW_DTYPES:
                    flag(node, f"narrow literal accumulator out_dtype={name}; "
                               "use policy.accum_dtype")
                continue
            if any(_is_lo_operand(a, lo_vars, lo_arrays) for a in operands):
                flag(node, f"lo-precision operand feeds {fname}: its sum is "
                           "rounded to lo (and may be reduced in lo); cast "
                           "the operands on to policy.accum_dtype "
                           "(`.to(lo).to(acc)`, lo_matmul)")
    for tgt, value, stmt in _assignments(tree):
        if tgt.attr in REDUCED_REDUCTION_FLAGS and not _is_const(value, False):
            flag(stmt, f"{tgt.attr} set to something other than False: "
                       "cuBLAS may then sum a lo product's split-K partials "
                       "in lo")
    return findings


def _check_tf32(tree: ast.AST, relpath: str, source_lines: list[str],
                pragmas) -> list[Finding]:
    findings = []

    def flag(node, msg):
        if not _suppressed(pragmas, node, "tf32-guard"):
            findings.append(Finding("tf32-guard", relpath, node.lineno, msg,
                                    source_lines[node.lineno - 1].strip()))

    for tgt, value, stmt in _assignments(tree):
        if tgt.attr == "allow_tf32" and not _is_const(value, False):
            flag(stmt, f"{_dotted(tgt)} set to something other than False: "
                       "fp32 products on the tensor cores then keep 10 "
                       "mantissa bits (TF32)")
        elif tgt.attr == "fp32_precision" and not _is_const(value, "ieee"):
            flag(stmt, f"{_dotted(tgt)} set to something other than 'ieee' "
                       "(TF32 truncation of fp32 products)")
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = _func_attr_name(node.func)
        if fname == "set_float32_matmul_precision":
            if not (node.args and _is_const(node.args[0], "highest")):
                flag(node, "set_float32_matmul_precision with something "
                           "other than 'highest' lets fp32 matmuls run in "
                           "TF32 (or bf16x3)")
        elif (fname == "dot" and isinstance(node.func, ast.Attribute)
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == "tl"):
            kw = {k.arg: k.value for k in node.keywords if k.arg}
            if _is_const(kw.get("input_precision"), "ieee") \
                    or _is_const(kw.get("allow_tf32"), False):
                continue
            narrow = [a for a in node.args[:2] if _is_lo_operand(a, set(), set())]
            if len(narrow) == 2:
                continue
            flag(node, "tl.dot without input_precision='ieee': Triton runs "
                       "fp32 operands in TF32 by default")
    return findings


def _check_span_context(tree: ast.AST, relpath: str, source_lines: list[str],
                        pragmas) -> list[Finding]:
    """Flag span()/maybe_span() calls not used as `with` context expressions
    (or fed to ExitStack.enter_context)."""
    allowed: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ce = item.context_expr
                if isinstance(ce, ast.Call) \
                        and _func_attr_name(ce.func) in SPAN_FUNCS:
                    allowed.add(id(ce))
        elif isinstance(node, ast.Call) \
                and _func_attr_name(node.func) == "enter_context":
            for a in node.args:
                if isinstance(a, ast.Call) \
                        and _func_attr_name(a.func) in SPAN_FUNCS:
                    allowed.add(id(a))
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _func_attr_name(node.func) in SPAN_FUNCS):
            continue
        if id(node) in allowed \
                or _suppressed(pragmas, node, "obs-span-context"):
            continue
        findings.append(Finding(
            "obs-span-context", relpath, node.lineno,
            "span()/maybe_span() must be context-managed (`with "
            "obs.span(...):` or enter_context(...)) -- a bare call opens a "
            "timer that is never closed",
            source_lines[node.lineno - 1].strip()))
    return findings


# ---------------------------------------------------------------------------
# CUDA sources
# ---------------------------------------------------------------------------

def _blank_comments(source: str) -> str:
    """`source` with every // and /* */ comment replaced by spaces (newlines
    kept, so line numbers hold); string and character literals are kept."""
    out = []
    i, n = 0, len(source)
    while i < n:
        c = source[i]
        two = source[i:i + 2]
        if two == "//":
            j = source.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif two == "/*":
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("".join(ch if ch == "\n" else " " for ch in source[i:j]))
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and source[j] != c and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            j = min(j + 1, n)
            out.append(source[i:j])
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)


def lint_cuda_source(source: str, relpath: str) -> list[Finding]:
    """The tf32-guard line scan of one CUDA source."""
    pragmas = _pragmas(source, _CU_PRAGMA_RE)
    raw = source.splitlines()
    findings = []
    for i, text in enumerate(_blank_comments(source).splitlines(), start=1):
        for regex, what in _CU_TF32_RES:
            if regex.search(text) and "tf32-guard" not in pragmas.get(i, ()):
                findings.append(Finding(
                    "tf32-guard", relpath, i,
                    f"TF32 math in CUDA: {what} (fp32 operands keep 10 "
                    "mantissa bits)", raw[i - 1].strip()))
                break
    return findings


# ---------------------------------------------------------------------------
# kernel packages
# ---------------------------------------------------------------------------

def _public_functions(tree: ast.AST) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)
            and not n.name.startswith("_")}  # type: ignore[union-attr]


def _param_names(fn: ast.FunctionDef) -> tuple[list[str], set[str]]:
    pos = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    kwonly = {a.arg for a in fn.args.kwonlyargs}
    return pos, kwonly


def check_kernel_package(pkg_dir: Path, root: Path) -> list[Finding]:
    """ops.py <-> ref.py signature conformance for one kernel package."""
    ops_path, ref_path = pkg_dir / "ops.py", pkg_dir / "ref.py"
    findings = []
    rel_ops = ops_path.relative_to(root.parent).as_posix()
    if not ops_path.exists() or not ref_path.exists():
        missing = "ref.py" if ops_path.exists() else "ops.py"
        return [Finding("kernel-contract",
                        pkg_dir.relative_to(root.parent).as_posix(), 1,
                        f"kernel package missing {missing} (every kernel ships "
                        "a wrapper AND its plain PyTorch version)", "")]
    ops_src = ops_path.read_text()
    ops_fns = _public_functions(ast.parse(ops_src))
    ref_fns = _public_functions(ast.parse(ref_path.read_text()))
    ops_pragmas = pragma_lines(ops_src)
    ops_lines = ops_src.splitlines()
    matched = 0
    for name, fn in ops_fns.items():
        ref = ref_fns.get(name) or ref_fns.get(name + "_ref")
        if ref is None:
            continue
        matched += 1
        if _suppressed(ops_pragmas, fn, "kernel-contract"):
            continue
        op_pos, op_kw = _param_names(fn)
        ref_pos, ref_kw = _param_names(ref)
        if op_pos != ref_pos:
            findings.append(Finding(
                "kernel-contract", rel_ops, fn.lineno,
                f"{name}: positional params {op_pos} != {ref.name}'s {ref_pos}",
                ops_lines[fn.lineno - 1].strip()))
        extra = ref_kw - op_kw
        if extra:
            findings.append(Finding(
                "kernel-contract", rel_ops, fn.lineno,
                f"{name}: ref requires keywords {sorted(extra)} the op "
                "wrapper does not accept",
                ops_lines[fn.lineno - 1].strip()))
    if not matched:
        findings.append(Finding(
            "kernel-contract", rel_ops, 1,
            "no ops.py public function has a counterpart (same name or "
            "<name>_ref) in ref.py", ""))
    return findings


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def lint_source(source: str, relpath: str) -> list[Finding]:
    """Lint one module's source text.  relpath is posix, relative to the
    package root's parent (`repro_torch/core/x.py`)."""
    tree = ast.parse(source)
    lines = source.splitlines()
    pragmas = pragma_lines(source)
    parts = Path(relpath).parts
    pkg = parts[1] if len(parts) > 1 else ""
    findings = []
    findings += _check_downcasts(tree, relpath, lines, pragmas,
                                 pkg in STRICT_PACKAGES)
    findings += _check_accum(tree, relpath, lines, pragmas)
    findings += _check_tf32(tree, relpath, lines, pragmas)
    if pkg != "obs":   # obs defines/returns span objects; everyone else
        findings += _check_span_context(tree, relpath, lines, pragmas)
    return findings


def lint_tree(root: Path) -> list[Finding]:
    """Lint every module under `root` (the src/repro_torch directory): its
    Python but `analysis/`, `csrc/*.cu`, and each kernel package."""
    root = Path(root)
    skip = f"{root.name}/analysis/"
    findings: list[Finding] = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root.parent).as_posix()
        if rel.startswith(skip):
            continue
        findings.extend(lint_source(path.read_text(), rel))
    for path in sorted(root.rglob("*.cu")):
        findings.extend(lint_cuda_source(
            path.read_text(), path.relative_to(root.parent).as_posix()))
    kernels = root / "kernels"
    if kernels.is_dir():
        for pkg in sorted(p for p in kernels.iterdir() if p.is_dir()):
            if pkg.name.startswith("__"):
                continue
            findings.extend(check_kernel_package(pkg, root))
    return findings
