"""Good/bad fixtures for the port's precision-flow linter
(repro_torch.analysis.lint), the counterparts of tests/test_analysis_lint.py
in torch and CUDA idiom.

Each rule gets a minimal snippet pair: the bad one must produce exactly the
expected finding, the good one must be clean.  Where the reference's case
has no torch counterpart, a case of the renamed rule takes its place:

  x64-guard's four (fp64 outside x64)  -> tf32-guard in Python:
      test_allow_tf32_not_false_flagged, test_require_ieee_fp32_idiom_clean,
      test_float32_matmul_precision_highest_only,
      test_fp64_literal_not_a_tf32_finding;
  pallas-blockspec-contract's five pl.pallas_call cases -> tf32-guard in
      Triton and CUDA: test_tl_dot_ieee_clean,
      test_tl_dot_default_precision_flagged, test_cu_tf32_wgmma_flagged,
      test_cu_comments_clean_code_flagged,
      test_cu_pragma_suppresses_and_port_csrc_clean;
  the string-literal astype case -> the method and keyword casts.

The suite also pins the meta-properties the gate relies on: the port at
HEAD is lint-clean modulo the committed baseline, a seeded violation of
each rule fails the gate, `core/distributed.py`'s bf16 product is a finding
without its pragma (and every caller holds the guard the pragma names),
and the `obs-span-context` rule finds what the reference's finds over the
reference's own tree.
"""

import ast
import json
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.baseline import (
    load_baseline,
    split_baselined,
    update_baseline,
)
from repro_torch.analysis.cli import SRC_ROOT, main, run_lint
from repro_torch.analysis.lint import (
    RULES,
    Finding,
    check_kernel_package,
    lint_cuda_source,
    lint_source,
    lint_tree,
    pragma_lines,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CORE = "repro_torch/core/fixture.py"          # strict package
RUNTIME = "repro_torch/runtime/fixture.py"    # non-strict package
CU = "repro_torch/csrc/fixture.cu"


def lint(src: str, relpath: str = CORE):
    return lint_source(textwrap.dedent(src), relpath)


def rules(findings):
    return [f.rule for f in findings]


# ---- no-implicit-downcast -------------------------------------------------

def test_literal_cast_flagged_in_strict_package():
    fs = lint("x = a.to(torch.float32)\n")
    assert rules(fs) == ["no-implicit-downcast"]
    assert "policy-scoped" in fs[0].message


def test_method_and_keyword_casts_flagged_in_strict_package():
    # torch has no string dtypes: the literal's other spellings are the
    # method casts and the keyword form
    assert rules(lint("x = a.float()\n")) == ["no-implicit-downcast"]
    assert rules(lint("x = a.to(dtype=torch.double)\n")) \
        == ["no-implicit-downcast"]
    assert rules(lint("x = a.type(torch.float64)\n")) \
        == ["no-implicit-downcast"]


def test_policy_field_cast_clean():
    assert lint("x = a.to(policy.hi)\n") == []


def test_dtype_variable_cast_clean():
    assert lint("x = a.to(dtype)\ny = b.to(a.dtype)\nz = c.to(device)\n"
                "w = c.to('cpu')\n") == []


def test_widening_literal_legal_outside_strict_packages():
    # an fp32 upcast is the documented accumulate idiom outside core/
    assert lint("x = a.to(torch.float32)\ny = b.float()\n", RUNTIME) == []


def test_narrowing_literal_flagged_everywhere():
    fs = lint("x = a.to(torch.bfloat16)\n", RUNTIME)
    assert rules(fs) == ["no-implicit-downcast"]
    assert "narrowing" in fs[0].message


@pytest.mark.parametrize("dt", ["float16", "float8_e4m3fn", "int8"])
def test_all_narrow_dtypes_covered(dt):
    assert rules(lint(f"x = a.to(torch.{dt})\n", RUNTIME)) \
        == ["no-implicit-downcast"]


@pytest.mark.parametrize("cast", ["a.half()", "a.bfloat16()",
                                  "a.to('cuda', torch.float16)",
                                  "a.to(device=d, dtype=torch.uint8)"])
def test_narrow_method_and_keyword_casts_covered(cast):
    assert rules(lint(f"x = {cast}\n", RUNTIME)) == ["no-implicit-downcast"]


# ---- pragma suppression ---------------------------------------------------

def test_inline_pragma_suppresses():
    src = ("x = a.to(torch.bfloat16)"
           "  # repro: disable=no-implicit-downcast -- wire format\n")
    assert lint(src, RUNTIME) == []


def test_pragma_for_other_rule_does_not_suppress():
    src = "x = a.to(torch.bfloat16)  # repro: disable=tf32-guard\n"
    assert rules(lint(src, RUNTIME)) == ["no-implicit-downcast"]


def test_multi_rule_pragma():
    src = ("x = a.to(torch.bfloat16)"
           "  # repro: disable=tf32-guard,no-implicit-downcast\n")
    assert lint(src, RUNTIME) == []


def test_pragma_on_any_line_of_multiline_statement():
    src = (
        "x = a.to(\n"
        "    torch.bfloat16\n"
        ")  # repro: disable=no-implicit-downcast -- spans three lines\n")
    assert lint(src, RUNTIME) == []


def test_pragma_parse():
    got = pragma_lines("a = 1  # repro: disable=accum-dtype, tf32-guard\n")
    assert got == {1: frozenset({"accum-dtype", "tf32-guard"})}


# ---- accum-dtype ----------------------------------------------------------

def test_lo_cast_operand_without_accumulator_flagged():
    src = """
    def f(a, b):
        return torch.matmul(a.to(torch.bfloat16), b)
    """
    fs = lint(src, RUNTIME)
    assert "accum-dtype" in rules(fs)
    assert "accum_dtype" in [f for f in fs
                             if f.rule == "accum-dtype"][0].message


def test_policy_lo_cast_without_accumulator_flagged():
    src = """
    def f(a, b, policy):
        return a.to(policy.lo) @ b.mT
    """
    assert rules(lint(src, RUNTIME)) == ["accum-dtype"]


def test_explicit_policy_accumulator_clean():
    src = """
    def f(a, b, policy):
        lo, acc = policy.lo, policy.accum_dtype
        al = a.to(policy.lo).to(acc)
        u = torch.mm(a.to(lo), b, out_dtype=policy.accum_dtype)
        return (al @ b.to(lo).to(acc).mT).to(lo), u
    """
    assert lint(src, RUNTIME) == []


def test_narrow_literal_accumulator_flagged():
    src = """
    def f(a, b):
        return torch.mm(a, b, out_dtype=torch.bfloat16)
    """
    fs = lint(src, RUNTIME)
    assert rules(fs) == ["accum-dtype"]
    assert "narrow literal accumulator" in fs[0].message


def test_taint_through_locals():
    # dtype var bound to a lo tier, tensor var bound to the lo-cast value:
    # the matmul two hops away must still be flagged
    src = """
    def f(a, b, policy):
        wire = policy.lo
        aq = a.to(wire)
        return torch.matmul(aq, b)
    """
    assert "accum-dtype" in rules(lint(src, RUNTIME))


def test_hi_matmul_clean():
    src = """
    def f(a, b):
        return torch.matmul(a, b) + a @ b.mT
    """
    assert lint(src, RUNTIME) == []


@pytest.mark.parametrize("call", [
    "a.to(lo).matmul(b)", "torch.bmm(x, a.bfloat16().transpose(-1, -2))",
    "c.addmm(a.to(policy.lo2), b)",
    "torch.einsum('ij,jk->ik', a.to(torch.float16), b)"])
def test_matmul_family_forms_flagged(call):
    # (a narrow literal is a no-implicit-downcast finding as well)
    assert rules(lint(f"def f(a, b, c, x, lo, policy):\n    return {call}\n",
                      RUNTIME)).count("accum-dtype") == 1


@pytest.mark.parametrize("value, bad", [("False", False), ("True", True),
                                        ("old", True)])
def test_reduced_precision_reduction_flag(value, bad):
    src = (f"torch.backends.cuda.matmul."
           f"allow_bf16_reduced_precision_reduction = {value}\n")
    assert rules(lint(src, RUNTIME)) == (["accum-dtype"] if bad else [])


# ---- tf32-guard: Python ---------------------------------------------------

def test_allow_tf32_not_false_flagged():
    fs = lint("torch.backends.cuda.matmul.allow_tf32 = True\n", RUNTIME)
    assert rules(fs) == ["tf32-guard"]
    assert "TF32" in fs[0].message
    assert rules(lint("torch.backends.cudnn.allow_tf32 = flag\n", RUNTIME)) \
        == ["tf32-guard"]


def test_require_ieee_fp32_idiom_clean():
    # core/precision.py's require_ieee_fp32 idiom
    src = """
    def require_ieee_fp32():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    """
    assert lint(src, RUNTIME) == []


def test_float32_matmul_precision_highest_only():
    assert lint("torch.set_float32_matmul_precision('highest')\n",
                RUNTIME) == []
    assert rules(lint("torch.set_float32_matmul_precision('high')\n",
                      RUNTIME)) == ["tf32-guard"]
    assert rules(lint("torch.backends.cuda.matmul.fp32_precision = 'tf32'\n",
                      RUNTIME)) == ["tf32-guard"]


def test_fp64_literal_not_a_tf32_finding():
    # fp64 is real fp64 in torch: an fp64 literal is no tf32-guard finding
    assert lint("x = torch.float64\ny = a.to(torch.float64)\n", RUNTIME) == []


# ---- tf32-guard: Triton and CUDA -----------------------------------------

TL_DOT = """
@triton.jit
def kern(a_ptr, b_ptr):
    a = tl.load(a_ptr)
    b = tl.load(b_ptr)
    return tl.dot(a, b{kw})
"""


def test_tl_dot_ieee_clean():
    assert lint(TL_DOT.format(kw=", input_precision='ieee'"),
                "repro_torch/kernels/fixture/kernel.py") == []
    assert lint(TL_DOT.format(kw=", allow_tf32=False"), RUNTIME) == []


def test_tl_dot_default_precision_flagged():
    fs = lint(TL_DOT.format(kw=""), "repro_torch/kernels/fixture/kernel.py")
    assert rules(fs) == ["tf32-guard"]
    assert "input_precision" in fs[0].message
    # bf16 operands: no TF32 to fear
    narrow = TL_DOT.format(kw="").replace("tl.dot(a, b",
                                          "tl.dot(a.to(tl.bfloat16), "
                                          "b.to(tl.bfloat16)")
    assert "tf32-guard" not in rules(lint(narrow, RUNTIME))


WGMMA_CU = """\
// fixture: one TF32 wgmma, one fp32 FMA
__device__ void step(float* d, const float* a) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
               "{%0}, %1, %2;" : "+f"(d[0]) : "l"(a), "l"(a));
  d[1] = fmaf(a[0], a[1], d[1]);
}
"""


def test_cu_tf32_wgmma_flagged():
    fs = lint_cuda_source(WGMMA_CU, CU)
    assert [(f.rule, f.line) for f in fs] == [("tf32-guard", 3)]
    assert ".tf32" in fs[0].message and "wgmma" in fs[0].code


def test_cu_comments_clean_code_flagged():
    # the sources' "no TF32" remarks are comments, not findings; the same
    # words as code are
    for name, line in (("blocked_potrf.cu", 39), ("mp_syrk.cu", 12),
                       ("mp_syrk.cu", 895)):
        text = (SRC_ROOT / "csrc" / name).read_text().splitlines()[line - 1]
        assert "TF32" in text, (name, line)
        assert lint_cuda_source(text + "\n", CU) == []
    src = ("/* mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 */\n"
           "cublasGemmEx(h, CUBLAS_COMPUTE_32F_FAST_TF32);\n"
           "wmma::fragment<wmma::matrix_a, 16, 16, 8, "
           "wmma::precision::tf32, wmma::row_major> f;\n")
    assert [f.line for f in lint_cuda_source(src, CU)] == [2, 3]


def test_cu_pragma_suppresses_and_port_csrc_clean():
    # a .cu line pragma suppresses the scan; the port's csrc is clean
    src = WGMMA_CU.replace(
        '"{%0}, %1, %2;"', '"{%0}, %1, %2;"  // repro: disable=tf32-guard '
        '-- fixture').replace(
        ".tf32.tf32 \"\n", ".tf32.tf32 \"  // repro: disable=tf32-guard "
        "-- fixture\n")
    assert lint_cuda_source(src, CU) == []
    for path in sorted((SRC_ROOT / "csrc").glob("*.cu")):
        assert lint_cuda_source(path.read_text(), path.name) == [], path


# ---- kernel-contract: ops.py <-> ref.py conformance -----------------------

def _kernel_pkg(tmp_path, ops_src, ref_src=None):
    root = tmp_path / "repro_torch"
    pkg = root / "kernels" / "myk"
    pkg.mkdir(parents=True)
    (pkg / "ops.py").write_text(textwrap.dedent(ops_src))
    if ref_src is not None:
        (pkg / "ref.py").write_text(textwrap.dedent(ref_src))
    return pkg, root


def test_matching_kernel_pair_clean(tmp_path):
    pkg, root = _kernel_pkg(
        tmp_path,
        "def op(a, b, *, bm=8, plain=False):\n    return a\n"
        "def other(a):\n    return a\n",
        "def op_ref(a, b, *, bm=8):\n    return a\n"
        "def other(a):\n    return a\n")
    assert check_kernel_package(pkg, root) == []


def test_missing_ref_module_flagged(tmp_path):
    pkg, root = _kernel_pkg(tmp_path, "def op(a):\n    return a\n")
    fs = check_kernel_package(pkg, root)
    assert len(fs) == 1 and "missing ref.py" in fs[0].message
    assert fs[0].rule == "kernel-contract"


def test_positional_param_mismatch_flagged(tmp_path):
    pkg, root = _kernel_pkg(
        tmp_path,
        "def op(a, b):\n    return a\n",
        "def op(a):\n    return a\n")
    fs = check_kernel_package(pkg, root)
    assert len(fs) == 1 and "positional params" in fs[0].message


def test_ref_only_keyword_flagged(tmp_path):
    pkg, root = _kernel_pkg(
        tmp_path,
        "def op(a, *, bm=8):\n    return a\n",
        "def op_ref(a, *, bm=8, scale=1.0):\n    return a\n")
    fs = check_kernel_package(pkg, root)
    assert len(fs) == 1 and "ref requires keywords ['scale']" in fs[0].message


def test_unmatched_ops_flagged(tmp_path):
    pkg, root = _kernel_pkg(
        tmp_path,
        "def op(a):\n    return a\n",
        "def other_ref(a):\n    return a\n")
    fs = check_kernel_package(pkg, root)
    assert len(fs) == 1 and "no ops.py public function" in fs[0].message


def test_port_kernel_packages_conform():
    """Every kernel package of the port matches: blocked_potrf, matern_cov
    and mp_gemm by name, mp_attention through banded_decode_attention_ref
    and flash_decode_segment."""
    pkgs = sorted(p for p in (SRC_ROOT / "kernels").iterdir()
                  if p.is_dir() and not p.name.startswith("__"))
    assert [p.name for p in pkgs] == ["blocked_potrf", "matern_cov",
                                      "mp_attention", "mp_gemm"]
    for pkg in pkgs:
        assert check_kernel_package(pkg, SRC_ROOT) == [], pkg


# ---- baseline mechanics ---------------------------------------------------

def _finding(code, rule="no-implicit-downcast", path="repro_torch/x/y.py"):
    return Finding(rule, path, 3, "msg", code)


def test_baseline_rejects_todo_reasons(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"findings": [
        {"rule": "tf32-guard", "path": "a.py", "code": "x = 1",
         "reason": "TODO: justify this suppression"}]}))
    with pytest.raises(ValueError, match="TODO"):
        load_baseline(p)


def test_baseline_rejects_empty_reasons(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"findings": [
        {"rule": "tf32-guard", "path": "a.py", "code": "x = 1",
         "reason": "  "}]}))
    with pytest.raises(ValueError, match="empty"):
        load_baseline(p)


def test_split_matches_on_whitespace_normalized_code():
    entries = [{"rule": "no-implicit-downcast", "path": "repro_torch/x/y.py",
                "code": "x = a.to(torch.bfloat16)", "reason": "legacy"}]
    f = _finding("x  =  a.to(torch.bfloat16)")
    new, old, unused = split_baselined([f], entries)
    assert (new, old, unused) == ([], [f], [])


def test_split_reports_new_and_unused():
    entries = [{"rule": "no-implicit-downcast", "path": "repro_torch/x/y.py",
                "code": "gone = 1", "reason": "legacy"}]
    f = _finding("x = a.to(torch.bfloat16)")
    new, old, unused = split_baselined([f], entries)
    assert new == [f] and old == [] and unused == entries


def test_update_baseline_preserves_reasons(tmp_path):
    p = tmp_path / "baseline.json"
    update_baseline([_finding("x = 1")], p)
    data = json.loads(p.read_text())
    assert data["findings"][0]["reason"].startswith("TODO")
    data["findings"][0]["reason"] = "a real reason"
    p.write_text(json.dumps(data))
    update_baseline([_finding("x = 1"), _finding("y = 2")], p)
    reasons = {e["code"]: e["reason"]
               for e in json.loads(p.read_text())["findings"]}
    assert reasons["x = 1"] == "a real reason"
    assert reasons["y = 2"].startswith("TODO")


# ---- the port itself ------------------------------------------------------

def test_repo_at_head_is_clean_modulo_baseline():
    new, old, unused = split_baselined(lint_tree(SRC_ROOT), load_baseline())
    assert new == [], "\n".join(f.render() for f in new)
    assert unused == [], "stale baseline entries: " + repr(unused)
    # the reference's three int8 KV entries, and the optimizer's readout
    assert sorted((f.path, f.rule) for f in old) == [
        ("repro_torch/core/mle.py", "no-implicit-downcast"),
        ("repro_torch/kernels/mp_attention/ops.py", "no-implicit-downcast"),
        ("repro_torch/kernels/mp_attention/ops.py", "no-implicit-downcast"),
        ("repro_torch/models/decode.py", "no-implicit-downcast")]


def test_seeded_violation_in_core_engine_is_caught():
    src = (SRC_ROOT / "core" / "tile_cholesky.py").read_text()
    assert lint_source(src, "repro_torch/core/tile_cholesky.py") == []
    seeded = src + ("\n\ndef _seeded(l_kk):\n"
                    "    return l_kk.to(torch.float32)\n")
    fs = lint_source(seeded, "repro_torch/core/tile_cholesky.py")
    assert rules(fs) == ["no-implicit-downcast"]


def _distributed_src():
    return (SRC_ROOT / "core" / "distributed.py").read_text()


def test_distributed_lo_product_without_its_pragma_is_a_finding():
    """The bf16-operand product in lo_product is an accum-dtype finding
    that only its pragma (naming the guard) suppresses."""
    src = _distributed_src()
    rel = "repro_torch/core/distributed.py"
    assert lint_source(src, rel) == []
    bare = src.replace("  # repro: disable=accum-dtype -- under "
                       "_fp32_reductions()", "")
    assert bare != src
    fs = lint_source(bare, rel)
    assert rules(fs) == ["accum-dtype"]
    assert "a.to(lo)" in fs[0].code
    tree = ast.parse(bare)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "lo_product")
    assert fn.lineno < fs[0].line <= fn.end_lineno


def _calls_outside_guard(path):
    """lo_product calls in a module not lexically inside `with
    _fp32_reductions():` (or `with guard:` where guard is bound to it)."""
    tree = ast.parse(Path(path).read_text())
    parents = {id(c): p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
    guards = {"_fp32_reductions"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(s, ast.Call) and getattr(s.func, "id", getattr(
                    s.func, "attr", None)) == "_fp32_reductions"
                for s in ast.walk(node.value)):
            guards |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    bad = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None))
                == "lo_product"):
            continue
        held, cur = False, parents.get(id(node))
        while cur is not None and not held:
            if isinstance(cur, ast.With):
                for item in cur.items:
                    ce = item.context_expr
                    name = ce.func if isinstance(ce, ast.Call) else ce
                    name = getattr(name, "id", getattr(name, "attr", None))
                    held |= name in guards
            cur = parents.get(id(cur))
        if not held:
            bad.append(node.lineno)
    return bad


def test_every_lo_product_caller_holds_the_guard():
    """The pragma's reason: every call of lo_product in the port and in
    chip_smoke.py runs under _fp32_reductions()."""
    callers = [p for p in sorted(SRC_ROOT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
               if "lo_product(" in p.read_text()]
    assert SRC_ROOT / "core" / "distributed.py" in callers
    for path in callers:
        src = path.read_text()
        n_calls = src.count("lo_product(") - src.count("def lo_product(")
        assert n_calls >= 1 or path.name == "distributed.py"
        assert _calls_outside_guard(path) == [], path


def test_allow_reduced_restore_needs_its_pragma():
    src = _distributed_src().replace(
        "  # repro: disable=accum-dtype -- restores the caller's setting", "")
    fs = lint_source(src, "repro_torch/core/distributed.py")
    assert rules(fs) == ["accum-dtype"]
    assert "allow_bf16_reduced_precision_reduction" in fs[0].message


# ---- CLI gate -------------------------------------------------------------

def test_check_gate_green_at_head(capsys):
    assert main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "static analysis: OK" in out
    for layer in ("lint:", "dag:", "sched-replay:"):
        assert layer in out


def test_lint_gate_fails_on_seeded_tree(tmp_path, capsys):
    bad_root = tmp_path / "repro_torch"
    (bad_root / "core").mkdir(parents=True)
    (bad_root / "core" / "bad.py").write_text(
        "def f(a):\n    return a.to(torch.float32)\n")
    assert run_lint(bad_root) == 1
    assert main(["--lint-only", "--root", str(bad_root),
                 "--device", "cpu"]) == 1
    assert "no-implicit-downcast" in capsys.readouterr().out


SEEDS = {
    "no-implicit-downcast": ("core/bad.py", "def f(a):\n"
                             "    return a.to(torch.bfloat16)\n"),
    "accum-dtype": ("models/bad.py", "def f(a, b, policy):\n"
                    "    return a.to(policy.lo) @ b\n"),
    "tf32-guard": ("csrc/bad.cu", WGMMA_CU),
    "kernel-contract": ("kernels/bad/ops.py", "def op(a):\n    return a\n"),
    "obs-span-context": ("models/span.py", "obs.span('a')\n"),
}


@pytest.mark.parametrize("rule", RULES)
def test_seeded_violation_of_each_rule_fails_the_gate(rule, tmp_path, capsys):
    root = tmp_path / "repro_torch"
    rel, src = SEEDS[rule]
    (root / rel).parent.mkdir(parents=True)
    (root / rel).write_text(src)
    assert rules(lint_tree(root)) == [rule]
    assert main(["--lint-only", "--root", str(root), "--device", "cpu"]) == 1
    assert f"[{rule}]" in capsys.readouterr().out


# ---- obs-span-context -----------------------------------------------------

def test_context_managed_span_clean():
    assert lint("with obs.span('a', x=1):\n    pass\n", RUNTIME) == []


def test_context_managed_maybe_span_with_as_clean():
    assert lint("with obs.maybe_span('a', arr) as sp:\n    pass\n",
                RUNTIME) == []


def test_bare_span_call_flagged():
    fs = lint("obs.span('a', x=1)\n", RUNTIME)
    assert rules(fs) == ["obs-span-context"]
    assert "context-managed" in fs[0].message


def test_span_assigned_to_variable_flagged():
    assert rules(lint("sp = obs.maybe_span('a', arr)\n", RUNTIME)) \
        == ["obs-span-context"]


def test_enter_context_span_clean():
    assert lint("sp = stack.enter_context(obs.span('a'))\n", RUNTIME) == []


def test_span_rule_exempt_in_obs_package():
    assert lint("def span(name):\n    return _R.span(name)\n",
                "repro_torch/obs/fixture.py") == []


def test_span_pragma_suppresses():
    src = "obs.span('a')  # repro: disable=obs-span-context -- test\n"
    assert lint(src, RUNTIME) == []


def test_variable_named_span_not_flagged():
    # a local named `span` that is never *called* is not a telemetry leak
    assert lint("span = (hi - lo) * 0.4\n", RUNTIME) == []


def test_span_rule_parity_with_reference_tree():
    """The port's obs-span-context over the reference's own src/repro gives
    the reference linter's (path, line) findings for that rule."""
    from repro.analysis.lint import lint_tree as ref_lint_tree
    ref_root = ROOT / "src" / "repro"
    want = sorted((f.path, f.line) for f in ref_lint_tree(ref_root)
                  if f.rule == "obs-span-context")
    got = sorted((f.path, f.line) for f in lint_tree(ref_root)
                 if f.rule == "obs-span-context")
    assert got == want
    # and on seeded spans in the reference's style
    seeded = "def f():\n    obs.span('a')\n    with obs.span('b'):\n        pass\n"
    from repro.analysis.lint import lint_source as ref_lint_source
    for rel in ("repro/core/x.py", "repro/obs/x.py"):
        assert [(f.rule, f.line) for f in lint_source(seeded, rel)
                if f.rule == "obs-span-context"] == [
            (f.rule, f.line) for f in ref_lint_source(seeded, rel)
            if f.rule == "obs-span-context"]


# ---- stale-baseline gate --------------------------------------------------

def _stale_entry(rule="no-implicit-downcast"):
    return {"rule": rule, "path": "repro_torch/x/gone.py",
            "code": "x = a.to(torch.bfloat16)", "reason": "legacy"}


def test_stale_baseline_entry_fails_check(monkeypatch, capsys):
    from repro_torch.analysis import cli

    monkeypatch.setattr(cli, "load_baseline",
                        lambda: load_baseline() + [_stale_entry()])
    assert cli.run_lint(SRC_ROOT) == 1
    out = capsys.readouterr().out
    assert "STALE BASELINE" in out and "gone.py" in out


def test_allow_stale_baseline_downgrades_to_note(monkeypatch, capsys):
    from repro_torch.analysis import cli

    monkeypatch.setattr(cli, "load_baseline",
                        lambda: load_baseline() + [_stale_entry()])
    assert cli.run_lint(SRC_ROOT, allow_stale=True) == 0
    out = capsys.readouterr().out
    assert "note" in out and "STALE BASELINE" not in out


def test_inactive_rule_entries_never_stale(monkeypatch):
    """A lockguard-rule entry is not stale in a lint-only run (the rule
    didn't execute), but IS stale once --concurrency runs it."""
    from repro_torch.analysis import cli

    monkeypatch.setattr(
        cli, "load_baseline",
        lambda: load_baseline() + [_stale_entry(rule="guarded-by")])
    assert cli.run_lint(SRC_ROOT) == 0                      # rule inactive
    assert cli.run_lint(SRC_ROOT, concurrency=True) == 1    # rule active


def test_concurrency_only_cli_flags(capsys):
    assert main(["--concurrency-only", "--verbose", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "hb:" in out and "interleave:" in out
    assert "static analysis: OK" in out
