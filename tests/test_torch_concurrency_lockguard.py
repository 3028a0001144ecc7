"""The port's lock-discipline linter
(repro_torch.analysis.concurrency.lockguard), the counterparts of
tests/test_concurrency_lockguard.py.

Each rule gets a bad/good snippet pair (lock-dispatch in torch and CUDA
idiom: torch calls, kernels.run, stream and event calls and host syncs
under the lock); the port's annotated sources at HEAD must be clean; a
seeded mutant of the port's executor (one ``with state.cond:`` removed)
must be caught; a seeded violation of each rule fails the gate; and for
guarded-by and cv-wait-loop the port's linter gives the reference's
findings on the reference's own files and on its test's mutants.
"""

import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.cli import SRC_ROOT
from repro_torch.analysis.concurrency.lockguard import (
    LOCKGUARD_FILES,
    LOCKGUARD_RULES,
    guarded_registry,
    lockguard_files,
    lockguard_source,
)

torch.set_num_threads(1)

REF_ROOT = Path(__file__).resolve().parents[1] / "src" / "repro"


def lint(src: str):
    return lockguard_source(textwrap.dedent(src), "repro_torch/fixture.py")


def rules(findings):
    return [f.rule for f in findings]


GUARDED = """
import threading

class S:
    def __init__(self):
        self.lock = threading.Lock()
        self.items = []        # repro: guarded-by=lock
        self.count = 0         # repro: guarded-by=lock
"""


# ---- registry -------------------------------------------------------------

def test_registry_extracted_from_annotations():
    reg = guarded_registry(textwrap.dedent(GUARDED))
    assert reg == {"items": "lock", "count": "lock"}


def test_registry_empty_without_annotations():
    assert guarded_registry("x = 1\n") == {}


# ---- guarded-by -----------------------------------------------------------

def test_unguarded_append_flagged():
    fs = lint(GUARDED + """
    def add(self, x):
        self.items.append(x)
""")
    assert rules(fs) == ["guarded-by"]
    assert "items" in fs[0].message


def test_unguarded_assignment_flagged():
    fs = lint(GUARDED + """
    def bump(self):
        self.count += 1
""")
    assert rules(fs) == ["guarded-by"]


def test_unguarded_subscript_flagged():
    fs = lint(GUARDED + """
    def set(self, i, v):
        self.items[i] = v
""")
    assert rules(fs) == ["guarded-by"]


def test_unguarded_heappush_flagged():
    fs = lint("import heapq\n" + GUARDED + """
    def push(self, x):
        heapq.heappush(self.items, x)
""")
    assert rules(fs) == ["guarded-by"]


def test_guarded_mutation_clean():
    assert lint(GUARDED + """
    def add(self, x):
        with self.lock:
            self.items.append(x)
            self.count += 1
""") == []


def test_init_exempt():
    """Construction happens-before publication: __init__ needs no lock."""
    assert lint(GUARDED) == []


def test_locked_helper_exempt_but_call_site_checked():
    src = GUARDED + """
    def _add_locked(self, x):
        self.items.append(x)

    def good(self, x):
        with self.lock:
            self._add_locked(x)

    def bad(self, x):
        self._add_locked(x)
"""
    fs = lint(src)
    assert rules(fs) == ["guarded-by"]
    assert "_add_locked" in fs[0].message


def test_condition_guards_cond_annotated_attrs():
    """`with state.cond:` satisfies guarded-by=cond (Condition over lock)."""
    assert lint("""
import threading

class St:
    def __init__(self):
        self.cond = threading.Condition()
        self.q = []    # repro: guarded-by=cond

def worker(state):
    with state.cond:
        state.q.append(1)
""") == []


def test_pragma_suppresses():
    fs = lint(GUARDED + """
    def add(self, x):
        self.items.append(x)  # repro: disable=guarded-by -- test fixture
""")
    assert fs == []


def test_stream_context_is_not_the_lock():
    """A `*_locked` helper called under `with torch.cuda.stream(s):` only
    (the executor's worker context) is outside the registered lock."""
    fs = lint("""
import threading

class St:
    def __init__(self):
        self.cond = threading.Condition()
        self.q = []    # repro: guarded-by=cond

def _push_locked(state, x):
    state.q.append(x)

def worker(state, stream):
    with torch.cuda.stream(stream):
        _push_locked(state, 1)
        with state.cond:
            _push_locked(state, 2)
""")
    assert [(f.rule, f.code) for f in fs] == [("guarded-by",
                                               "_push_locked(state, 1)")]


# ---- cv-wait-loop ---------------------------------------------------------

def test_if_guarded_wait_flagged():
    fs = lint("""
import threading

class S:
    def __init__(self):
        self.cond = threading.Condition()
        self.q = []    # repro: guarded-by=cond

    def get(self):
        with self.cond:
            if not self.q:
                self.cond.wait()
            return self.q.pop()  # repro: disable=guarded-by -- fixture
""")
    assert rules(fs) == ["cv-wait-loop"]


def test_while_guarded_wait_clean():
    assert lint("""
import threading

class S:
    def __init__(self):
        self.cond = threading.Condition()
        self.q = []    # repro: guarded-by=cond

    def get(self):
        with self.cond:
            while not self.q:
                self.cond.wait()
""") == []


def test_wait_for_clean():
    """Condition.wait_for re-checks its predicate internally."""
    assert lint("""
import threading

class S:
    def __init__(self):
        self.cond = threading.Condition()
        self.q = []    # repro: guarded-by=cond

    def get(self):
        with self.cond:
            self.cond.wait_for(lambda: self.q)
""") == []


# ---- lock-dispatch --------------------------------------------------------

def test_torch_call_under_lock_flagged():
    fs = lint("""
import threading
import torch

class S:
    def __init__(self):
        self.lock = threading.Lock()
        self.out = []    # repro: guarded-by=lock

    def work(self, x):
        with self.lock:
            self.out.append(torch.tril(x))
""")
    assert rules(fs) == ["lock-dispatch"]


def test_synchronize_under_lock_flagged():
    fs = lint("""
import threading

class S:
    def __init__(self):
        self.lock = threading.Lock()
        self.out = []    # repro: guarded-by=lock

    def work(self, ev):
        with self.lock:
            ev.synchronize()
""")
    assert rules(fs) == ["lock-dispatch"]


def test_kernels_run_under_lock_flagged():
    fs = lint("""
import threading

class S:
    def __init__(self):
        self.lock = threading.Lock()
        self.out = []    # repro: guarded-by=lock

def work(state, kernels, task, ops):
    with state.lock:
        state.out.append(kernels.run(task, ops))
""")
    assert rules(fs) == ["lock-dispatch"]


def test_dispatch_outside_lock_clean():
    assert lint("""
import threading
import torch

class S:
    def __init__(self):
        self.lock = threading.Lock()
        self.out = []    # repro: guarded-by=lock

    def work(self, x):
        y = torch.tril(x)
        with self.lock:
            self.out.append(y)
""") == []


def test_dispatch_under_unregistered_lock_clean():
    """Only locks named by the guarded-by registry serialize the pool."""
    assert lint("""
import threading
import torch

other = threading.Lock()

def work(x):
    with other:
        return torch.tril(x)
""") == []


@pytest.mark.parametrize("call", [
    "stream.wait_event(ev)", "ev.record(stream)", "x.record_stream(stream)",
    "x.item()", "x.cpu()", "x.tolist()", "torch.cuda.Event()"])
def test_stream_event_and_host_sync_calls_under_lock_flagged(call):
    fs = lint(f"""
import threading

class S:
    def __init__(self):
        self.cond = threading.Condition()
        self.out = []    # repro: guarded-by=cond

def work(state, stream, ev, x):
    with state.cond:
        {call}
""")
    assert rules(fs) == ["lock-dispatch"]


def test_locked_helper_body_runs_under_the_lock():
    """A `*_locked` function's body is under its caller's lock: device work
    there is a finding, as it would be lexically inside the `with`."""
    fs = lint("""
import threading

class S:
    def __init__(self):
        self.cond = threading.Condition()
        self.out = []    # repro: guarded-by=cond

def _publish_locked(state, out):
    state.out.append(out)
    out.record_stream(state.stream)
""")
    assert rules(fs) == ["lock-dispatch"]


# ---- the port itself ------------------------------------------------------

def test_repo_sources_clean():
    assert lockguard_files(SRC_ROOT) == []


def test_registered_files_have_annotations():
    for rel in LOCKGUARD_FILES:
        src = (SRC_ROOT.parent / rel).read_text()
        assert guarded_registry(src), f"{rel} lost its guarded-by registry"
    # the executor's shared state: the reference's seven fields and the
    # port's four more
    reg = guarded_registry((SRC_ROOT / "sched" / "runtime.py").read_text())
    assert reg == {f: "cond" for f in (
        "ndeps", "ready", "values", "done", "dispatch", "events", "error",
        "published", "uses", "initial_uses", "running", "last_end")}


def test_missing_registered_file_is_a_finding(tmp_path):
    fake_root = tmp_path / "repro_torch"
    fake_root.mkdir()
    fs = lockguard_files(fake_root)
    assert fs and all(f.rule == "guarded-by" for f in fs)
    assert "missing" in fs[0].message


def _executor_mutant():
    src = (SRC_ROOT / "sched" / "runtime.py").read_text()
    needle = "with state.cond:"
    assert needle in src, "executor no longer uses `with state.cond:`"
    lines = src.splitlines(keepends=True)
    hit = next(i for i, ln in enumerate(lines) if needle in ln)
    lines[hit] = lines[hit].replace(needle, "if True:")
    return "".join(lines)


def test_mutated_executor_caught():
    """Remove one `with state.cond:` from the port's executor source: the
    mutations it guarded, and the `*_locked` calls it held, become
    findings."""
    fs = lockguard_source(_executor_mutant(), "repro_torch/sched/runtime.py")
    assert fs, "removing a lock block produced no findings"
    assert {f.rule for f in fs} <= set(LOCKGUARD_RULES)
    assert any(f.rule == "guarded-by" for f in fs)
    msgs = " ".join(f.message for f in fs)
    assert "_publish_locked" in msgs and "_fetch_locked" in msgs


def test_mutated_recorder_caught():
    src = (SRC_ROOT / "obs" / "recorder.py").read_text()
    needle = "with self._lock:"
    # first occurrence in actual code, not the class docstring
    at = src.index(needle, src.index("def _finish"))
    mutant = src[:at] + "if True:" + src[at + len(needle):]
    fs = lockguard_source(mutant, "repro_torch/obs/recorder.py")
    assert any(f.rule == "guarded-by" for f in fs)


# ---- baseline integration -------------------------------------------------

def test_lockguard_findings_flow_through_baseline(monkeypatch, capsys):
    """An unbaselined lockguard finding fails `--check --concurrency-only`
    via the shared lint gate (seeded by breaking a registered file)."""
    from repro_torch.analysis import cli

    real = lockguard_files

    def broken(root, files=LOCKGUARD_FILES):
        from repro_torch.analysis.lint import Finding
        return real(root, files) + [Finding(
            "guarded-by", "repro_torch/sched/runtime.py", 1, "seeded",
            "x = 1")]

    monkeypatch.setattr(
        "repro_torch.analysis.concurrency.lockguard.lockguard_files", broken)
    rc = cli.run_lint(SRC_ROOT, concurrency=True)
    assert rc == 1
    assert "seeded" in capsys.readouterr().out


# a wait the executor's `while True:` loop does not enclose: turning the
# worker's `while not state.ready:` into an `if` leaves its wait inside
# that outer loop, which the rule (and the reference's) accepts
IF_WAIT = """

def _seeded_wait(state):
    with state.cond:
        if not state.ready:
            state.cond.wait()
"""

MUTANTS = {
    "guarded-by": ("sched/runtime.py", _executor_mutant),
    "cv-wait-loop": ("sched/runtime.py", lambda: (
        SRC_ROOT / "sched" / "runtime.py").read_text() + IF_WAIT),
    "lock-dispatch": ("sched/runtime.py", lambda: (
        SRC_ROOT / "sched" / "runtime.py").read_text().replace(
        "ops, sources = _fetch_locked(state, idx)",
        "ops, sources = _fetch_locked(state, idx); torch.cuda.synchronize()")),
}


@pytest.mark.parametrize("rule", LOCKGUARD_RULES)
def test_seeded_violation_of_each_rule_fails_the_gate(rule, tmp_path,
                                                      monkeypatch, capsys):
    """A copy of the two registered files, one of them mutated, under a
    seeded root: `python -m repro_torch.analysis --concurrency-only`'s lint
    layer fails with that rule's finding."""
    from repro_torch.analysis import cli

    root = tmp_path / "repro_torch"
    rel, mutate = MUTANTS[rule]
    for reg in LOCKGUARD_FILES:
        path = root / Path(reg).relative_to("repro_torch")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text((SRC_ROOT.parent / reg).read_text())
    mutant = mutate()
    assert mutant != (SRC_ROOT / rel).read_text()
    (root / rel).write_text(mutant)
    assert rule in rules(lockguard_files(root))
    monkeypatch.setattr(cli, "SRC_ROOT", root)
    assert cli.run_lint(SRC_ROOT, concurrency=True) == 1
    assert f"[{rule}]" in capsys.readouterr().out


# ---- parity with the reference's linter -----------------------------------

def _ref_sources():
    from repro.analysis.concurrency.lockguard import (
        LOCKGUARD_FILES as REF_FILES)
    return {rel: (REF_ROOT.parent / rel).read_text() for rel in REF_FILES}


def _ref_mutants():
    """The reference test's two mutants, built from the reference sources
    as it builds them."""
    srcs = _ref_sources()
    out = dict(srcs)
    rt = srcs["repro/sched/runtime.py"]
    lines = rt.splitlines(keepends=True)
    hit = next(i for i, ln in enumerate(lines) if "with state.cond:" in ln)
    lines[hit] = lines[hit].replace("with state.cond:", "if True:")
    out["repro/sched/runtime.py#mutant"] = "".join(lines)
    rec = srcs["repro/obs/recorder.py"]
    at = rec.index("with self._lock:", rec.index("def _finish"))
    out["repro/obs/recorder.py#mutant"] = (
        rec[:at] + "if True:" + rec[at + len("with self._lock:"):])
    return out


@pytest.mark.parametrize("rule", ("guarded-by", "cv-wait-loop"))
def test_parity_with_reference_on_its_files_and_mutants(rule):
    from repro.analysis.concurrency.lockguard import (
        lockguard_source as ref_lockguard_source)
    for name, src in _ref_mutants().items():
        rel = name.split("#")[0]
        want = [(f.rule, f.line, f.code) for f in
                ref_lockguard_source(src, rel) if f.rule == rule]
        got = [(f.rule, f.line, f.code) for f in
               lockguard_source(src, rel) if f.rule == rule]
        assert got == want, name
        if name.endswith("#mutant") and rule == "guarded-by":
            assert got, name


def test_parity_cv_wait_loop_on_a_reference_mutant():
    from repro.analysis.concurrency.lockguard import (
        lockguard_source as ref_lockguard_source)
    mutant = _ref_sources()["repro/sched/runtime.py"] + IF_WAIT
    want = [(f.rule, f.line) for f in ref_lockguard_source(mutant, "x")
            if f.rule in ("guarded-by", "cv-wait-loop")]
    got = [(f.rule, f.line) for f in lockguard_source(mutant, "x")
           if f.rule in ("guarded-by", "cv-wait-loop")]
    assert got == want and ("cv-wait-loop", got[0][1]) in got
