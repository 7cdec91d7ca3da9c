"""AST rules engine for the CUDA/H100-aware static analyzer (counterpart of
``orp_tpu/lint/engine.py``; ``python -m orp_tpu_torch.lint``).

The classic CUDA-graph and PyTorch failure modes — a hidden host sync
inside a captured region, a capture rebuilt per request, TF32 or f64 drift,
unseeded draws — are invisible to tier-1 tests (which run on the CPU) until
a card run is mysteriously slow, refuses to capture, or is numerically off.
This engine turns each of them into a per-commit static check:

- a **capture index** (pass 1) maps every function in a module that runs
  inside a CUDA-graph capture or the fused walk's date loop — the bodies
  reached from ``with torch.cuda.graph(...)``, ``CUDAGraph.capture_begin``
  .. ``capture_end``, ``aot_compile(fn, ...)`` /
  ``torch.cuda.make_graphed_callables(fn, ...)`` and
  ``with fused_loop_scope(...)`` — so rules can reason about
  "capture-reachable" code (the JAX package's jit index answers the same
  question for jitted code);
- **rules** (orp_tpu_torch/lint/rules.py) walk the tree with that index and
  yield findings;
- per-line ``# orp: noqa[RULE]`` comments suppress intentional sites (bare
  ``# orp: noqa`` suppresses every rule on the line); a suppression should
  carry a reason, e.g. ``# orp: noqa[ORP001] -- serialization table``;
- output is human ``path:line:col CODE message`` lines or a versioned
  ``--json`` document (``format_json``) for CI tooling.

The analyzer is intra-module by design: body rules (ORP002/ORP006) apply
where the captured def is visible — a call inside a capture region resolves
to a function or method of the same module by its terminal name. That
covers this codebase's real layout (each capture site captures its own
class's ``epoch`` / ``iterate`` or a local closure) without a whole-program
call graph. The rule codes, the ``noqa`` grammar, the JSON and SARIF
documents and the CLI's exit codes are the JAX package's.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Callable, Iterable, Iterator

JSON_SCHEMA_VERSION = 1

NOQA_RE = re.compile(r"#\s*orp:\s*noqa(?:\[(?P<codes>[A-Z0-9,\s]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.rule} {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    summary: str
    check: Callable[["FileContext"], Iterator[Finding]]


RULES: dict[str, Rule] = {}


def rule(code: str, summary: str):
    """Register a rule. ``check(ctx)`` yields ``Finding``s for one file."""

    def deco(fn):
        RULES[code] = Rule(code, summary, fn)
        return fn

    return deco


def walk_scope(root: ast.AST):
    """``ast.walk`` that stays in ``root``'s own scope: yields ``root`` and
    its descendants but does not descend into nested function/lambda bodies
    (those run in their own scope, usually at another time entirely)."""
    yield root
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` attribute/name chain as a string, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_GRAPH_CTX = {"torch.cuda.graph", "cuda.graph", "graph"}
_LOOP_SCOPES = {"fused_loop_scope", "backward.fused_loop_scope",
                "bw.fused_loop_scope", "_bw.fused_loop_scope"}
_CAPTURE_FN_CALLS = {"aot_compile", "compile.aot_compile",
                     "torch.cuda.make_graphed_callables"}


@dataclasses.dataclass
class CaptureSite:
    """One place code is captured into a CUDA graph (or run inside the fused
    walk's sync-free date loop)."""

    node: ast.AST             # the node to anchor findings on
    enclosing: ast.AST | None  # the def the site sits in (None: module level)
    targets: set[str]          # terminal names of the calls it captures


def _call_tails(nodes) -> set[str]:
    """Terminal names of every call under ``nodes`` (``self.epoch()`` ->
    ``epoch``), pruning nested function bodies (deferred code)."""
    out: set[str] = set()
    stack = list(nodes)
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Call):
            d = dotted(n.func)
            tail = (d.split(".")[-1] if d is not None
                    else getattr(n.func, "attr", None))
            if tail:
                out.add(tail)
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))
    return out


class CaptureIndex:
    """Pass 1 over a module: every capture site, resolved to local defs."""

    def __init__(self, tree: ast.Module):
        self.sites: list[CaptureSite] = []
        self._defs: dict[str, list[ast.FunctionDef]] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._defs.setdefault(node.name, []).append(node)
        self._collect(tree, None)
        self._captured: dict[ast.FunctionDef, CaptureSite] = {}
        for site in self.sites:
            for name in site.targets:
                for fdef in self._defs.get(name, ()):
                    if fdef is not site.enclosing:
                        self._captured.setdefault(fdef, site)

    def _collect(self, node: ast.AST, enclosing) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._collect(child, child)
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    ctx = item.context_expr
                    # ``with fused_loop_scope(dev) if fused else nullcontext():``
                    options = ([ctx.body, ctx.orelse] if isinstance(ctx, ast.IfExp)
                               else [ctx])
                    if any(isinstance(c, ast.Call) and (dotted(c.func) in _GRAPH_CTX
                                                        or dotted(c.func) in _LOOP_SCOPES)
                           for c in options):
                        self.sites.append(CaptureSite(
                            ctx, enclosing, _call_tails(child.body)))
            elif isinstance(child, ast.Call):
                d = dotted(child.func)
                if d in _CAPTURE_FN_CALLS and child.args:
                    target = dotted(child.args[0])
                    if target is not None:
                        self.sites.append(CaptureSite(
                            child, enclosing, {target.split(".")[-1]}))
            elif isinstance(child, ast.Expr) and _is_capture_begin(child.value):
                self.sites.append(CaptureSite(
                    child.value, enclosing, _between_capture(node, child)))
            self._collect(child, enclosing)

    # -- queries -------------------------------------------------------------

    def captured_defs(self) -> dict[ast.FunctionDef, CaptureSite]:
        """Defs in this module that some site captures (or runs inside the
        fused walk's loop)."""
        return self._captured

    def capture_reachable_defs(self) -> dict[ast.FunctionDef, CaptureSite]:
        """Captured defs plus every def nested inside one (captured with it)."""
        out = dict(self._captured)
        for fdef, site in self._captured.items():
            for sub in ast.walk(fdef):
                if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and sub is not fdef):
                    out.setdefault(sub, site)
        return out

    def captured_callable_names(self) -> set[str]:
        """Every name a captured callable is known by in this module."""
        return {name for site in self.sites for name in site.targets}


def _is_capture_begin(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "capture_begin")


def _between_capture(parent: ast.AST, begin: ast.stmt) -> set[str]:
    """Call tails of the statements after ``begin`` up to the sibling that
    calls ``capture_end``."""
    for field in ("body", "orelse", "finalbody"):
        body = getattr(parent, field, None)
        if isinstance(body, list) and begin in body:
            rest = body[body.index(begin) + 1:]
            stop = next((i for i, s in enumerate(rest)
                         if "capture_end" in _call_tails([s])), len(rest))
            return _call_tails(rest[:stop]) - {"capture_end"}
    return set()


def params_of(fdef: ast.FunctionDef) -> list[str]:
    """The parameters of a def that may hold a tensor: ``self``/``cls`` left
    out, and so is a parameter annotated with a type that is not a tensor
    (``cfg: BackwardConfig``, ``flag: bool``) or defaulting to a constant
    (``mesh=None``) — the host values a capture is specialised on, as the
    JAX package's static arguments are."""
    a = fdef.args
    positional = [*a.posonlyargs, *a.args]
    defaults = dict(zip([p.arg for p in positional][len(positional) - len(a.defaults):],
                        a.defaults))
    defaults.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None})
    out = []
    for p in (*positional, *a.kwonlyargs):
        if p.arg in ("self", "cls"):
            continue
        if p.annotation is not None and "Tensor" not in ast.unparse(p.annotation):
            continue
        if isinstance(defaults.get(p.arg), ast.Constant):
            continue
        out.append(p.arg)
    return out


@dataclasses.dataclass
class FileContext:
    path: str
    source: str
    tree: ast.Module
    lines: list[str]
    capture: CaptureIndex

    def finding(self, node: ast.AST, code: str, message: str) -> Finding:
        return Finding(
            self.path, getattr(node, "lineno", 1),
            getattr(node, "col_offset", 0), code, message,
        )

    def suppressed(self, f: Finding) -> bool:
        if not 1 <= f.line <= len(self.lines):
            return False
        m = NOQA_RE.search(self.lines[f.line - 1])
        if m is None:
            return False
        codes = m.group("codes")
        if codes is None:
            return True  # bare noqa: every rule
        return f.rule in {c.strip() for c in codes.split(",")}


def lint_source(
    source: str, path: str = "<source>", select: Iterable[str] | None = None
) -> list[Finding]:
    """Lint one module's source text; returns unsuppressed findings sorted by
    (line, col, rule). ``select`` limits to the given rule codes."""
    # validate the selection BEFORE parsing: a typo'd rule code must fail
    # loudly even when the first linted file has a syntax error
    codes = set(select) if select is not None else set(RULES)
    unknown = codes - set(RULES)
    if unknown:
        raise ValueError(
            f"unknown rule(s) {sorted(unknown)}; known: {sorted(RULES)}"
        )
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, e.offset or 0, "ORP000",
                        f"syntax error: {e.msg}")]
    ctx = FileContext(path, source, tree, source.splitlines(),
                      CaptureIndex(tree))
    findings: dict[tuple, Finding] = {}
    for code in sorted(codes):
        for f in RULES[code].check(ctx):
            # one finding per (line, rule): two float64 tokens on one line
            # are one fix, and one noqa should cover them
            if not ctx.suppressed(f):
                findings.setdefault((f.line, f.rule), f)
    return sorted(findings.values(), key=lambda f: (f.line, f.col, f.rule))


def iter_python_files(paths: Iterable[str | pathlib.Path]) -> Iterator[pathlib.Path]:
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            # hidden-dir filter applies BELOW the scanned root only: a repo
            # checked out under ~/.local/... must still lint (a filter on
            # absolute parts would silently turn the gate into a no-op)
            yield from sorted(
                f for f in p.rglob("*.py")
                if not any(part.startswith(".")
                           for part in f.relative_to(p).parts)
            )
        elif p.suffix == ".py":
            yield p
        else:
            raise FileNotFoundError(f"{p}: not a .py file or directory")


def lint_paths(
    paths: Iterable[str | pathlib.Path], select: Iterable[str] | None = None
) -> list[Finding]:
    findings: list[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(
            lint_source(f.read_text(), path=str(f), select=select)
        )
    return findings


def format_findings(findings: list[Finding]) -> str:
    if not findings:
        return "orp lint: clean"
    lines = [f.render() for f in findings]
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    by_rule = ", ".join(f"{k} x{v}" for k, v in sorted(counts.items()))
    lines.append(f"orp lint: {len(findings)} finding(s) ({by_rule})")
    return "\n".join(lines)


# the no-args default: the installed orp_tpu_torch package itself, resolved
# from this file so the lint works from ANY cwd, not just the repo root
DEFAULT_LINT_ROOT = pathlib.Path(__file__).resolve().parent.parent


def all_rule_summaries() -> dict[str, str]:
    """Every rule the lint surface knows: the per-file registry plus the
    project-wide concurrency rules (which cannot run per-file and so live
    in their own registry). Imported lazily — concurrency.py imports this
    module at its top, so the reverse edge must stay call-time."""
    from orp_tpu_torch.lint.concurrency import CONCURRENCY_RULES

    out = {code: r.summary for code, r in RULES.items()}
    out.update(CONCURRENCY_RULES)
    return dict(sorted(out.items()))


# the port's own README markers: the JAX package's table (its markers) sits
# earlier in the same README, and each drift test reads its own
RULE_TABLE_BEGIN = ("<!-- BEGIN ORP_TPU_TORCH RULE TABLE "
                    "(generated: python -m orp_tpu_torch.lint --list --markdown) -->")
RULE_TABLE_END = "<!-- END ORP_TPU_TORCH RULE TABLE -->"


def format_rule_list(markdown: bool = False) -> str:
    """``--list``: one line per rule; ``--markdown`` renders the README table
    VERBATIM (tests/test_torch_lint.py pins README against this output, so
    the table can never drift from the registry)."""
    rules = all_rule_summaries()
    if not markdown:
        return "\n".join(f"{code}  {summary}" for code, summary in
                         rules.items())
    lines = ["| Rule | Checks for |", "| --- | --- |"]
    lines += [f"| `{code}` | {summary} |" for code, summary in rules.items()]
    return "\n".join(lines)


def changed_files(base: str = "HEAD") -> set[pathlib.Path]:
    """The repo's .py files touched vs ``base`` (committed diff + working
    tree + untracked), resolved absolute — the ``--changed`` scope that
    keeps the project-wide pass out of the inner edit loop."""
    import subprocess

    def git(*args: str) -> str:
        r = subprocess.run(["git", *args], capture_output=True, text=True)
        if r.returncode != 0:
            raise ValueError(
                f"git {' '.join(args[:2])} failed: "
                f"{r.stderr.strip() or 'not a git checkout?'}")
        return r.stdout

    root = pathlib.Path(git("rev-parse", "--show-toplevel").strip())
    names = git("diff", "--name-only", "-z", base, "--").split("\0")
    names += git("ls-files", "-o", "--exclude-standard", "-z").split("\0")
    return {
        (root / n).resolve() for n in names
        if n.endswith(".py") and (root / n).exists()
    }


def run_cli(paths, select: str | None, as_json: bool = False, *,
            fmt: str | None = None, concurrency: bool = False,
            changed: str | None = None, list_rules: bool = False,
            markdown: bool = False) -> int:
    """The ONE lint CLI contract of ``python -m orp_tpu_torch.lint`` (the JAX
    package's ``orp lint`` / ``python -m orp_tpu.lint`` exit codes): prints
    findings, returns 1 on findings, 2 on usage
    errors (unknown rule / bad path — distinct so CI can tell a typo from
    a finding), 0 on clean.

    ``concurrency`` adds the project-wide ORP020-ORP022 pass; selecting an
    ORP02x code routes there automatically. ``changed`` limits reported
    findings to files touched vs that git ref (the concurrency pass still
    INDEXES project-wide — a changed file can break another file's lock
    discipline). ``fmt`` is human/json/sarif (``as_json`` is the
    pre-SARIF spelling of json)."""
    import sys

    if list_rules:
        print(format_rule_list(markdown=markdown))
        return 0
    fmt = fmt or ("json" if as_json else "human")
    if fmt not in ("human", "json", "sarif"):
        print(f"error: unknown format {fmt!r} (human, json, sarif)",
              file=sys.stderr)
        return 2
    from orp_tpu_torch.lint.concurrency import CONCURRENCY_RULES, analyze_paths

    roots = paths or [DEFAULT_LINT_ROOT]
    sel = select.split(",") if select else None
    file_sel = conc_sel = None
    if sel is not None:
        conc_sel = [c for c in sel if c in CONCURRENCY_RULES]
        file_sel = [c for c in sel if c not in CONCURRENCY_RULES]
        concurrency = concurrency or bool(conc_sel)
    try:
        scope = changed_files(changed) if changed is not None else None
        findings: list[Finding] = []
        if sel is None or file_sel:
            for f in iter_python_files(roots):
                if scope is not None and f.resolve() not in scope:
                    continue
                findings.extend(lint_source(f.read_text(), path=str(f),
                                            select=file_sel))
        if concurrency:
            conc = analyze_paths(roots, select=conc_sel or None)
            if scope is not None:
                conc = [f for f in conc
                        if pathlib.Path(f.path).resolve() in scope]
            findings.extend(conc)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if fmt == "json":
        print(format_json(findings))
    elif fmt == "sarif":
        print(format_sarif(findings))
    else:
        print(format_findings(findings))
    return 1 if findings else 0


def format_json(findings: list[Finding]) -> str:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return json.dumps({
        "version": JSON_SCHEMA_VERSION,
        "findings": [f.as_dict() for f in findings],
        "counts": dict(sorted(counts.items())),
        "rules": all_rule_summaries(),
    })


def format_sarif(findings: list[Finding]) -> str:
    """SARIF 2.1.0 — the interchange shape CI annotators ingest. Columns
    are 1-based in SARIF; ``Finding.col`` is the AST's 0-based offset."""
    return json.dumps({
        "version": "2.1.0",
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "runs": [{
            "tool": {"driver": {
                "name": "orp-lint",
                "rules": [
                    {"id": code, "shortDescription": {"text": summary}}
                    for code, summary in all_rule_summaries().items()
                ],
            }},
            "results": [
                {
                    "ruleId": f.rule,
                    "level": "warning",
                    "message": {"text": f.message},
                    "locations": [{
                        "physicalLocation": {
                            "artifactLocation": {"uri": f.path},
                            "region": {"startLine": f.line,
                                       "startColumn": f.col + 1},
                        }
                    }],
                }
                for f in findings
            ],
        }],
    })
