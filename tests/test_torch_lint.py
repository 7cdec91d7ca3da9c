"""The port's static analyzer (``orp_tpu_torch/lint``) against the JAX
package's (``orp_tpu/lint``), mirroring ``tests/test_lint.py``.

- The framework-agnostic rules (ORP009, ORP010, ORP012-ORP016, ORP018,
  ORP019, ORP023): the reference's own fixture snippets (imported from
  ``tests/test_lint.py``) give the same findings — rule, line, column and
  message — through both packages' ``lint_source``, at the reference's paths
  and at the port's.
- The retargeted rules (ORP001-ORP004, ORP006-ORP008, ORP011, ORP017,
  ORP024): one torch snippet that fires and one that is clean for each,
  beside the JAX test it mirrors; ORP005 is registered and finds nothing.
- The noqa grammar, ``select``, the syntax-error finding, the human / JSON /
  SARIF writers (byte-equal across packages for equal findings, but for the
  rule registry both documents embed: the retargeted summaries differ),
  ``run_cli``'s exit codes and the README rule table (a drift test against
  ``format_rule_list(markdown=True)``).
"""

import json
import pathlib
import textwrap

import pytest

import test_lint as ref
from orp_tpu.lint import engine as jengine
from orp_tpu.lint import lint_source as jlint_source
from orp_tpu_torch.lint import (CONCURRENCY_RULES, RULES, format_findings, format_json,
                                format_rule_list, format_sarif, lint_source)
from orp_tpu_torch.lint import engine
from orp_tpu_torch.lint.__main__ import main as lint_main
from orp_tpu_torch.lint.engine import (JSON_SCHEMA_VERSION, RULE_TABLE_BEGIN, RULE_TABLE_END,
                                       Finding, all_rule_summaries, run_cli)

AGNOSTIC = ("ORP009", "ORP010", "ORP012", "ORP013", "ORP014", "ORP015", "ORP016", "ORP018",
            "ORP019", "ORP023")
PATHS = ("fixture.py", "orp_tpu/serve/batcher.py", "orp_tpu/serve/host.py",
         "orp_tpu/serve/gateway.py", "orp_tpu/serve/fleet.py", "orp_tpu/serve/bundle.py",
         "orp_tpu/guard/degrade.py", "orp_tpu/store/cas.py", "orp_tpu/pilot/controller.py",
         "orp_tpu/obs/spans.py", "orp_tpu/train/backward.py",
         "orp_tpu_torch/serve/host.py", "orp_tpu_torch/store/catalog.py",
         "orp_tpu_torch/pilot/controller.py", "orp_tpu_torch/guard/serve.py")


def lint(src, path="fixture.py", **kw):
    return lint_source(textwrap.dedent(src), path=path, **kw)


def codes(src, path="fixture.py", **kw):
    return [f.rule for f in lint(src, path, **kw)]


def _key(findings):
    return [(f.rule, f.line, f.col, f.message) for f in findings]


def test_rule_registry_complete():
    assert set(RULES) == set(jengine.RULES)
    assert set(CONCURRENCY_RULES) == {"ORP020", "ORP021", "ORP022"}
    assert set(all_rule_summaries()) == set(jengine.all_rule_summaries())
    for code in AGNOSTIC:
        assert RULES[code].summary == jengine.RULES[code].summary


# -- the framework-agnostic rules: the reference's fixtures, both packages ----


@pytest.mark.parametrize("code", AGNOSTIC)
@pytest.mark.parametrize("kind", ["POS", "NEG"])
def test_agnostic_rule_fixture_findings_equal_jax(code, kind):
    src = textwrap.dedent(getattr(ref, f"{code}_{kind}"))
    fired = 0
    for path in PATHS:
        got = lint_source(src, path=path, select=[code])
        want = jlint_source(src, path=path, select=[code])
        assert _key(got) == _key(want), path
        fired += len(got)
    assert (fired > 0) == (kind == "POS")


# -- the retargeted rules: a torch positive and a clean negative each ---------

TORCH = {
    "ORP001": ("""
        import torch

        def f(x):
            y = x.to(torch.float64)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
            z = x.double()
            w = torch.zeros(3, dtype="float64")
            torch.set_default_dtype(torch.float64)
    """, 6, """
        import torch

        def f(x):
            y = x.float()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
            return torch.zeros(3, dtype=torch.float32), y
    """),
    "ORP002": ("""
        import torch

        class Prog:
            def epoch(self, x):
                s = x.sum().item()
                torch.cuda.synchronize()
                y = x.cpu()
                n = float(x)
                return s, y, n

            def capture(self):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    self.epoch(self.x)

        def step(p):
            return p.tolist()

        def run(dev, p):
            with fused_loop_scope(dev):
                step(p)

        def body(x):
            torch.cuda.synchronize()

        def aot(x):
            return aot_compile(body, x, label="b")

        def inner(ev):
            ev.synchronize()

        def cap(g, ev):
            g.capture_begin()
            inner(ev)
            g.capture_end()

        def step2(p):
            return p.item()

        def walk(dev, p, fused):
            with fused_loop_scope(dev) if fused else contextlib.nullcontext():
                step2(p)
    """, 8, """
        import torch

        class Prog:
            def epoch(self, x):
                n = float(x.shape[0])
                return torch.where(x > 0, x, -x) / n

            def capture(self):
                with torch.cuda.graph(self.g):
                    self.epoch(self.x)

        def report(x):
            return x.sum().item()   # not captured: a host read is fine here
    """),
    "ORP003": ("""
        import torch
        from orp_tpu_torch.utils import cuda_build

        def evaluate(x):
            g = torch.cuda.CUDAGraph()
            return g

        def warm(xs):
            for x in xs:
                lib = cuda_build.load("mixed_head")

        def submit(g):
            with torch.cuda.graph(g):
                pass
    """, 3, """
        import torch
        from orp_tpu_torch.utils import cuda_build

        def capture(self):
            self.graph = torch.cuda.CUDAGraph()

        def _lib():
            return cuda_build.load("mixed_head")
    """),
    "ORP004": ("""
        import torch
        from orp_tpu_torch.utils import threefry

        def draw(seed, n):
            key = threefry.seed_key(seed)
            a = uniform_pair(key)
            b = uniform_pair(key)
            x = torch.rand(n)
            y = torch.randn(n, 2)
            torch.empty(n).normal_()
            return a, b, x, y
    """, 4, """
        import torch
        from orp_tpu_torch.utils import threefry

        def draw(seed, n, gen):
            key = threefry.seed_key(seed)
            k1 = threefry.fold_in(key, 1)
            k2 = threefry.fold_in(key, 2)
            return (uniform_pair(k1), uniform_pair(k2), torch.rand(n, generator=gen),
                    torch.empty(n).normal_(generator=gen))
    """),
    "ORP006": ("""
        import torch

        class P:
            def iterate(self, loss, best):
                if loss < best:
                    self.take()

            def capture(self):
                with torch.cuda.graph(self.g):
                    self.iterate(self.loss, self.best)
    """, 1, """
        import torch

        class P:
            def iterate(self, loss, best, cfg: Config, flag: bool, mesh=None):
                if loss is None or loss.shape[0] > 1:
                    return torch.where(loss < best, loss, best)
                if cfg.fused and flag and mesh is not None:  # host values
                    return best

            def capture(self):
                with torch.cuda.graph(self.g):
                    self.iterate(self.loss, self.best, self.cfg, True)
    """),
    "ORP007": ("""
        import time
        import torch

        def bench(x):
            t0 = time.perf_counter()
            y = torch.matmul(x, x)
            return time.perf_counter() - t0, y
    """, 1, """
        import time
        import torch

        def bench(x):
            t0 = time.perf_counter()
            y = torch.matmul(x, x)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, y
    """),
    "ORP008": ("""
        import os
        from orp_tpu_torch.utils import cuda_build

        os.environ["ORP_TORCH_CACHE_DIR"] = "/tmp/x"
        cuda_build.set_build_dir("/tmp/y")
        os.environ.setdefault(cuda_build.ENV_CACHE_DIR, "/tmp/z")
    """, 3, """
        from orp_tpu_torch import aot

        aot.enable_persistent_cache("/tmp/x")
        env = {"ORP_TORCH_CACHE_DIR": "/tmp/child"}   # a child's environment
    """),
    "ORP011": ("""
        import torch

        def place(x):
            a = x.to("cuda:0")
            b = torch.device("cuda", 0)
            torch.cuda.set_device(0)
            return a, b, x.cuda()
    """, 4, """
        import torch

        def place(x, device, local_rank):
            torch.cuda.set_device(local_rank)
            return x.to(device), x.cuda(local_rank), torch.cuda.is_available()
    """),
    "ORP017": ("""
        import time
        import torch

        def bench(x):
            t0 = time.perf_counter()
            y = torch.matmul(x, x)
            dt = time.perf_counter() - t0
            torch.cuda.synchronize()
            return dt, y
    """, 1, """
        import time
        import torch

        def bench(x):
            t0 = time.perf_counter()
            y = torch.matmul(x, x)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            return dt, y
    """),
    "ORP024": ("""
        import torch

        def f(n):
            a = torch.zeros(n)
            b = torch.full((n,), 1.0)
            c = torch.as_tensor([1, 2])
            return a, b, c
    """, 3, """
        import torch

        def f(n, dt):
            a = torch.zeros(n, dtype=dt)
            b = torch.full((n,), 1.0, dtype=dt)
            return a, b, torch.zeros_like(a)
    """),
}
TORCH_PATH = {"ORP024": "orp_tpu_torch/serve/engine.py"}
ALLOWLISTED = {"ORP001": "orp_tpu_torch/utils/precision.py",
               "ORP007": "orp_tpu_torch/obs/devprof.py",
               "ORP008": "orp_tpu_torch/aot/cache.py",
               "ORP017": "orp_tpu_torch/serve/bench.py",
               "ORP024": "orp_tpu_torch/train/fit.py"}


@pytest.mark.parametrize("code", sorted(TORCH))
def test_retargeted_rule_fires_on_its_torch_snippet(code):
    pos, n, _neg = TORCH[code]
    got = codes(pos, TORCH_PATH.get(code, "fixture.py"), select=[code])
    assert got == [code] * n


@pytest.mark.parametrize("code", sorted(TORCH))
def test_retargeted_rule_is_silent_on_its_clean_snippet(code):
    _pos, _n, neg = TORCH[code]
    assert codes(neg, TORCH_PATH.get(code, "fixture.py")) == []


@pytest.mark.parametrize("code", sorted(ALLOWLISTED))
def test_retargeted_rule_scope_and_allowlist(code):
    pos, _n, _neg = TORCH[code]
    assert codes(pos, ALLOWLISTED[code], select=[code]) == []


def test_orp004_key_reuse_in_a_loop_and_after_a_branch():
    src = """
        from orp_tpu_torch.utils import threefry

        def loop(key, xs):
            for x in xs:
                binomial(key, x)

        def branch(seed, flag):
            key = threefry.seed_key(seed)
            if flag:
                uniform_pair(key)
            uniform_pair(key)
    """
    assert codes(src, select=["ORP004"]) == ["ORP004", "ORP004"]


def test_orp005_is_registered_and_finds_nothing():
    assert lint(ref.ORP005_POS, select=["ORP005"]) == []
    assert lint(TORCH["ORP002"][0], select=["ORP005"]) == []
    assert "no PyTorch counterpart" in RULES["ORP005"].summary
    assert run_cli([str(pathlib.Path(engine.__file__))], "ORP005") == 0


def test_capture_index_resolves_the_port_capture_sites():
    """The capture index finds the port's real capture sites: the Adam epoch
    and the GN iteration are capture-reachable where they are defined."""
    import ast

    root = engine.DEFAULT_LINT_ROOT
    for rel, name in (("train/fit.py", "epoch"), ("train/gn.py", "iterate")):
        tree = ast.parse((root / rel).read_text())
        idx = engine.CaptureIndex(tree)
        assert name in {f.name for f in idx.captured_defs()}, rel


# -- suppression, select, syntax, writers --------------------------------------


@pytest.mark.parametrize("src", [
    """
        def swallow(fn):
            try:
                return fn()
            except Exception:  # orp: noqa[ORP009] -- helper warns internally
                return None
    """,
    """
        def swallow(fn):
            try:
                return fn()
            except Exception:  # orp: noqa[ORP010] -- wrong code
                return None
    """,
    """
        def swallow(fn):
            try:
                return fn()
            except Exception:  # orp: noqa
                return None
    """,
    """
        def swallow(fn):
            # orp: noqa[ORP009] -- on the wrong line
            try:
                return fn()
            except Exception:
                return None
    """,
])
def test_noqa_grammar_equals_jax(src):
    src = textwrap.dedent(src)
    assert _key(lint_source(src, path="fixture.py")) == _key(
        jlint_source(src, path="fixture.py"))


def test_noqa_suppresses_a_retargeted_rule():
    src = """
        import torch

        def f(x):
            return x.double()  # orp: noqa[ORP001] -- the f64 reference arm
    """
    assert codes(src) == []


def test_select_restricts_rules_and_refuses_unknown_codes():
    pos = ref.ORP009_POS + ref.ORP013_POS
    assert set(codes(pos, "orp_tpu_torch/serve/ingest.py", select=["ORP013"])) == {"ORP013"}
    with pytest.raises(ValueError, match="unknown rule"):
        lint_source("x = 1\n", select=["ORP999"])
    with pytest.raises(ValueError, match="unknown rule"):
        lint_source("def (:\n", select=["ORP999"])


def test_syntax_error_reports_orp000_as_jax():
    assert _key(lint_source("def (:\n", path="bad.py")) == _key(
        jlint_source("def (:\n", path="bad.py"))
    assert [f.rule for f in lint_source("def (:\n", path="bad.py")] == ["ORP000"]


def _findings(mod_finding):
    return [mod_finding("a/serve/x.py", 3, 4, "ORP009", "swallowed"),
            mod_finding("a/serve/x.py", 9, 0, "ORP014", "unbounded"),
            mod_finding("b.py", 1, 0, "ORP009", "again")]


def test_writers_byte_equal_jax_for_equal_findings():
    got, want = _findings(Finding), _findings(jengine.Finding)
    assert format_findings(got) == jengine.format_findings(want)
    assert format_findings([]) == jengine.format_findings([]) == "orp lint: clean"
    gj, wj = json.loads(format_json(got)), json.loads(jengine.format_json(want))
    assert gj["version"] == JSON_SCHEMA_VERSION == wj["version"]
    assert set(gj["rules"]) == set(wj["rules"])
    gj.pop("rules"), wj.pop("rules")
    assert json.dumps(gj) == json.dumps(wj)
    gs, ws = json.loads(format_sarif(got)), json.loads(jengine.format_sarif(want))
    for doc in (gs, ws):
        assert doc["version"] == "2.1.0"
        assert [r["id"] for r in doc["runs"][0]["tool"]["driver"].pop("rules")] == sorted(
            all_rule_summaries())
    assert json.dumps(gs) == json.dumps(ws)
    loc = gs["runs"][0]["results"][0]["locations"][0]["physicalLocation"]
    assert loc["region"] == {"startLine": 3, "startColumn": 5}
    assert json.loads(format_sarif([]))["runs"][0]["results"] == []


# -- the CLI contract ------------------------------------------------------------


def test_run_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(ref.ORP009_POS))
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert run_cli([str(good)], None) == 0
    assert "orp lint: clean" in capsys.readouterr().out
    assert run_cli([str(bad)], None) == 1
    assert "ORP009" in capsys.readouterr().out
    assert run_cli([str(bad)], None, True) == 1
    assert json.loads(capsys.readouterr().out)["counts"] == {"ORP009": 3}
    assert run_cli([str(bad)], None, fmt="sarif") == 1
    assert len(json.loads(capsys.readouterr().out)["runs"][0]["results"]) == 3
    assert run_cli([str(bad)], "ORP999") == 2           # unknown rule: usage error
    assert run_cli([str(tmp_path / "missing.txt")], None) == 2
    assert run_cli([str(good)], None, fmt="xml") == 2
    assert run_cli(None, None, list_rules=True) == 0
    assert "ORP024" in capsys.readouterr().out
    # ORP02x routes to the project-wide pass; the port lints itself clean there
    assert run_cli([str(engine.DEFAULT_LINT_ROOT)], "ORP020,ORP021,ORP022") == 0
    assert lint_main(["--select", "ORP009", str(good)]) == 0
    assert lint_main(["--format", "json", str(bad)]) == 1


def test_default_root_is_the_port_package():
    assert engine.DEFAULT_LINT_ROOT.name == "orp_tpu_torch"
    assert (engine.DEFAULT_LINT_ROOT / "lint" / "engine.py").exists()


# -- rule-registry listing + README drift ----------------------------------------


def test_rule_list_covers_full_registry():
    plain, md = format_rule_list(), format_rule_list(markdown=True)
    for code, summary in all_rule_summaries().items():
        assert f"{code}  {summary}" in plain
        assert f"| `{code}` | {summary} |" in md
    lines = md.splitlines()
    assert lines[:2] == ["| Rule | Checks for |", "| --- | --- |"]
    assert len(lines) == 2 + len(all_rule_summaries())


def test_readme_port_rule_table_matches_registry():
    """The port's README table is GENERATED (``python -m orp_tpu_torch.lint
    --list --markdown``) under its own markers, after the JAX package's."""
    text = (pathlib.Path(__file__).resolve().parent.parent / "README.md").read_text()
    assert RULE_TABLE_BEGIN in text and RULE_TABLE_END in text
    assert text.index(jengine.RULE_TABLE_END) < text.index(RULE_TABLE_BEGIN)
    block = text.split(RULE_TABLE_BEGIN, 1)[1].split(RULE_TABLE_END, 1)[0]
    table = "\n".join(line[2:] if line.startswith("  ") else line
                      for line in block.splitlines()).strip("\n")
    assert table == format_rule_list(markdown=True)


def test_changed_files_resolves_against_this_checkout():
    from orp_tpu_torch.lint.engine import changed_files

    got = changed_files("HEAD")
    assert all(p.is_absolute() and p.suffix == ".py" and p.exists() for p in got)
    with pytest.raises(ValueError, match="git diff .* failed"):
        changed_files("no-such-ref-xyzzy")
