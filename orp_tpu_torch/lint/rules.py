"""The ORP rule set: this codebase's real CUDA/H100 hazards, as AST checks
(counterpart of ``orp_tpu/lint/rules.py``; the same rule codes, so a
``# orp: noqa[ORPnnn] -- reason``, ``--select`` and the rule table read the
same in both packages).

Each rule is a documented heuristic — precise enough that the package lints
clean without blanket suppressions, honest enough that intentional sites
carry a ``# orp: noqa[RULE] -- reason`` instead of silently passing. The
rules the JAX package aims at XLA get their CUDA counterpart here; the rest
(ORP009, ORP010, ORP012-ORP016, ORP018, ORP019, ORP023) are the JAX
package's, with its path scopes read inside ``orp_tpu_torch/``. The failure
each rule guards against on the H100:

ORP001  precision drift: a stray ``torch.float64`` constant on an f32 path
        runs at the card's FP64 rate and promotes everything it touches;
        a TF32 flip (``allow_tf32 = True``,
        ``set_float32_matmul_precision("high" | "medium")``) or
        ``set_default_dtype(torch.float64)`` changes every GEMM's rounding
        process-wide. The port pins full f32 in ONE place,
        ``utils/precision.py``; intentional f64 (the f64 reference walks,
        exact thinning's words) says so with a noqa.
ORP002  host syncs inside capture-reachable code: ``.item()`` /
        ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
        ``torch.cuda.synchronize`` / ``Event.synchronize`` /
        ``float(t)`` inside a function that a CUDA-graph capture or the
        fused walk's date loop runs either breaks the capture ("operation
        not permitted when stream is capturing") or inserts a hidden sync
        per replay.
ORP003  per-call captures and builds: a ``torch.cuda.CUDAGraph`` /
        ``torch.cuda.graph`` / ``capture_begin`` capture or a
        ``cuda_build`` load made inside a per-request or per-iteration
        function (or a loop) pays the capture (or the ``nvcc`` check) on
        every call; capture once, replay after.
ORP004  PRNG key reuse and unseeded draws: the same ``utils/threefry.py``
        key consumed twice yields correlated streams, and a
        ``torch.rand*``/``randn*``/``randint``/``randperm``/``normal_``
        draw with no explicit ``generator=`` reads the process-global
        generator (another caller's draws move it: not reproducible).
ORP005  buffer donation: no PyTorch counterpart (a tensor is freed with its
        last reference, so there is nothing to donate); kept registered so
        ``--select ORP005`` and noqa codes stay valid, and finds nothing.
ORP006  Python branching on a tensor in capture-reachable code:
        ``if t > 0`` on a CUDA tensor is a host sync (and raises under a
        capture); use ``torch.where`` or branch on a host value.
ORP007  timing around async CUDA work: kernel launches return before the
        card finishes; a ``perf_counter`` delta with no
        ``torch.cuda.synchronize()`` / event sync (or a host read of the
        result) between the clocks measures launch, not compute.
ORP008  build-cache config outside ``aot/cache.py``: the kernel-build cache
        is process-global state with one entry point
        (``aot.enable_persistent_cache``); a write of
        ``ORP_TORCH_CACHE_DIR`` or a ``cuda_build.set_build_dir`` call
        elsewhere forgets the tests' kill-switch.
ORP009  silent broad excepts (the JAX package's rule).
ORP010  blocking calls in serve dispatch-loop code (the JAX package's
        rule; its host-sync list takes the torch names: ``.item()``,
        ``.cpu()``, ``.tolist()``, ``torch.cuda.synchronize``,
        ``Event.synchronize``).
ORP011  single-device assumptions in mesh-reachable code:
        ``torch.device("cuda:0")``, a ``"cuda:0"`` literal,
        ``torch.cuda.set_device(0)`` and a bare ``.cuda()`` pin work to
        card 0 whatever rank runs it; placement comes from the mesh
        (``parallel/mesh.py``) or the caller's ``device=``. Code that
        genuinely means card 0 says so with a noqa.
ORP012  engine rebuild/swap under a lock (the JAX package's rule).
ORP013  per-row Python work in ingest-path code (the JAX package's rule).
ORP014  unbounded socket I/O in serve-plane code (the JAX package's rule).
ORP015  dynamic obs instrument names / hot-path instrument construction
        (the JAX package's rule).
ORP016  numeric acceptance gates that never record their measurement (the
        JAX package's rule).
ORP017  stop-clock read before the sync on CUDA work: the scope DOES sync,
        but only after the second clock read, so the delta still times the
        launch. Allowlisted: ``obs/`` (devprof takes the raw instants by
        design), ``aot/`` (the compile meters time the capture, not a
        launch) and ``*bench.py`` (the bench lanes measure the dispatch
        path deliberately and sync in bulk); ORP007 shares the allowlist.
ORP018  per-process-salted hashing in routing code (the JAX package's rule).
ORP019  bare writes in store/bundle persistence code (the JAX package's
        rule).
ORP023  pilot transitions without telemetry or with heavy work under a lock
        (the JAX package's rule).
ORP024  implicit dtype on the serve hot path: a
        ``torch.zeros``/``ones``/``full``/``empty``/``tensor``/
        ``as_tensor`` with no ``dtype=`` in ``serve/engine.py``,
        ``serve/megakernel.py`` or ``serve/precision.py`` takes the default
        (f32, or the input's), silently undoing a bf16/int8 tier.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from orp_tpu_torch.lint.engine import (Finding, FileContext, dotted, params_of, rule,
                                       walk_scope)

# -- ORP001 ------------------------------------------------------------------

_X64_ALLOWED_SUFFIXES = ("utils/precision.py",)
_F64_ATTRS = {"torch.float64", "torch.double"}
_F64_STRINGS = {"float64", "double"}
_TF32_FLAGS = {"torch.backends.cuda.matmul.allow_tf32",
               "torch.backends.cudnn.allow_tf32"}


def _is_torch_call(call: ast.Call) -> bool:
    d = dotted(call.func)
    return d is not None and d.startswith("torch.")


@rule("ORP001", "float64 constant or TF32 flip outside utils/precision.py "
                "(the H100 paths run full f32)")
def check_x64_drift(ctx: FileContext) -> Iterator[Finding]:
    if ctx.path.replace("\\", "/").endswith(_X64_ALLOWED_SUFFIXES):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) and dotted(node) in _F64_ATTRS:
            yield ctx.finding(
                node, "ORP001",
                f"{dotted(node)} outside utils/precision.py — the card's paths "
                "are f32; an f64 constant runs at the FP64 rate and promotes "
                "every tensor it meets",
            )
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (dotted(t) in _TF32_FLAGS
                        and isinstance(node.value, ast.Constant)
                        and node.value.value is True):
                    yield ctx.finding(
                        node, "ORP001",
                        f"{dotted(t)} = True outside utils/precision.py — TF32 "
                        "changes every f32 GEMM's rounding process-wide; the "
                        "port pins full f32 in one place",
                    )
        elif isinstance(node, ast.Call):
            d = dotted(node.func)
            a0 = node.args[0] if node.args else None
            if (d == "torch.set_float32_matmul_precision"
                    and isinstance(a0, ast.Constant)
                    and a0.value in ("high", "medium")):
                yield ctx.finding(
                    node, "ORP001",
                    f"set_float32_matmul_precision({a0.value!r}) outside "
                    "utils/precision.py — TF32/bf16 GEMMs process-wide",
                )
            elif (d == "torch.set_default_dtype" and a0 is not None
                  and dotted(a0) in _F64_ATTRS):
                yield ctx.finding(
                    node, "ORP001",
                    "set_default_dtype(float64) outside utils/precision.py — "
                    "every new tensor of the process becomes f64",
                )
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "double" and not node.args):
                yield ctx.finding(
                    node, "ORP001",
                    ".double() — promote via utils/precision.py policy, not "
                    "ad hoc",
                )
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in ("astype", "to", "type")
                  and isinstance(a0, ast.Constant)
                  and a0.value in _F64_STRINGS):
                yield ctx.finding(
                    node, "ORP001",
                    f"{node.func.attr}({a0.value!r}) — promote via "
                    "utils/precision.py policy, not ad-hoc string dtypes",
                )
            elif _is_torch_call(node):
                for kw in node.keywords:
                    if kw.arg == "dtype" and (
                        (isinstance(kw.value, ast.Constant)
                         and kw.value.value in _F64_STRINGS)
                        or dotted(kw.value) in {"np.float64", "numpy.float64"}
                    ):
                        yield ctx.finding(
                            kw.value, "ORP001",
                            "float64 dtype= on a torch call outside "
                            "utils/precision.py",
                        )


# -- ORP002 ------------------------------------------------------------------

_SYNC_DOTTED = {"torch.cuda.synchronize", "cuda.synchronize"}
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
_NP_HOST_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
                  "np.copy", "numpy.copy"}


def _sync_method(call: ast.Call) -> str | None:
    """``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
    ``.synchronize()`` / ``.to("cpu")``: the name, else None."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in _SYNC_METHODS and not call.args:
        return f.attr
    if (f.attr == "to" and call.args and isinstance(call.args[0], ast.Constant)
            and call.args[0].value == "cpu"):
        return "to('cpu')"
    return None


@rule("ORP002", "host sync (.item/.cpu/.tolist/synchronize) in capture-reachable "
                "code: breaks a CUDA-graph capture or hides a sync")
def check_host_sync(ctx: FileContext) -> Iterator[Finding]:
    for fdef, _site in ctx.capture.capture_reachable_defs().items():
        traced = set(params_of(fdef))
        # scope-pruned walk: nested defs are capture-reachable too, but they
        # get their OWN entry in capture_reachable_defs
        for node in walk_scope(fdef):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            meth = _sync_method(node)
            if d in _SYNC_DOTTED:
                yield ctx.finding(
                    node, "ORP002",
                    f"{d} inside capture-reachable {fdef.name!r} — a device "
                    "sync breaks a capture (and stalls the fused loop)",
                )
            elif meth is not None:
                yield ctx.finding(
                    node, "ORP002",
                    f".{meth}() inside capture-reachable {fdef.name!r} — a "
                    "host read per replay (and not permitted while the "
                    "stream is capturing)",
                )
            elif d in _NP_HOST_CALLS:
                yield ctx.finding(
                    node, "ORP002",
                    f"{d} inside capture-reachable {fdef.name!r} — NumPy "
                    "pulls device values to the host; stay in torch",
                )
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in ("float", "int", "bool")
                  and node.args
                  and _traced_name_in_condition(node.args[0], traced)
                  is not None):
                yield ctx.finding(
                    node, "ORP002",
                    f"{node.func.id}() on a tensor inside capture-reachable "
                    f"{fdef.name!r} — a hidden host sync",
                )


# -- ORP003 ------------------------------------------------------------------

# per-request / per-iteration functions: a capture or a build there is paid
# on every call
_PER_CALL_FN_RE = re.compile(
    r"(^|_)(submit|handle|frame|reply|dispatch|admit|resolve|recv|send|"
    r"step|evaluate|iterate|epoch|replay)")
_CAPTURE_CALLS = {"torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph",
                  "torch.cuda.graph", "torch.cuda.make_graphed_callables"}
_BUILD_CALLS = {"cuda_build.load", "cuda_build.build_all", "cuda_build.build"}


def _capture_or_build(call: ast.Call) -> str | None:
    d = dotted(call.func)
    if d in _CAPTURE_CALLS or d in _BUILD_CALLS:
        return d
    if (isinstance(call.func, ast.Attribute)
            and call.func.attr == "capture_begin"):
        return ".capture_begin"
    return None


def _in_loop(fdef: ast.AST, target: ast.AST) -> bool:
    for loop in walk_scope(fdef):
        if isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
            if any(n is target for n in ast.walk(loop)):
                return True
    return False


@rule("ORP003", "CUDA-graph capture or cuda_build load made per request or per "
                "iteration")
def check_recompile_hazards(ctx: FileContext) -> Iterator[Finding]:
    for fdef in ast.walk(ctx.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        hot = _PER_CALL_FN_RE.search(fdef.name) is not None
        for node in walk_scope(fdef):
            if not isinstance(node, ast.Call):
                continue
            what = _capture_or_build(node)
            if what is None:
                continue
            if hot:
                yield ctx.finding(
                    node, "ORP003",
                    f"{what} in per-call function {fdef.name!r} — every call "
                    "pays the capture/build; capture once and replay (or "
                    "hold the loaded library)",
                )
            elif _in_loop(fdef, node):
                yield ctx.finding(
                    node, "ORP003",
                    f"{what} inside a loop in {fdef.name!r} — one capture/"
                    "build per iteration; hoist it out of the loop",
                )


# -- ORP004 ------------------------------------------------------------------

# utils/threefry.py's key API: seed_key makes a key, fold_in derives one
# (a sanctioned multi-use); any other call a key is passed to consumes it
_KEY_MAKERS = {"seed_key", "fold_in"}
_KEY_NONCONSUMING = {"fold_in", "seed_key"}
_KEY_PARAM_RE = re.compile(r"^(key|rng|rng_key|prng_key|.+_key)$")
_UNSEEDED_DRAWS = {"torch.rand", "torch.randn", "torch.randint",
                   "torch.randperm", "torch.normal", "torch.bernoulli",
                   "torch.multinomial", "torch.poisson"}
_UNSEEDED_METHODS = {"uniform_", "normal_", "random_", "bernoulli_",
                     "exponential_", "cauchy_", "log_normal_", "geometric_"}


def _random_fn(call: ast.Call) -> str | None:
    """The ``X`` of a ``threefry.X`` / ``tf.X`` call, or of a bare
    ``seed_key(...)`` / ``fold_in(...)``."""
    d = dotted(call.func)
    if d is None:
        return None
    parts = d.split(".")
    if len(parts) == 1 and parts[0] in _KEY_MAKERS:
        return parts[0]
    if len(parts) >= 2 and parts[-2] in ("threefry", "tf"):
        return parts[-1]
    return None


def _key_targets(stmt_value: ast.expr, targets: list[ast.expr]) -> set[str]:
    """Names (re)bound to fresh key material by this assignment."""
    if not (isinstance(stmt_value, ast.Call)
            and _random_fn(stmt_value) in _KEY_MAKERS):
        return set()
    out = set()
    for t in targets:
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out |= {e.id for e in t.elts if isinstance(e, ast.Name)}
    return out


class _KeyFlow:
    """Per-function linear abstract interpretation of key freshness.

    State: key var -> first-consuming-use node (None = fresh). A second
    consumption without rebinding is a finding. ``if``/``try`` branches are
    walked from a copy and max-merged (disjoint branches may each consume
    once); loop bodies are walked twice so a consume-without-rebind trips on
    the simulated second iteration."""

    def __init__(self, ctx: FileContext, fdef: ast.FunctionDef):
        self.ctx = ctx
        self.fdef = fdef
        self.state: dict[str, ast.AST | None] = {}
        self.findings: list[Finding] = []
        for p in (*fdef.args.posonlyargs, *fdef.args.args, *fdef.args.kwonlyargs):
            if _KEY_PARAM_RE.match(p.arg):
                self.state[p.arg] = None

    def run(self) -> list[Finding]:
        self._walk_body(self.fdef.body)
        return self.findings

    def _walk_body(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self._walk_stmt(stmt)

    def _walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # separate scope, analyzed on its own
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            if value is not None:
                self._consume_uses(value)
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            )
            if value is not None:
                fresh = _key_targets(value, targets)
                for name in fresh:
                    self.state[name] = None
                # any other rebind of a tracked name unlinks it
                for t in targets:
                    for n in ast.walk(t):
                        if (isinstance(n, ast.Name) and n.id in self.state
                                and n.id not in fresh):
                            del self.state[n.id]
            return
        if isinstance(stmt, (ast.If,)):
            self._consume_uses(stmt.test)
            self._branch([stmt.body, stmt.orelse])
            return
        if isinstance(stmt, ast.Try):
            self._branch([stmt.body + stmt.finalbody]
                         + [h.body for h in stmt.handlers])
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._consume_uses(stmt.iter)
            for _ in range(2):  # simulated second iteration catches reuse
                self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
            return
        if isinstance(stmt, ast.While):
            for _ in range(2):
                self._consume_uses(stmt.test)
                self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
            return
        if isinstance(stmt, ast.With) or isinstance(stmt, ast.AsyncWith):
            for item in stmt.items:
                self._consume_uses(item.context_expr)
            self._walk_body(stmt.body)
            return
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._consume_uses(node)

    def _branch(self, bodies: list[list[ast.stmt]]) -> None:
        pre = dict(self.state)
        merged: dict[str, ast.AST | None] = {}
        any_fallthrough = False
        for body in bodies:
            self.state = dict(pre)
            self._walk_body(body)
            if body and isinstance(body[-1], (ast.Return, ast.Raise,
                                              ast.Break, ast.Continue)):
                continue  # terminated: its consumption can't flow past here
            any_fallthrough = True
            for k, v in self.state.items():
                if k in merged:
                    merged[k] = merged[k] if merged[k] is not None else v
                else:
                    merged[k] = v
        if not any_fallthrough:
            merged = pre
        # branch-local keys stay tracked in their merged state: a key created
        # AND consumed inside one branch is still reuse when consumed again
        # after the branch (on that path it really was used already)
        self.state = merged

    def _consume_uses(self, expr: ast.expr) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            rf = _random_fn(node)
            if rf in _KEY_NONCONSUMING:
                continue  # fold_in-style derivation: sanctioned multi-use
            for arg in [*node.args, *[kw.value for kw in node.keywords]]:
                if isinstance(arg, ast.Name) and arg.id in self.state:
                    prior = self.state[arg.id]
                    if prior is not None:
                        self.findings.append(self.ctx.finding(
                            node, "ORP004",
                            f"PRNG key {arg.id!r} consumed again without "
                            "a fresh threefry.fold_in (first used at line "
                            f"{prior.lineno}) — correlated random streams",
                        ))
                    self.state[arg.id] = node


@rule("ORP004", "threefry key reuse, or a torch random draw with no explicit "
                "generator=")
def check_key_reuse(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.FunctionDef):
            yield from _KeyFlow(ctx, node).run()
        elif isinstance(node, ast.Call):
            d = dotted(node.func)
            meth = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else None)
            if (d in _UNSEEDED_DRAWS or meth in _UNSEEDED_METHODS) and not any(
                    kw.arg == "generator" for kw in node.keywords):
                yield ctx.finding(
                    node, "ORP004",
                    f"{d or '.' + meth}() with no generator= — it reads the "
                    "process-global generator, which any other caller's "
                    "draws move; pass a seeded torch.Generator",
                )


# -- ORP005 ------------------------------------------------------------------


@rule("ORP005", "buffer donation: no PyTorch counterpart (a tensor is freed "
                "with its last reference); registered, finds nothing")
def check_missing_donation(ctx: FileContext) -> Iterator[Finding]:
    # the JAX package's ORP005 asks a train-step jit to donate its input
    # buffers; torch has no donation to forget, so the rule stays registered
    # (``--select ORP005`` and noqa codes keep working) and yields nothing
    return
    yield  # pragma: no cover


# -- ORP006 ------------------------------------------------------------------

_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "size",
                "numel", "dim", "layout", "requires_grad"}


def _traced_name_in_condition(
    test: ast.expr, traced: set[str]
) -> ast.Name | None:
    """A parameter Name used by VALUE in ``test`` (not via a host-side
    attribute like ``.shape``/``.device``, not ``is None``, not
    isinstance)."""
    allowed_parents: set[int] = set()
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute) and node.attr in _SHAPE_ATTRS:
            for sub in ast.walk(node.value):
                allowed_parents.add(id(sub))
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Name)
              and node.func.id in ("isinstance", "len", "callable", "hasattr",
                                   "getattr", "type")):
            for sub in ast.walk(node):
                allowed_parents.add(id(sub))
        elif isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
        ):
            for sub in ast.walk(node):
                allowed_parents.add(id(sub))
    for node in ast.walk(test):
        if (isinstance(node, ast.Name) and node.id in traced
                and id(node) not in allowed_parents):
            return node
    return None


@rule("ORP006", "Python branch on a tensor in capture-reachable code (a host "
                "sync; raises under a capture)")
def check_traced_branch(ctx: FileContext) -> Iterator[Finding]:
    for fdef, _site in ctx.capture.captured_defs().items():
        traced = set(params_of(fdef))
        for node in walk_scope(fdef):
            tests = []
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                tests.append(node.test)
            elif isinstance(node, ast.Assert):
                tests.append(node.test)
            for test in tests:
                name = _traced_name_in_condition(test, traced)
                if name is not None:
                    yield ctx.finding(
                        test, "ORP006",
                        f"Python branch on {name.id!r} in capture-reachable "
                        f"{fdef.name!r} — `if <cuda tensor>` is a host sync "
                        "(and raises under a capture); use torch.where or "
                        "branch on a host value",
                    )


# -- ORP007 ------------------------------------------------------------------

_TIMER_CALLS = {"time.perf_counter", "time.time", "perf_counter",
                "time.monotonic", "monotonic", "_t.perf_counter"}
_SYNC_HELPERS = {"cuda_ms", "measure.cuda_ms", "timed", "profiling.timed",
                 "np.asarray", "np.array", "torch.cuda.synchronize",
                 "cuda.synchronize"}
_DISPATCH_EXEMPT_PREFIXES = (
    "torch.cuda.synchronize", "torch.cuda.is_available", "torch.cuda.device",
    "torch.cuda.get_device", "torch.cuda.current_", "torch.cuda.Event",
    "torch.cuda.Stream", "torch.cuda.stream", "torch.cuda.set_device",
    "torch.cuda.memory", "torch.cuda.max_memory", "torch.cuda.reset_peak",
    "torch.cuda.empty_cache", "torch.cuda.mem_get_info", "torch.cuda.graph",
    "torch.cuda.CUDAGraph", "torch.device", "torch.Generator",
    "torch.manual_seed", "torch.set_", "torch.get_", "torch.no_grad",
    "torch.inference_mode", "torch.is_", "torch.profiler", "torch.backends",
    "torch.distributed", "torch.finfo", "torch.iinfo", "torch.Size",
    "torch.utils", "torch.version", "torch.__", "torch.load", "torch.save",
    "torch.from_numpy",
)
_ORP007_ALLOWED_DIRS = ("obs/", "aot/")


def _scopes(tree: ast.Module):
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _is_sync_call(node: ast.AST) -> bool:
    """A call that waits for the card (or reads a result to the host)."""
    if not isinstance(node, ast.Call):
        return False
    d = dotted(node.func)
    if d in _SYNC_HELPERS:
        return True
    return _sync_method(node) is not None


def _is_dispatch(node: ast.Call, captured_names: set[str]) -> str | None:
    """The name of CUDA work this call launches (a ``torch.*`` op, a graph
    replay, a captured callable), else None."""
    d = dotted(node.func)
    if d is None:
        return None
    if d.startswith("torch.") and not d.startswith(_DISPATCH_EXEMPT_PREFIXES):
        return d
    tail = d.split(".")[-1]
    if tail == "replay" or tail in captured_names:
        return d
    return None


def _module_sync_fns(tree: ast.Module) -> set[str]:
    """Names of the module's top-level defs that sync (a ``_sync(dev)``
    helper wrapping ``torch.cuda.synchronize``)."""
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and any(_is_sync_call(n) for n in ast.walk(node))}


def _local_sync_fns(scope: ast.AST, module_fns: set[str] = frozenset()) -> set[str]:
    """Names of nested defs that sync before returning (a timed call to
    ``run()`` where ``run`` ends in ``torch.cuda.synchronize`` IS synced),
    the module's own syncing helpers (``module_fns``), plus one level of
    ``alias = run`` rebinding."""
    names = set(module_fns) | {
        sub.name
        for sub in ast.walk(scope)
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
        and sub is not scope
        and any(_is_sync_call(n) for n in ast.walk(sub))
    }
    for sub in walk_scope(scope):
        if (isinstance(sub, ast.Assign)
                and isinstance(sub.value, ast.Name)
                and sub.value.id in names):
            names |= {t.id for t in sub.targets if isinstance(t, ast.Name)}
    return names


def _timing_allowlisted(path: str) -> bool:
    """``obs/``, ``aot/`` and the bench lanes (a file named ``bench.py`` or
    ``*_bench.py``): timing instrumentation is their job."""
    path = path.replace("\\", "/")
    if any("/" + d in path or path.startswith(d)
           for d in _ORP007_ALLOWED_DIRS):
        return True
    base = path.rsplit("/", 1)[-1]
    return base == "bench.py" or base.endswith("_bench.py")


@rule("ORP007", "wall timing around CUDA launches with no synchronize/event sync "
                "between the clocks")
def check_unblocked_timing(ctx: FileContext) -> Iterator[Finding]:
    if _timing_allowlisted(ctx.path):
        return
    captured = ctx.capture.captured_callable_names()
    module_fns = _module_sync_fns(ctx.tree)
    for scope in _scopes(ctx.tree):
        timers: list[ast.Call] = []
        dispatches: list[str] = []
        synced = False
        sync_fns = _local_sync_fns(scope, module_fns)
        for node in walk_scope(scope):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d in _TIMER_CALLS:
                timers.append(node)
            elif _is_sync_call(node):
                synced = True
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in sync_fns):
                synced = True
            elif (work := _is_dispatch(node, captured)) is not None:
                dispatches.append(work)
        if len(timers) >= 2 and dispatches and not synced:
            yield ctx.finding(
                timers[1], "ORP007",
                f"perf_counter delta around CUDA work ({dispatches[0]} …) "
                "with no torch.cuda.synchronize()/event sync — this times "
                "the launch, not the card's work",
            )


# -- ORP017 ------------------------------------------------------------------


@rule("ORP017", "stop-clock read before the synchronize around CUDA launches")
def check_stop_clock_before_block(ctx: FileContext) -> Iterator[Finding]:
    if _timing_allowlisted(ctx.path):
        return
    captured = ctx.capture.captured_callable_names()
    module_fns = _module_sync_fns(ctx.tree)
    for scope in _scopes(ctx.tree):
        sync_fns = _local_sync_fns(scope, module_fns)
        # STOP-clocks are timer reads consumed by a subtraction, or a timer
        # assigned to a name that later is a subtraction's MINUEND (the
        # JAX package's rule, verbatim)
        stop_ids: set[int] = set()
        sub_minuend_names: set[str] = set()
        for node in walk_scope(scope):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
                for side in (node.left, node.right):
                    if (isinstance(side, ast.Call)
                            and dotted(side.func) in _TIMER_CALLS):
                        stop_ids.add(id(side))
                if isinstance(node.left, ast.Name):
                    sub_minuend_names.add(node.left.id)
        for node in walk_scope(scope):
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id in sub_minuend_names
                    and isinstance(node.value, ast.Call)
                    and dotted(node.value.func) in _TIMER_CALLS):
                stop_ids.add(id(node.value))
        events: list[tuple[int, str, ast.Call]] = []
        for node in walk_scope(scope):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d in _TIMER_CALLS:
                events.append((node.lineno, "timer", node))
            elif _is_sync_call(node) or (
                    isinstance(node.func, ast.Name)
                    and node.func.id in sync_fns):
                events.append((node.lineno, "sync", node))
            elif _is_dispatch(node, captured) is not None:
                events.append((node.lineno, "dispatch", node))
        if not any(kind == "sync" for _, kind, _ in events):
            continue  # ORP007's finding, never double-reported
        events.sort(key=lambda e: e[0])
        timers = [e for e in events if e[1] == "timer"]
        for (t0_line, _, _), (t1_line, _, t1_node) in zip(timers,
                                                          timers[1:]):
            if id(t1_node) not in stop_ids:
                continue
            dispatches = [ln for ln, kind, _ in events
                          if kind == "dispatch" and t0_line < ln < t1_line]
            if not dispatches:
                continue
            last_disp = dispatches[-1]
            if any(kind == "sync" and last_disp <= ln <= t1_line
                   for ln, kind, _ in events):
                continue
            yield ctx.finding(
                t1_node, "ORP017",
                "stop-clock read with no torch.cuda.synchronize() since the "
                f"CUDA work at line {last_disp} — the scope DOES sync, but "
                "only after this clock stops, so the delta times the launch; "
                "move the sync before the stop clock (or use obs spans)",
            )


# -- ORP008 ------------------------------------------------------------------

# the build cache's one entry point and the module that owns the override
_CACHE_ALLOWED = ("aot/cache.py", "utils/cuda_build.py")
_CACHE_ENV = "ORP_TORCH_CACHE_DIR"
_ENV_WRITERS = {"os.environ.setdefault", "os.environ.pop", "os.putenv",
                "os.unsetenv", "environ.setdefault", "environ.pop"}


def _names_cache_env(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == _CACHE_ENV
    d = dotted(node)
    return d is not None and d.split(".")[-1] == "ENV_CACHE_DIR"


@rule("ORP008", "ORP_TORCH_CACHE_DIR write or set_build_dir call outside "
                "aot/cache.py (the build cache's one entry point)")
def check_cache_entrypoint(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if any(path == a or path.endswith("/" + a) for a in _CACHE_ALLOWED):
        return
    msg = ("— the kernel-build cache is process-global and has ONE entry "
           "point: orp_tpu_torch.aot.enable_persistent_cache (it also honours "
           "the tests' kill-switch this write forgets)")
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and dotted(t.value) in ("os.environ", "environ")
                        and _names_cache_env(t.slice)):
                    yield ctx.finding(node, "ORP008",
                                      f"{_CACHE_ENV} written directly {msg}")
        elif isinstance(node, ast.Call):
            d = dotted(node.func)
            if d is None:
                continue
            if d.split(".")[-1] == "set_build_dir":
                yield ctx.finding(node, "ORP008",
                                  f"{d}(...) called directly {msg}")
            elif d in _ENV_WRITERS and node.args and _names_cache_env(node.args[0]):
                yield ctx.finding(node, "ORP008",
                                  f"{_CACHE_ENV} written via {d} {msg}")


# -- ORP009 ------------------------------------------------------------------

_BROAD_EXC_NAMES = {"Exception", "BaseException"}
# a handler body "emits" when it raises, hands the error to a future, or
# routes it through warnings/obs/logging — the call's terminal attribute is
# what the AST can see. Two acknowledged heuristic gaps: a helper that
# warns INTERNALLY reads as silent (false positive — carry a noqa with the
# reason), and an unrelated method that merely SHARES an emit name
# (`sink.emit`, `hist.observe` lookalikes) reads as emitting (false
# negative). The generic collision magnets (`list.count`, `Counter.inc`)
# are deliberately NOT in the set — the repo idiom is the `obs_count`
# alias, which is unambiguous.
_EMIT_CALL_TAILS = {
    "warn", "warn_explicit",                      # warnings
    "obs_count", "observe",                       # obs counters/histograms
    "emit", "emit_record", "set_gauge",           # obs sinks/gauges
    "set_exception",                              # delivered to a future
    "exception", "error", "warning", "critical",  # logging
}


def _is_broad_handler(h: ast.ExceptHandler) -> bool:
    if h.type is None:
        return True  # bare except
    types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    for t in types:
        d = dotted(t)
        if d is not None and d.split(".")[-1] in _BROAD_EXC_NAMES:
            return True
    return False


def _handler_emits(h: ast.ExceptHandler) -> bool:
    for stmt in h.body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                tail = (d.split(".")[-1] if d is not None
                        else getattr(node.func, "attr", None))
                if tail in _EMIT_CALL_TAILS:
                    return True
    return False


# -- ORP010 ------------------------------------------------------------------

# scope: functions that ARE the serve tier's dispatch loop — admit/dispatch/
# drain/schedule stages (and the loop driver `_run`) in any file under a
# serve package. Resolution functions are deliberately OUT of scope: their
# job is to block on the oldest in-flight batch; everything before them must
# stay non-blocking or the device idles behind Python.
_DISPATCH_LOOP_RE = re.compile(r"(^_?run$)|dispatch|admit|drain|schedule")
# the torch host syncs: a device-wide synchronize, and (below) a result read
# back to the host (.item()/.cpu()/.tolist()) or an Event.synchronize(); the
# JAX package's names stay in the list so its fixtures read the same here
_BLOCKING_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize",
                        "jax.block_until_ready", "jax.device_get",
                        "block_until_ready", "device_get"}


@rule("ORP010", "blocking call inside serve dispatch-loop code")
def check_dispatch_loop_blocking(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if "serve/" not in path:
        return
    for fdef in ast.walk(ctx.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _DISPATCH_LOOP_RE.search(fdef.name):
            continue
        for node in walk_scope(fdef):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d == "time.sleep":
                yield ctx.finding(
                    node, "ORP010",
                    f"time.sleep in dispatch-loop {fdef.name!r} — every "
                    "queued request pays this nap; wait on the loop's "
                    "Condition/Event with a timeout so close() can "
                    "interrupt it",
                )
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "result"
                  and not node.args
                  and not any(kw.arg == "timeout" for kw in node.keywords)):
                yield ctx.finding(
                    node, "ORP010",
                    f"bare .result() (no timeout) in dispatch-loop "
                    f"{fdef.name!r} — an unbounded block while requests "
                    "queue behind it; resolve futures in the resolve "
                    "stage, or pass a timeout",
                )
            elif (d in _BLOCKING_SYNC_CALLS
                  or (isinstance(node.func, ast.Attribute)
                      and node.func.attr in ("item", "cpu", "tolist",
                                             "synchronize")
                      and not node.args)):
                yield ctx.finding(
                    node, "ORP010",
                    f"host sync ({d or node.func.attr}) in dispatch-loop "
                    f"{fdef.name!r} — blocks the loop on the device; defer "
                    "device reads to the resolve stage",
                )


# -- ORP011 ------------------------------------------------------------------


def _is_cuda0(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cuda:0"  # orp: noqa[ORP011] -- the rule's own pattern: nothing is placed here


@rule("ORP011", "card-0 pinning ('cuda:0', set_device(0), bare .cuda()) in "
                "mesh-reachable code")
def check_single_device_assumptions(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if _is_cuda0(node):
            yield ctx.finding(
                node, "ORP011",
                "'cuda:0' pins work to card 0 whatever rank runs it — take the "
                "caller's device= or the mesh's (parallel/mesh.py), or noqa "
                "with why card 0 is really meant",
            )
        elif isinstance(node, ast.Call):
            d = dotted(node.func)
            a0 = node.args[0] if node.args else None
            if (d == "torch.device" and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and node.args[1].value == 0):
                yield ctx.finding(
                    node, "ORP011",
                    "torch.device('cuda', 0) pins work to card 0 — take the "
                    "caller's device= or the mesh's",
                )
            elif (d == "torch.cuda.set_device" and isinstance(a0, ast.Constant)
                  and a0.value == 0):
                yield ctx.finding(
                    node, "ORP011",
                    "torch.cuda.set_device(0) makes card 0 every rank's "
                    "current device — set the rank's own card "
                    "(parallel/multihost.py)",
                )
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "cuda" and not node.args
                  and not node.keywords and d != "torch.cuda"):
                yield ctx.finding(
                    node, "ORP011",
                    "bare .cuda() moves to the CURRENT card, whatever the "
                    "mesh placed — use .to(device) with the caller's or the "
                    "mesh's device",
                )


# -- ORP012 ------------------------------------------------------------------

# the functions where topology rebuilds / engine swaps / bundle reloads live
_ORP012_FN_RE = re.compile(r"rebuild|swap|reload|recover", re.IGNORECASE)
# lock-ish context managers by terminal name: _lock, lock, _cv, cond, mutex.
# (^|_) anchoring keeps "block"-style names out; "build" locks are exempt —
# a build serializer exists to hold construction, nothing drains under it
_ORP012_LOCK_RE = re.compile(r"(^|_)(lock|cv|cond|condition|mutex)$")
_ORP012_BUILDERS = {"HedgeEngine", "MicroBatcher", "load_bundle"}
_ORP012_DRAINS = {"close", "drain"}


def _lockish_name(expr: ast.expr) -> str | None:
    d = dotted(expr)
    if d is None:
        return None
    comp = d.split(".")[-1]
    if "build" in comp:
        return None
    return d if _ORP012_LOCK_RE.search(comp) else None


def _walk_with_body(node: ast.AST):
    """Descendants of a With block, pruning nested function/lambda bodies
    (deferred code does not run while the lock is held)."""
    stack = [s for item in getattr(node, "body", []) for s in [item]]
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


@rule("ORP012", "engine rebuild/swap work done while holding a lock")
def check_rebuild_under_lock(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if "serve/" not in path and "guard/" not in path:
        return
    for fdef in ast.walk(ctx.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _ORP012_FN_RE.search(fdef.name):
            continue
        for node in walk_scope(fdef):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            locks = [name for name in
                     (_lockish_name(item.context_expr)
                      for item in node.items) if name]
            if not locks:
                continue
            for sub in _walk_with_body(node):
                if not isinstance(sub, ast.Call):
                    continue
                d = dotted(sub.func)
                tail = d.split(".")[-1] if d is not None else None
                if tail in _ORP012_BUILDERS:
                    yield ctx.finding(
                        sub, "ORP012",
                        f"{tail} constructed while holding {locks[0]} in "
                        f"{fdef.name!r} — a build (bundle load, AOT "
                        "deserialize, possible compiles) head-of-line-"
                        "blocks every submit queued on that lock; build "
                        "outside, swap the pointer under the lock",
                    )
                elif (isinstance(sub.func, ast.Attribute)
                      and sub.func.attr in _ORP012_DRAINS):
                    yield ctx.finding(
                        sub, "ORP012",
                        f".{sub.func.attr}() while holding {locks[0]} in "
                        f"{fdef.name!r} — a drain resolves futures whose "
                        "done-callbacks may re-enter the lock holder "
                        "(deadlock); unlink under the lock, drain outside "
                        "every lock",
                    )


# -- ORP013 ------------------------------------------------------------------

# the functions that ARE the columnar ingest path: wire encode/decode, the
# block-lane submit, anything named for ingest — under the serve package
_ORP013_FN_RE = re.compile(r"ingest|decode|encode|submit_block")
# per-row object churn the columnar plane exists to eliminate
_ORP013_SUBMITS = {"submit", "submit_block"}
_ORP013_FUTURE_RE = re.compile(r"Future$")


@rule("ORP013", "per-row Python work inside columnar ingest-path code")
def check_ingest_row_loop(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if "serve/" not in path:
        return
    for fdef in ast.walk(ctx.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _ORP013_FN_RE.search(fdef.name):
            continue
        for loop in walk_scope(fdef):
            if not isinstance(loop, (ast.For, ast.AsyncFor)):
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func)
                tail = (d.split(".")[-1] if d is not None
                        else getattr(node.func, "attr", None))
                if tail in _ORP013_SUBMITS:
                    yield ctx.finding(
                        node, "ORP013",
                        f".{tail}() inside a for loop in ingest-path "
                        f"{fdef.name!r} — one submit per iteration is the "
                        "~6µs/row per-request ceiling the columnar lane "
                        "amortizes away; admit the rows as ONE block",
                    )
                elif (isinstance(node.func, ast.Name)
                      and _ORP013_FUTURE_RE.search(node.func.id)):
                    yield ctx.finding(
                        node, "ORP013",
                        f"{node.func.id}(...) constructed inside a for "
                        f"loop in ingest-path {fdef.name!r} — a future per "
                        "row is per-request object churn; the block lane "
                        "carries ONE future per block",
                    )
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr == "append"):
                    yield ctx.finding(
                        node, "ORP013",
                        f".append() inside a for loop in ingest-path "
                        f"{fdef.name!r} — growing a per-row Python list; "
                        "move the rows in columns (slice/mask/frombuffer)",
                    )


# -- ORP014 ------------------------------------------------------------------

# blocking socket primitives: any of these on an un-timed socket parks the
# calling thread until the peer feels like answering
_ORP014_SOCK_OPS = {"recv", "recv_into", "accept", "sendall", "connect"}
_ORP014_TIMEOUT_RE = re.compile(r"deadline|timeout|clock|wall", re.IGNORECASE)
_ORP014_READ_FN_RE = re.compile(r"read|recv", re.IGNORECASE)


def _orp014_configures_timeout(fdef: ast.AST) -> bool:
    """True when the function itself configures a socket timeout — a
    ``.settimeout(...)`` call or ``create_connection`` with a timeout."""
    for node in walk_scope(fdef):
        if not isinstance(node, ast.Call):
            continue
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "settimeout"):
            return True
        d = dotted(node.func)
        tail = (d.split(".")[-1] if d is not None
                else getattr(node.func, "attr", None))
        if tail == "create_connection" and (
                len(node.args) >= 2
                or any(kw.arg == "timeout" for kw in node.keywords)):
            return True
    return False


def _orp014_deadline_checked(loop: ast.AST) -> bool:
    """True when the loop body shows deadline evidence: a name/attribute/
    keyword matching deadline|timeout|clock|wall, or a monotonic-clock
    read — the check that bounds how long a stalled peer is humoured."""
    for node in ast.walk(loop):
        if isinstance(node, ast.Name) and _ORP014_TIMEOUT_RE.search(node.id):
            return True
        if (isinstance(node, ast.Attribute)
                and _ORP014_TIMEOUT_RE.search(node.attr)):
            return True
        if (isinstance(node, ast.keyword) and node.arg
                and _ORP014_TIMEOUT_RE.search(node.arg)):
            return True
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d is not None and d.split(".")[-1] in ("perf_counter",
                                                      "monotonic"):
                return True
    return False


@rule("ORP014", "unbounded socket I/O in serve-plane code")
def check_unbounded_socket_io(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if "serve/" not in path:
        return
    for fdef in ast.walk(ctx.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        has_timeout = _orp014_configures_timeout(fdef)
        is_read_fn = _ORP014_READ_FN_RE.search(fdef.name) is not None
        for node in walk_scope(fdef):
            if (not has_timeout and isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _ORP014_SOCK_OPS):
                yield ctx.finding(
                    node, "ORP014",
                    f".{node.func.attr}() in {fdef.name!r} with no "
                    "settimeout/create_connection(timeout=) reaching the "
                    "socket — a silent peer parks this thread forever; "
                    "configure a timeout (or noqa naming where it is "
                    "configured)",
                )
            elif (is_read_fn and isinstance(node, ast.While)
                    and isinstance(node.test, ast.Constant)
                    and bool(node.test.value)
                    and not _orp014_deadline_checked(node)):
                yield ctx.finding(
                    node, "ORP014",
                    f"unbounded `while True` loop in read-path "
                    f"{fdef.name!r} with no deadline/timeout check — a "
                    "stalled peer holds this handler forever; bound the "
                    "loop with a deadline",
                )


# -- ORP015 ------------------------------------------------------------------

# the legal instrument-name shape: static lowercase slash-path segments
_ORP015_NAME_RE = re.compile(r"^[a-z0-9_]+(/[a-z0-9_]+)*$")
# the obs façade helpers whose FIRST argument is an instrument name. Matched
# by unambiguous spellings only — the repo idiom `obs_count` alias or the
# dotted `obs.count` — never a bare `count`/`observe` attribute (which would
# collide with str.count / every Observer pattern ever written)
_ORP015_HELPER_DOTTED = {"obs.count", "obs.observe", "obs.set_gauge",
                         "obs.emit_record"}
_ORP015_HELPER_TAILS = {"obs_count", "obs_observe", "obs_set_gauge",
                        "obs_emit_record"}
# registry façade methods + raw instrument constructors: literal names are
# validated everywhere; non-literal names are allowed (module-level
# constants like LATENCY_HISTOGRAM are the sanctioned indirection)
_ORP015_REGISTRY_METHODS = {"counter", "gauge", "histogram"}
_ORP015_CONSTRUCTORS = {"Counter", "Gauge", "Histogram"}
# per-request / per-frame functions: the serve/train hot path where
# instrument CONSTRUCTION (interning under the registry lock) is churn
_ORP015_HOT_FN_RE = re.compile(
    r"(^|_)(submit|handle|frame|reply|dispatch|admit|resolve|recv|send|"
    r"step|evaluate)")
# the obs plumbing itself forwards caller-supplied names by design
_ORP015_EXEMPT_DIRS = ("obs/",)


def _orp015_call_kind(node: ast.Call) -> str | None:
    d = dotted(node.func)
    if d is None:
        return None
    parts = d.split(".")
    tail = parts[-1]
    if d in _ORP015_HELPER_DOTTED or tail in _ORP015_HELPER_TAILS:
        return "helper"
    if (tail in _ORP015_REGISTRY_METHODS and len(parts) >= 2
            and "reg" in parts[-2].lower()):
        return "registry"
    if isinstance(node.func, ast.Name) and tail in _ORP015_CONSTRUCTORS:
        return "constructor"
    return None


def _orp015_in_loop(fdef: ast.AST, target: ast.Call) -> bool:
    for loop in walk_scope(fdef):
        if isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
            if any(n is target for n in ast.walk(loop)):
                return True
    return False


@rule("ORP015", "dynamic obs instrument name / hot-path construction")
def check_instrument_hygiene(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if any("/" + d in path or path.startswith(d)
           for d in _ORP015_EXEMPT_DIRS):
        return
    in_hot_tree = "serve/" in path or "train/" in path
    for fdef in ast.walk(ctx.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        hot_fn = in_hot_tree and _ORP015_HOT_FN_RE.search(fdef.name)
        for node in walk_scope(fdef):
            if not isinstance(node, ast.Call):
                continue
            kind = _orp015_call_kind(node)
            if kind is None or not node.args:
                continue
            name_arg = node.args[0]
            literal = (name_arg.value
                       if isinstance(name_arg, ast.Constant)
                       and isinstance(name_arg.value, str) else None)
            if literal is not None and not _ORP015_NAME_RE.match(literal):
                yield ctx.finding(
                    node, "ORP015",
                    f"instrument name {literal!r} is not a lowercase "
                    "slash-path ([a-z0-9_]+(/[a-z0-9_]+)*) — the scrape "
                    "plane (prometheus names, orp top, doctor --metrics) "
                    "keys on the canonical shape",
                )
            elif literal is None and kind == "helper":
                yield ctx.finding(
                    node, "ORP015",
                    f"dynamic instrument name at {dotted(node.func)}(...) "
                    "— an f-string/variable name mints a new series per "
                    "value (unbounded registry growth, unprobeable "
                    "exposition); use a static literal with the variable "
                    "as a LABEL, or noqa why the name set is bounded",
                )
            if kind in ("registry", "constructor") and in_hot_tree:
                if hot_fn:
                    yield ctx.finding(
                        node, "ORP015",
                        f"instrument construction ({dotted(node.func)}) in "
                        f"per-request/per-frame function {fdef.name!r} — "
                        "registry interning takes a process-global lock; "
                        "intern at init time and keep the handle",
                    )
                elif _orp015_in_loop(fdef, node):
                    yield ctx.finding(
                        node, "ORP015",
                        f"instrument construction ({dotted(node.func)}) "
                        f"inside a loop in {fdef.name!r} — per-iteration "
                        "registry interning is hot-path churn; hoist the "
                        "instrument (or noqa why this is a lookup on a "
                        "cold path)",
                    )


# -- ORP016 ------------------------------------------------------------------

# argument/config-validation exception types: a compare-then-raise of one of
# these is input checking, not a measured acceptance verdict. WireError is
# the wire plane's ValueError (it subclasses it): a malformed-frame bounds
# check is input validation, answered as a structured ERROR frame with
# serve/gateway_errors counted at the catch site. TimeoutError is the
# deadline MECHANISM (the ORP014-sanctioned bounded-loop shape), whose
# catcher owns the response — the rule targets verdicts, not signals
_ORP016_VALIDATION_EXCS = {"ValueError", "TypeError", "KeyError",
                           "IndexError", "NotImplementedError",
                           "AssertionError", "SystemExit", "WireError",
                           "TimeoutError"}
# obs emission spellings that count as "the measurement was recorded": the
# repo-idiom aliases, the dotted façade, the flight recorder, the chain
_ORP016_EMIT_DOTTED = {"obs.count", "obs.observe", "obs.set_gauge",
                       "obs.emit_record", "flight.record", "obs_count",
                       "obs_observe", "obs_set_gauge", "obs_emit_record",
                       "chain_append", "_chain_verdict", "_canary_reject"}
# a gate may also RETURN its rejection instead of raising
_ORP016_REJECT_RE = re.compile(r"(Rejection|Rejected)$")


def _orp016_is_emission(node: ast.Call) -> bool:
    d = dotted(node.func)
    if d is None:
        return False
    tail = d.split(".")[-1]
    return (d in _ORP016_EMIT_DOTTED or tail in _ORP016_EMIT_DOTTED
            or d.endswith(".flight.record"))


def _orp016_measured_compare(test: ast.expr) -> bool:
    """An ordering comparison (>, <, >=, <=) with at least one non-constant
    side — the compare-a-measured-float shape (equality/identity tests and
    constant-vs-constant never are)."""
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare):
            continue
        if not any(isinstance(op, (ast.Gt, ast.Lt, ast.GtE, ast.LtE))
                   for op in node.ops):
            continue
        sides = [node.left, *node.comparators]
        if any(not isinstance(s, ast.Constant) for s in sides):
            return True
    return False


def _orp016_verdicts(body_stmts):
    """The verdict statements inside a gate's body: ``raise`` of a
    non-validation exception, or ``return`` of a ``*Rejection`` object.
    Nested function bodies are pruned (deferred code is not the gate)."""
    stack = list(body_stmts)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        if isinstance(n, ast.Raise):
            exc = n.exc
            callee = exc.func if isinstance(exc, ast.Call) else exc
            name = (dotted(callee) or "").split(".")[-1] if callee else ""
            if name and name not in _ORP016_VALIDATION_EXCS:
                yield n, name
        elif isinstance(n, ast.Return) and isinstance(n.value, ast.Call):
            name = (dotted(n.value.func) or "").split(".")[-1]
            if _ORP016_REJECT_RE.search(name):
                yield n, name
        stack.extend(ast.iter_child_nodes(n))


@rule("ORP016", "numeric acceptance gate that never records its measurement")
def check_unrecorded_gate(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if "serve/" not in path and "guard/" not in path:
        return
    for fdef in ast.walk(ctx.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        emit_lines = [n.lineno for n in walk_scope(fdef)
                      if isinstance(n, ast.Call) and _orp016_is_emission(n)]
        for node in walk_scope(fdef):
            if not isinstance(node, ast.If):
                continue
            if not _orp016_measured_compare(node.test):
                continue
            # the gate's branches: body plus a plain else (an elif chain in
            # orelse is its own If node with its own test — walk_scope
            # visits it separately, so including it here would double-flag)
            branches = list(node.body)
            if node.orelse and not (len(node.orelse) == 1
                                    and isinstance(node.orelse[0], ast.If)):
                branches += node.orelse
            for verdict, name in _orp016_verdicts(branches):
                # satisfied when an obs emission precedes the verdict —
                # earlier in the function (the measurement was recorded as
                # it was taken) or inside the gate body before the raise
                if any(ln < verdict.lineno for ln in emit_lines):
                    continue
                word = "raises" if isinstance(verdict, ast.Raise) \
                    else "returns"
                yield ctx.finding(
                    verdict, "ORP016",
                    f"acceptance gate in {fdef.name!r} compares a measured "
                    f"float and {word} {name} without recording the "
                    "measurement through obs first — a tripped gate nobody "
                    "can see in telemetry is a silent rollback; emit the "
                    "value (obs_count/obs_observe/obs_set_gauge/"
                    "flight.record) before the verdict",
                )


# -- ORP018 ------------------------------------------------------------------

# the functions that ARE placement decisions: routing, sharding, placement —
# where per-process salt silently splits the fleet's view
_ORP018_FN_RE = re.compile(r"rout|shard|placement", re.IGNORECASE)
# seeded constructors: an explicit seed argument makes the stream identical
# in every process, which is exactly the property routing needs
_ORP018_SEEDED_CTORS = {"random.Random", "np.random.default_rng",
                        "numpy.random.default_rng",
                        "np.random.Generator", "numpy.random.Generator",
                        "jax.random.PRNGKey", "jax.random.key"}


def _orp018_is_seeded(node: ast.Call) -> bool:
    return bool(node.args) or any(kw.arg == "seed" for kw in node.keywords)


@rule("ORP018", "per-process-salted hash/random in routing-decision code")
def check_salted_routing_hash(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if "serve/" not in path:
        return
    for fdef in ast.walk(ctx.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _ORP018_FN_RE.search(fdef.name):
            continue
        for node in walk_scope(fdef):
            if not isinstance(node, ast.Call):
                continue
            if (isinstance(node.func, ast.Name)
                    and node.func.id == "hash"):
                yield ctx.finding(
                    node, "ORP018",
                    f"builtin hash() in routing-decision {fdef.name!r} — "
                    "str/bytes hashes are salted per process "
                    "(PYTHONHASHSEED), so every gateway computes a "
                    "DIFFERENT mapping and the fleet's routing view "
                    "silently splits; use a keyed digest "
                    "(hashlib.blake2b — serve/fleet.py::route_weight)",
                )
                continue
            d = dotted(node.func)
            if d is None:
                continue
            if d in _ORP018_SEEDED_CTORS:
                if not _orp018_is_seeded(node):
                    yield ctx.finding(
                        node, "ORP018",
                        f"{d}() without a seed in routing-decision "
                        f"{fdef.name!r} — an unseeded generator makes a "
                        "placement decision that differs per process; "
                        "pass an explicit seed (or route on a keyed "
                        "digest)",
                    )
            elif (d.startswith(("random.", "np.random.", "numpy.random."))
                  and d.rsplit(".", 1)[-1] != "default_rng"):
                yield ctx.finding(
                    node, "ORP018",
                    f"{d}() in routing-decision {fdef.name!r} — the "
                    "module-global random stream is process-local state; "
                    "two gateways disagree on every draw. Route on a "
                    "keyed digest or a generator seeded from the "
                    "routing key",
                )


# -- ORP019 ------------------------------------------------------------------

# the persistence surfaces other processes read concurrently: the bundle
# store (catalog + CAS + warm cache) and the serve bundle exporter
_ORP019_SCOPE_DIRS = ("store/",)
_ORP019_SCOPE_FILES = ("serve/bundle.py",)
_ORP019_WRITE_METHODS = {"write_text", "write_bytes"}


def _orp019_open_mode(node: ast.Call) -> str | None:
    """The literal mode string of an ``open()`` call, or None when absent
    or dynamic (a dynamic mode is out of heuristic reach)."""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    else:
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
    if mode is None:
        return ""  # open(p) defaults to "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None


@rule("ORP019", "bare write in store/bundle persistence code (use utils/atomic)")
def check_bare_persistence_writes(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if not (any(d in path for d in _ORP019_SCOPE_DIRS)
            or path.endswith(_ORP019_SCOPE_FILES)):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id == "open":
            mode = _orp019_open_mode(node)
            if mode is not None and any(c in mode for c in "wax"):
                yield ctx.finding(
                    node, "ORP019",
                    f"open(..., {mode!r}) in persistence code — a crash "
                    "mid-write leaves a torn file at its final name for "
                    "every concurrent reader (a half-written catalog "
                    "bricks its tenants); write through "
                    "utils/atomic.atomic_write_text/_bytes "
                    "(temp + fsync + os.replace)",
                )
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _ORP019_WRITE_METHODS):
            yield ctx.finding(
                node, "ORP019",
                f".{node.func.attr}() in persistence code — the "
                "in-place write is torn the moment the process dies "
                "mid-call; write through "
                "utils/atomic.atomic_write_text/_bytes "
                "(temp + fsync + os.replace)",
            )


# -- ORP023 ------------------------------------------------------------------

# the pilot state-machine's transition methods: the explicit names the
# controller uses (``_enter_calibrating`` .. ``_enter_terminal``) plus the
# generic spellings a refactor might introduce
_ORP023_FN_RE = re.compile(r"^_enter_|transition|^advance$")
# the heavy calls a transition must never make while holding a lock:
# reload_tenant re-enters the host's own locking, the other three are
# seconds-scale training/pricing work
_ORP023_HEAVY = {"reload_tenant", "backward_induction", "train_fn"}


@rule("ORP023", "pilot transition without obs emission / heavy work under lock")
def check_pilot_transition_discipline(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if "pilot/" not in path:
        return
    for fdef in ast.walk(ctx.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _ORP023_FN_RE.search(fdef.name):
            continue
        emit_lines = [n.lineno for n in walk_scope(fdef)
                      if isinstance(n, ast.Call) and _orp016_is_emission(n)]
        first_emit = min(emit_lines, default=None)
        if first_emit is None:
            yield ctx.finding(
                fdef, "ORP023",
                f"transition {fdef.name!r} never emits to obs — a pilot "
                "state change nobody can see in telemetry is an invisible "
                "deploy; emit obs_count('pilot/transition', ...) before "
                "any other work",
            )
        else:
            for node in walk_scope(fdef):
                if (isinstance(node, ast.Return)
                        and node.lineno < first_emit):
                    yield ctx.finding(
                        node, "ORP023",
                        f"transition {fdef.name!r} returns before its obs "
                        "emission — the early path leaves no telemetry "
                        "trace of the state change; emit first, branch "
                        "after",
                    )
        for node in walk_scope(fdef):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            locks = [name for name in
                     (_lockish_name(item.context_expr)
                      for item in node.items) if name]
            if not locks:
                continue
            for sub in _walk_with_body(node):
                if not isinstance(sub, ast.Call):
                    continue
                d = dotted(sub.func)
                tail = d.split(".")[-1] if d is not None else None
                if tail is None:
                    continue
                if tail in _ORP023_HEAVY or tail.endswith("_hedge"):
                    yield ctx.finding(
                        sub, "ORP023",
                        f"{tail} called while holding {locks[0]} in "
                        f"{fdef.name!r} — reload_tenant takes the host's "
                        "own locks and a retrain runs for seconds; either "
                        "deadlocks or head-of-line-blocks the serving "
                        "plane; do the work outside, swap state under the "
                        "lock",
                    )


# -- ORP024 ------------------------------------------------------------------

# the serve hot-path modules the precision tiers thread one eval dtype
# through — the only files where an implicit construction dtype can undo
# a tier without failing anything
_ORP024_PATHS = ("serve/engine.py", "serve/megakernel.py",
                 "serve/precision.py")
_ORP024_CONS = {"torch.zeros", "torch.ones", "torch.full", "torch.empty",
                "torch.tensor", "torch.as_tensor"}


@rule("ORP024", "torch constructor with no dtype= on the serve hot path "
                "(undoes a bf16/int8 tier)")
def check_hot_path_dtype(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if not path.endswith(_ORP024_PATHS):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        if d not in _ORP024_CONS:
            continue
        if any(kw.arg == "dtype" for kw in node.keywords):
            continue
        yield ctx.finding(
            node, "ORP024",
            f"{d} without an explicit dtype= on the serve hot path — the "
            "default (f32, or the input's) silently undoes a bf16/int8 "
            "tier's intermediates: same answers, f32 bill. Pass the engine's "
            "eval dtype (the tier's dtype / the model's dtype)",
        )


@rule("ORP009", "except Exception that neither re-raises nor emits")
def check_silent_broad_except(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Try):
            continue
        for h in node.handlers:
            if _is_broad_handler(h) and not _handler_emits(h):
                what = ("bare except" if h.type is None
                        else f"except {dotted(h.type) or 'Exception'}")
                yield ctx.finding(
                    h, "ORP009",
                    f"{what} neither re-raises nor emits — a swallowed "
                    "failure degrades silently; re-raise, warnings.warn, or "
                    "emit an obs counter (or noqa with the reason the "
                    "emission happens elsewhere)",
                )
