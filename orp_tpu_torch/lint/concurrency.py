"""Project-wide lock-discipline analyzer: rules ORP020/ORP021/ORP022
(counterpart of ``orp_tpu/lint/concurrency.py``; framework-agnostic AST,
ported as it is and pointed at the port's threaded planes).

Every other rule in ``orp_tpu_torch/lint`` looks at one file at a time. This
module is the repo's first CROSS-MODULE analysis, because the bug class it
targets does not respect file boundaries: ``ServeHost`` (serve/host.py)
holds its host lock while calling into ``TierManager`` (store/tier.py),
which takes its own lock — the lock-order graph, the guarded-by map, and
the blocking-work-under-a-lock question are all properties of the
*project*, not of any file.

Scope: classes (and module-level locks) defined under the threaded
planes — ``orp_tpu_torch/{serve,store,obs,guard,pilot}``
(:data:`PLANE_DIRS`). The training/simulation code is single-threaded by
design and stays out.

The three rules:

ORP020  **inconsistently-guarded shared field** — the analyzer infers a
        guarded-by map per field from the observed access pattern: a field
        accessed with lock L held on >= 75% of its sites (>= 3 guarded
        sites, >= 4 sites total) is "guarded by L", and every remaining
        bare site is the classic torn-read/lost-update race (e.g. a tier
        counter read in ``stats()`` without the counter's lock). A read
        that genuinely tolerates tearing says so:
        ``# orp: noqa[ORP020] -- reason``.
ORP021  **blocking work while holding a lock** — socket ``recv``/
        ``accept``/``sendall``/``connect``, ``time.sleep``, file and CAS
        I/O (``open``/``read_text``/``atomic_write_*``/``load_bundle``),
        host syncs (``.item()``/``.cpu()``/``.tolist()``/
        ``.synchronize()``, and the JAX package's ``block_until_ready``/
        ``device_get``/``jnp.*`` dispatch, kept so its fixtures read the
        same), bare
        ``Future.result()``/``Condition.wait()`` with no timeout, and
        engine rebuilds (``HedgeEngine``/``MicroBatcher``) inside a
        ``with <lock>:`` region. Every queued acquirer pays the hold.
        Locks whose name contains ``build`` are exempt — a build
        serializer exists precisely to hold construction (the ORP012
        precedent) — and a ``cv.wait()`` on the only lock held is the
        sanctioned condition-variable shape (wait releases it).
ORP022  **lock-order cycle** — a static acquisition-order graph: edge
        A -> B when some code path acquires B while holding A, including
        paths that cross modules through resolved method calls
        (``self.tiers.note_warm(...)`` under the host lock contributes
        ``ServeHost._lock -> TierManager._lock``). A cycle in the graph is
        a deadlock found at lint time instead of in a fleet drill; a
        non-reentrant lock re-acquired on its own path is the
        length-1 cycle.

Honest heuristic limits (documented, not hidden): lock identity is
per-CLASS-attribute (``ServeHost._lock``), not per-instance — two
instances of one class locked in opposite orders by design need a noqa;
calls through module-level *functions* (e.g. the ``obs_count`` façade) are
not traversed — only method calls resolvable through ``self``, an
inferred attribute type (``self.tiers = TierManager()`` / a parameter
annotation), or a direct constructor; and a method is credited with its
callers' locks only when EVERY visible call site holds them (so a helper
documented "caller holds the host lock" — ``_sweep_locked`` — neither
false-positives ORP020 nor hides ORP022 edges).
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Iterable, Iterator

from orp_tpu_torch.lint.engine import (
    NOQA_RE,
    Finding,
    dotted,
    iter_python_files,
)

#: the threaded planes this analyzer indexes; everything else in the repo
#: is single-threaded by design (training walks, sde kernels, tools)
PLANE_DIRS = ("serve", "store", "obs", "guard", "pilot")

#: ORP020 inference thresholds: a field needs MIN_SITES observed accesses,
#: of which MIN_GUARDED under one lock covering >= COVERAGE of all sites,
#: before its bare sites are findings — below that the pattern is opinion,
#: not evidence
MIN_SITES = 4
MIN_GUARDED = 3
COVERAGE = 0.75

_LOCK_CTORS = {
    "threading.Lock": ("lock", False),
    "threading.RLock": ("rlock", True),
    "threading.Condition": ("condition", True),
    "Lock": ("lock", False),
    "RLock": ("rlock", True),
    "Condition": ("condition", True),
}

#: rule registry for the listing/SARIF surfaces (the per-file engine keeps
#: its own registry; these rules cannot run per-file)
CONCURRENCY_RULES = {
    "ORP020": "shared field guarded by a lock on most sites but bare on "
              "others (torn read / lost update)",
    "ORP021": "blocking work (I/O, sleep, dispatch, bare wait) while "
              "holding a lock",
    "ORP022": "lock-order cycle across the serve/store/obs/guard/pilot "
              "planes (static deadlock)",
}


# -- index ---------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LockDecl:
    key: str            # "ServeHost._lock" / "manifest._CHAIN_LOCK"
    kind: str           # lock | rlock | condition
    reentrant: bool
    owner: str | None   # owning class name (None: module-level)
    attr: str
    path: str
    line: int


class ClassInfo:
    """One indexed class: methods, lock attrs, fields, inferred attr types."""

    def __init__(self, name: str, path: str):
        self.name = name
        self.path = path
        self.methods: dict[str, ast.FunctionDef] = {}
        self.locks: dict[str, LockDecl] = {}
        self.aliases: dict[str, str] = {}        # _swap_cv -> _lock
        self.fields: set[str] = set()            # self.X assigned anywhere
        self.mutated: set[str] = set()           # self.X assigned OUTSIDE __init__
        self.attr_types: dict[str, set[str]] = {}  # self.X -> candidate classes

    def lock_for(self, attr: str) -> LockDecl | None:
        return self.locks.get(self.aliases.get(attr, attr))


def _lock_ctor(call: ast.AST) -> tuple[str, bool] | None:
    if not isinstance(call, ast.Call):
        return None
    return _LOCK_CTORS.get(dotted(call.func) or "")


def _annotation_names(node: ast.AST | None) -> set[str]:
    """Class names mentioned anywhere in an annotation (handles ``X | None``,
    ``Optional[X]``, dotted spellings — the terminal name is what matters)."""
    if node is None:
        return set()
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            # forward reference: 'AHost' / "BTier | None" in quotes
            try:
                out |= _annotation_names(ast.parse(sub.value, mode="eval"))
            except SyntaxError:
                continue
    return out


class ProjectIndex:
    """Pass 1 over every plane file: classes, locks, fields, attr types."""

    def __init__(self, sources: dict[str, str]):
        self.sources = sources
        self.lines: dict[str, list[str]] = {
            p: s.splitlines() for p, s in sources.items()
        }
        self.trees: dict[str, ast.Module] = {}
        for path, src in sources.items():
            try:
                self.trees[path] = ast.parse(src)
            except SyntaxError:
                continue  # the per-file engine reports ORP000 for these
        # class name -> every ClassInfo carrying it (collisions possible:
        # resolution by name is only trusted when the name is unique)
        self.classes: dict[str, list[ClassInfo]] = {}
        self.module_locks: dict[str, dict[str, LockDecl]] = {}
        for path, tree in self.trees.items():
            self._index_module(path, tree)
        self._resolve_attr_types()
        # field name -> owning classes (for cross-object access resolution)
        self.field_owners: dict[str, list[ClassInfo]] = {}
        for infos in self.classes.values():
            for ci in infos:
                for f in ci.fields:
                    self.field_owners.setdefault(f, []).append(ci)

    # -- construction ---------------------------------------------------------

    def _index_module(self, path: str, tree: ast.Module) -> None:
        stem = pathlib.Path(path).stem
        mlocks = self.module_locks.setdefault(path, {})
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self._index_class(path, node)
            elif isinstance(node, ast.Assign):
                kb = _lock_ctor(node.value)
                if kb is None:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        mlocks[t.id] = LockDecl(
                            f"{stem}.{t.id}", kb[0], kb[1], None, t.id,
                            path, node.lineno)

    def _index_class(self, path: str, cdef: ast.ClassDef) -> None:
        ci = ClassInfo(cdef.name, path)
        self.classes.setdefault(cdef.name, []).append(ci)
        pending_alias: list[tuple[str, str]] = []
        for stmt in cdef.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ci.methods.setdefault(stmt.name, stmt)
            elif isinstance(stmt, ast.Assign):
                # class-level lock (SlimFuture._lock) and __slots__ fields
                kb = _lock_ctor(stmt.value)
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and kb is not None:
                        ci.locks[t.id] = LockDecl(
                            f"{cdef.name}.{t.id}", kb[0], kb[1],
                            cdef.name, t.id, path, stmt.lineno)
                    elif (isinstance(t, ast.Name) and t.id == "__slots__"
                          and isinstance(stmt.value, (ast.Tuple, ast.List))):
                        ci.fields |= {
                            e.value for e in stmt.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)
                        }
        for mname, mdef in ci.methods.items():
            param_ann = {
                a.arg: _annotation_names(a.annotation)
                for a in (*mdef.args.posonlyargs, *mdef.args.args,
                          *mdef.args.kwonlyargs)
            }
            for node in ast.walk(mdef):
                if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    value = node.value
                    for t in targets:
                        if not (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            continue
                        ci.fields.add(t.attr)
                        if mname != "__init__":
                            ci.mutated.add(t.attr)
                        if value is None:
                            continue
                        kb = _lock_ctor(value)
                        if kb is not None:
                            ci.locks[t.attr] = LockDecl(
                                f"{ci.name}.{t.attr}", kb[0], kb[1],
                                ci.name, t.attr, path, node.lineno)
                            # Condition(self._x) shares _x's underlying lock
                            if (kb[0] == "condition"
                                    and isinstance(value, ast.Call)
                                    and value.args):
                                a0 = dotted(value.args[0]) or ""
                                if a0.startswith("self."):
                                    pending_alias.append(
                                        (t.attr, a0.split(".", 1)[1]))
                            continue
                        # attr type evidence: constructor calls in the value
                        # (both arms of a ternary), the annotation, or the
                        # annotated __init__ parameter being stored
                        names: set[str] = set()
                        for sub in ast.walk(value):
                            if isinstance(sub, ast.Call):
                                d = dotted(sub.func)
                                if d is not None:
                                    names.add(d.split(".")[-1])
                        if isinstance(value, ast.Name):
                            names |= param_ann.get(value.id, set())
                        if isinstance(node, ast.AnnAssign):
                            names |= _annotation_names(node.annotation)
                        if names:
                            ci.attr_types.setdefault(t.attr, set()).update(
                                names)
        for cv_attr, target in pending_alias:
            if target in ci.locks:
                ci.aliases[cv_attr] = target
                del ci.locks[cv_attr]
        # a lock attribute is never a shared *data* field
        ci.fields -= set(ci.locks) | set(ci.aliases)

    def _resolve_attr_types(self) -> None:
        """Keep only candidate type names that resolve to exactly one
        indexed class — ambiguity means no resolution, never a guess."""
        for infos in self.classes.values():
            for ci in infos:
                for attr, names in list(ci.attr_types.items()):
                    resolved = {
                        n for n in names
                        if n in self.classes and len(self.classes[n]) == 1
                    }
                    if resolved:
                        ci.attr_types[attr] = resolved
                    else:
                        del ci.attr_types[attr]

    # -- resolution helpers ---------------------------------------------------

    def unique_class(self, name: str) -> ClassInfo | None:
        infos = self.classes.get(name)
        return infos[0] if infos is not None and len(infos) == 1 else None

    def resolve_lock(self, expr: ast.expr, cls: ClassInfo | None,
                     path: str) -> LockDecl | None:
        """``with <expr>:`` -> the class/module lock it acquires, if the
        analyzer can tell. ``self.X`` resolves through the owning class
        (aliases included); a bare name through the module's locks;
        ``self.a.b`` through the inferred type of ``a``; ``obj.X``
        through field-name uniqueness across the whole index."""
        d = dotted(expr)
        if d is None:
            return None
        parts = d.split(".")
        if parts[0] == "self" and cls is not None:
            if len(parts) == 2:
                return cls.lock_for(parts[1])
            if len(parts) == 3:
                for tname in cls.attr_types.get(parts[1], ()):
                    tci = self.unique_class(tname)
                    if tci is not None:
                        decl = tci.lock_for(parts[2])
                        if decl is not None:
                            return decl
                return None
        if len(parts) == 1:
            return self.module_locks.get(path, {}).get(parts[0])
        # obj.X: trust the terminal attr only when exactly ONE indexed
        # class declares a lock (or alias) under that name
        attr = parts[-1]
        owners = [
            ci for infos in self.classes.values() for ci in infos
            if ci.lock_for(attr) is not None
        ]
        if len(owners) == 1:
            return owners[0].lock_for(attr)
        return None


# -- per-method fact collection ------------------------------------------------


@dataclasses.dataclass
class _Facts:
    """Everything one function body tells the project-wide analysis."""

    method: tuple[str, str]                       # (class name or "", fn name)
    path: str
    # (decl, node, locks held at the acquire)
    acquires: list[tuple[LockDecl, ast.AST, tuple[str, ...]]]
    # (node, description, held, wait_target_key)
    blocking: list[tuple[ast.AST, str, tuple[str, ...], str | None]]
    # ((owner class, attr), node, held, is_write)
    accesses: list[tuple[tuple[str, str], ast.AST, tuple[str, ...], bool]]
    # ((callee class, callee method), node, held)
    calls: list[tuple[tuple[str, str], ast.AST, tuple[str, ...]]]


_SOCKET_OPS = {"recv", "recv_into", "accept", "sendall", "connect"}
_SYNC_TAILS = {"block_until_ready", "device_get", "item", "cpu", "tolist",
               "synchronize"}
_IO_TAILS = {"load_bundle", "atomic_write_text", "atomic_write_bytes",
             "write_text", "write_bytes", "read_text", "read_bytes",
             "fsync", "flush"}
_IO_DOTTED = {"os.replace", "os.rename", "json.dump", "json.load",
              "pickle.dump", "pickle.load"}
_BUILDER_TAILS = {"HedgeEngine", "MicroBatcher"}
_DISPATCH_EXEMPT = (
    "jax.block_until_ready", "jax.device_get", "jax.profiler", "jax.debug",
    "jax.config", "jax.random.key", "jax.random.PRNGKey", "jax.devices",
    "jax.default_backend", "jax.tree", "jax.monitoring", "jax.jit",
)


def _has_timeout(call: ast.Call) -> bool:
    return bool(call.args) or any(kw.arg == "timeout" for kw in call.keywords)


def _blocking_reason(call: ast.Call) -> str | None:
    """Why this call blocks, or None. The wait/result timeout cases are
    handled by the caller (they need the held set)."""
    d = dotted(call.func)
    tail = (d.split(".")[-1] if d is not None
            else getattr(call.func, "attr", None))
    if d == "time.sleep":
        return "time.sleep"
    if isinstance(call.func, ast.Attribute) and call.func.attr in _SOCKET_OPS:
        return f"socket .{call.func.attr}()"
    if tail in _SYNC_TAILS:
        return f"host sync ({tail})"
    if isinstance(call.func, ast.Name) and call.func.id == "open":
        return "file open()"
    if tail in _IO_TAILS:
        return f"file/CAS I/O ({tail})"
    if d in _IO_DOTTED:
        return f"file I/O ({d})"
    if tail in _BUILDER_TAILS:
        return f"engine rebuild ({tail})"
    if d is not None and d.startswith(("jnp.", "jax.")) \
            and not d.startswith(_DISPATCH_EXEMPT):
        return f"jit dispatch ({d})"
    return None


class _FnWalker:
    """Walk one function body tracking the ordered set of held locks.

    Nested function/lambda bodies are pruned (deferred code does not run
    while the lock is held — the same rule ORP012 applies)."""

    def __init__(self, index: ProjectIndex, path: str,
                 cls: ClassInfo | None, fdef: ast.FunctionDef):
        self.index = index
        self.path = path
        self.cls = cls
        self.fdef = fdef
        self.facts = _Facts(
            (cls.name if cls is not None else "", fdef.name),
            path, [], [], [], [])

    def run(self) -> _Facts:
        self._walk_body(self.fdef.body, ())
        return self.facts

    # -- walking --------------------------------------------------------------

    def _walk_body(self, body: list[ast.stmt], held: tuple[str, ...]) -> None:
        for stmt in body:
            self._walk_stmt(stmt, held)

    def _walk_stmt(self, stmt: ast.stmt, held: tuple[str, ...]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in stmt.items:
                self._walk_expr(item.context_expr, held, lock_expr=True)
                decl = self.index.resolve_lock(
                    item.context_expr, self.cls, self.path)
                if decl is not None:
                    self.facts.acquires.append((decl, stmt, new_held))
                    if decl.key not in new_held:
                        new_held = (*new_held, decl.key)
            self._walk_body(stmt.body, new_held)
            return
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._walk_expr(node, held)
            elif isinstance(node, ast.stmt):
                self._walk_stmt(node, held)
            elif isinstance(node, (ast.ExceptHandler,)):
                self._walk_body(node.body, held)
            elif isinstance(node, ast.withitem):  # pragma: no cover - guarded above
                continue
        # Assign targets are expressions too (writes)
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                self._record_access(t, held, is_write=True)

    def _walk_expr(self, expr: ast.expr, held: tuple[str, ...],
                   lock_expr: bool = False) -> None:
        for node in ast.walk(expr):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Attribute) and not lock_expr:
                self._record_access(node, held, is_write=False)
            elif isinstance(node, ast.Call):
                self._record_call(node, held)

    # -- recording ------------------------------------------------------------

    def _record_access(self, node: ast.AST, held: tuple[str, ...],
                       is_write: bool) -> None:
        if is_write and not isinstance(node, ast.Attribute):
            # only the actual mutation target is a write: ``x[i.attr] = v``
            # mutates the container ``x``, not the index expression (whose
            # attribute reads the expression walk already recorded)
            if isinstance(node, ast.Subscript):
                self._record_access(node.value, held, is_write=True)
            elif isinstance(node, (ast.Tuple, ast.List, ast.Starred)):
                for sub in ast.iter_child_nodes(node):
                    if isinstance(sub, ast.expr):
                        self._record_access(sub, held, is_write=True)
            return
        if not isinstance(node, ast.Attribute):
            return
        owner = self._owner_of(node)
        if owner is not None:
            self.facts.accesses.append((owner, node, held, is_write))

    def _owner_of(self, node: ast.Attribute) -> tuple[str, str] | None:
        """(owning class, field) for this attribute access, or None."""
        attr = node.attr
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            if self.cls is not None and attr in self.cls.fields:
                return (self.cls.name, attr)
            return None
        # obj.attr: trust field-name uniqueness — project-wide, or failing
        # that within the accessing file (``t.pending`` in host.py means
        # ``_Tenant.pending`` even though gateway.py has a ``pending`` too)
        # — and never shadowed by the accessing class's own field
        if self.cls is not None and attr in self.cls.fields:
            return None
        owners = self.index.field_owners.get(attr, ())
        if len(owners) == 1:
            return (owners[0].name, attr)
        local = [ci for ci in owners if ci.path == self.path]
        if len(local) == 1:
            return (local[0].name, attr)
        return None

    def _record_call(self, call: ast.Call, held: tuple[str, ...]) -> None:
        why = _blocking_reason(call)
        wait_key = None
        if why is None and isinstance(call.func, ast.Attribute):
            if call.func.attr == "result" and not _has_timeout(call):
                why = "bare Future.result() (no timeout)"
            elif call.func.attr == "wait" and not _has_timeout(call):
                why = "bare Condition.wait() (no timeout)"
                decl = self.index.resolve_lock(call.func.value, self.cls,
                                               self.path)
                wait_key = decl.key if decl is not None else None
        if why is not None:
            self.facts.blocking.append((call, why, held, wait_key))
        callee = self._resolve_callee(call)
        if callee is not None:
            self.facts.calls.append((callee, call, held))

    def _resolve_callee(self, call: ast.Call) -> tuple[str, str] | None:
        d = dotted(call.func)
        if d is None:
            return None
        parts = d.split(".")
        # ClassName(...) -> __init__
        tail_cls = self.index.unique_class(parts[-1])
        if tail_cls is not None and "__init__" in tail_cls.methods:
            return (tail_cls.name, "__init__")
        if parts[0] == "self" and self.cls is not None:
            if len(parts) == 2 and parts[1] in self.cls.methods:
                return (self.cls.name, parts[1])
            if len(parts) == 3:
                for tname in self.cls.attr_types.get(parts[1], ()):
                    tci = self.index.unique_class(tname)
                    if tci is not None and parts[2] in tci.methods:
                        return (tci.name, parts[2])
        return None


# -- analysis ------------------------------------------------------------------


def _is_build_lock(key: str) -> bool:
    return "build" in key.split(".")[-1].lower()


class Analyzer:
    """Pass 2: collect per-function facts, propagate caller-held locks,
    then evaluate the three rules over the whole project."""

    def __init__(self, sources: dict[str, str]):
        self.index = ProjectIndex(sources)
        self.facts: dict[tuple[str, str], _Facts] = {}
        for path, tree in self.index.trees.items():
            for node in tree.body:
                if isinstance(node, ast.ClassDef):
                    infos = self.index.classes.get(node.name, [])
                    ci = next((c for c in infos if c.path == path
                               and c.methods
                               and any(m is s for s in node.body
                                       for m in c.methods.values())), None)
                    if ci is None:
                        ci = next((c for c in infos if c.path == path), None)
                    if ci is None:
                        continue
                    for mdef in ci.methods.values():
                        f = _FnWalker(self.index, path, ci, mdef).run()
                        self.facts[(ci.name, mdef.name)] = f
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    f = _FnWalker(self.index, path, None, node).run()
                    self.facts[("", f"{path}:{node.name}")] = f
        self._compute_effective_held()
        self._compute_may_acquire()

    # -- caller-context propagation -------------------------------------------

    def _compute_effective_held(self) -> None:
        """``eff[m]``: locks EVERY visible call site of private method m
        holds (greatest fixpoint). Public methods and methods with no
        visible call site get the empty set — external callers are
        unknown, so crediting them locks would hide races."""
        all_locks = frozenset(
            d.key
            for infos in self.index.classes.values() for ci in infos
            for d in ci.locks.values()
        ) | frozenset(
            d.key for ml in self.index.module_locks.values()
            for d in ml.values()
        )
        call_sites: dict[tuple[str, str],
                         list[tuple[tuple[str, str], tuple[str, ...]]]] = {}
        init_called: set[tuple[str, str]] = set()
        for mkey, f in self.facts.items():
            for callee, _node, held in f.calls:
                if mkey == (callee[0], "__init__"):
                    # a helper called from its own __init__ (the
                    # ``_reset_locked`` shape) runs pre-sharing there:
                    # that site neither guards nor endangers anything
                    init_called.add(callee)
                    continue
                call_sites.setdefault(callee, []).append((mkey, held))
        self.eff: dict[tuple[str, str], frozenset[str]] = {}
        for mkey in self.facts:
            name = mkey[1]
            private = (name.startswith("_") and not name.startswith("__")
                       and mkey[0])
            self.eff[mkey] = (all_locks
                              if private and (call_sites.get(mkey)
                                              or mkey in init_called) else
                              frozenset())
        for _ in range(len(self.facts)):
            changed = False
            for mkey, eff in list(self.eff.items()):
                sites = call_sites.get(mkey)
                if not sites:
                    continue
                new = None
                for caller, held in sites:
                    ctx = frozenset(held) | self.eff.get(caller, frozenset())
                    new = ctx if new is None else (new & ctx)
                new = new if new is not None else frozenset()
                if new != eff:
                    self.eff[mkey] = new
                    changed = True
            if not changed:
                break

    def _held(self, mkey: tuple[str, str],
              held: tuple[str, ...]) -> frozenset[str]:
        return frozenset(held) | self.eff.get(mkey, frozenset())

    # -- transitive acquisition sets ------------------------------------------

    def _compute_may_acquire(self) -> None:
        self.may_acquire: dict[tuple[str, str], frozenset[str]] = {
            mkey: frozenset(d.key for d, _n, _h in f.acquires)
            for mkey, f in self.facts.items()
        }
        for _ in range(len(self.facts)):
            changed = False
            for mkey, f in self.facts.items():
                cur = self.may_acquire[mkey]
                new = cur
                for callee, _node, _held in f.calls:
                    new |= self.may_acquire.get(callee, frozenset())
                if new != cur:
                    self.may_acquire[mkey] = new
                    changed = True
            if not changed:
                break

    # -- rules ----------------------------------------------------------------

    def findings(self) -> Iterator[Finding]:
        yield from self._orp020()
        yield from self._orp021()
        yield from self._orp022()

    def _orp020(self) -> Iterator[Finding]:
        sites: dict[tuple[str, str],
                    list[tuple[str, ast.AST, frozenset[str], bool]]] = {}
        for mkey, f in self.facts.items():
            in_owner_init = mkey[1] == "__init__"
            for owner, node, held, is_write in f.accesses:
                if in_owner_init and owner[0] == mkey[0]:
                    continue  # construction precedes sharing
                sites.setdefault(owner, []).append(
                    (f.path, node, self._held(mkey, held), is_write))
        for (cls_name, attr), rows in sorted(sites.items()):
            if not any(w for _p, _n, _h, w in rows):
                continue  # never written after construction: cannot tear
            # one site per (path, line): an augmented read-modify-write is
            # one fix, and one noqa should cover it
            dedup: dict[tuple[str, int], tuple[str, ast.AST, frozenset[str]]] = {}
            for path, node, held, _w in rows:
                key = (path, node.lineno)
                prev = dedup.get(key)
                if prev is None or held > prev[2]:
                    dedup[key] = (path, node, held)
            uniq = list(dedup.values())
            if len(uniq) < MIN_SITES:
                continue
            counts: dict[str, int] = {}
            for _p, _n, held in uniq:
                for k in held:
                    counts[k] = counts.get(k, 0) + 1
            if not counts:
                continue
            lock = max(counts, key=lambda k: (counts[k], k))
            guarded = counts[lock]
            if guarded < MIN_GUARDED or guarded / len(uniq) < COVERAGE:
                continue
            for path, node, held in sorted(
                    uniq, key=lambda r: (r[0], r[1].lineno)):
                if lock in held:
                    continue
                yield Finding(
                    path, node.lineno, node.col_offset, "ORP020",
                    f"field {cls_name}.{attr} is guarded by {lock} on "
                    f"{guarded}/{len(uniq)} sites but accessed without it "
                    "here — a torn read/lost update the moment two threads "
                    f"interleave; acquire {lock} (or noqa with why this "
                    "access tolerates tearing)",
                )

    def _orp021(self) -> Iterator[Finding]:
        for mkey, f in self.facts.items():
            for node, why, held, wait_key in f.blocking:
                locks = [k for k in self._held(mkey, held)
                         if not _is_build_lock(k)]
                if wait_key is not None:
                    # cv.wait() releases ITS OWN lock; the hazard is any
                    # OTHER lock staying held through the unbounded wait
                    locks = [k for k in locks if k != wait_key]
                elif why.startswith("bare Condition.wait"):
                    # unresolved wait target: assume the innermost held
                    # lock is the cv's own (the dominant with-cv shape)
                    locks = locks[:-1] if held else locks
                if not locks:
                    continue
                lock = sorted(locks)[-1]
                yield Finding(
                    f.path, node.lineno, node.col_offset, "ORP021",
                    f"{why} while holding {lock} in {mkey[1]!r} — every "
                    "thread queued on that lock pays this wait; move the "
                    "blocking work outside the critical section and swap "
                    "results under the lock (or noqa with why the hold is "
                    "the point)",
                )

    def _orp022(self) -> Iterator[Finding]:
        decls: dict[str, LockDecl] = {}
        for infos in self.index.classes.values():
            for ci in infos:
                for d in ci.locks.values():
                    decls[d.key] = d
        for ml in self.index.module_locks.values():
            for d in ml.values():
                decls[d.key] = d
        edges: dict[tuple[str, str], tuple[str, int, str]] = {}

        def add_edge(a: str, b: str, path: str, line: int, via: str) -> None:
            if a == b:
                return  # reentrancy handled separately below
            edges.setdefault((a, b), (path, line, via))

        self_deadlocks: list[tuple[str, str, int]] = []
        for mkey, f in self.facts.items():
            for decl, node, held in f.acquires:
                full = self._held(mkey, held)
                if decl.key in full and not decl.reentrant:
                    self_deadlocks.append((decl.key, f.path, node.lineno))
                for h in full:
                    add_edge(h, decl.key, f.path, node.lineno, "acquires")
            for callee, node, held in f.calls:
                full = self._held(mkey, held)
                if not full:
                    continue
                for k in self.may_acquire.get(callee, ()):
                    for h in full:
                        if h == k:
                            d = decls.get(k)
                            if d is not None and not d.reentrant:
                                self_deadlocks.append(
                                    (k, f.path, node.lineno))
                            continue
                        add_edge(h, k, f.path, node.lineno,
                                 f"calls {callee[0]}.{callee[1]} which "
                                 "acquires")
        seen_self: set[str] = set()
        for key, path, line in sorted(set(self_deadlocks)):
            if key in seen_self:
                continue  # one finding per lock: the fix is one restructure
            seen_self.add(key)
            yield Finding(
                path, line, 0, "ORP022",
                f"non-reentrant lock {key} may be re-acquired on a path "
                "that already holds it — instant self-deadlock; make it an "
                "RLock or restructure the call path",
            )
        yield from self._cycles(edges)

    def _cycles(self, edges: dict[tuple[str, str], tuple[str, int, str]]
                ) -> Iterator[Finding]:
        graph: dict[str, list[str]] = {}
        for a, b in edges:
            graph.setdefault(a, []).append(b)
            graph.setdefault(b, [])
        seen_cycles: set[tuple[str, ...]] = set()
        # DFS cycle detection with path reconstruction
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        for root in sorted(graph):
            if color[root] != WHITE:
                continue
            stack: list[tuple[str, Iterator[str]]] = [
                (root, iter(sorted(graph[root])))]
            path = [root]
            color[root] = GREY
            while stack:
                node, it = stack[-1]
                child = next(it, None)
                if child is None:
                    color[node] = BLACK
                    stack.pop()
                    path.pop()
                    continue
                if color[child] == GREY:
                    i = path.index(child)
                    cycle = path[i:]
                    canon = tuple(sorted(cycle))
                    if canon in seen_cycles:
                        continue
                    seen_cycles.add(canon)
                    hops = [*cycle, child]
                    legs = []
                    for a, b in zip(hops, hops[1:]):
                        p, ln, via = edges[(a, b)]
                        legs.append(
                            f"{a} -> {b} "
                            f"({pathlib.Path(p).name}:{ln}, {via})")
                    p0, ln0, _via0 = edges[(hops[0], hops[1])]
                    yield Finding(
                        p0, ln0, 0, "ORP022",
                        "lock-order cycle: " + "; ".join(legs) + " — two "
                        "threads interleaving these orders deadlock; pick "
                        "ONE canonical order (ARCHITECTURE.md 'Concurrency "
                        "model') and restructure the inner acquisition",
                    )
                elif color[child] == WHITE:
                    color[child] = GREY
                    path.append(child)
                    stack.append((child, iter(sorted(graph[child]))))

    # -- introspection (doctor / docs) ----------------------------------------

    def lock_order_edges(self) -> list[dict]:
        """The observed acquisition-order edges (for ARCHITECTURE docs and
        the doctor report): ``[{"from", "to", "site"}...]``, sorted."""
        edges: dict[tuple[str, str], str] = {}
        for mkey, f in self.facts.items():
            for decl, node, held in f.acquires:
                for h in self._held(mkey, held):
                    if h != decl.key:
                        edges.setdefault(
                            (h, decl.key),
                            f"{pathlib.Path(f.path).name}:{node.lineno}")
            for callee, node, held in f.calls:
                for h in self._held(mkey, held):
                    for k in self.may_acquire.get(callee, ()):
                        if h != k:
                            edges.setdefault(
                                (h, k),
                                f"{pathlib.Path(f.path).name}:{node.lineno}")
        return [{"from": a, "to": b, "site": s}
                for (a, b), s in sorted(edges.items())]

    def stats(self) -> dict:
        return {
            "files": len(self.index.trees),
            "classes": sum(len(v) for v in self.index.classes.values()),
            "locks": len({d.key
                          for infos in self.index.classes.values()
                          for ci in infos for d in ci.locks.values()}
                         | {d.key for ml in self.index.module_locks.values()
                            for d in ml.values()}),
            "edges": len(self.lock_order_edges()),
        }


# -- entry points --------------------------------------------------------------


def _suppressed(f: Finding, lines: dict[str, list[str]]) -> bool:
    src = lines.get(f.path)
    if src is None or not 1 <= f.line <= len(src):
        return False
    m = NOQA_RE.search(src[f.line - 1])
    if m is None:
        return False
    codes = m.group("codes")
    if codes is None:
        return True
    return f.rule in {c.strip() for c in codes.split(",")}


def analyze_sources(sources: dict[str, str],
                    select: Iterable[str] | None = None) -> list[Finding]:
    """Project-wide concurrency analysis over in-memory sources (path ->
    text). Paths matter: only files under a plane dir participate, and
    class locks are keyed per class wherever they are defined. Returns
    unsuppressed findings sorted by (path, line, rule)."""
    codes = set(select) if select is not None else set(CONCURRENCY_RULES)
    unknown = codes - set(CONCURRENCY_RULES)
    if unknown:
        raise ValueError(
            f"unknown concurrency rule(s) {sorted(unknown)}; known: "
            f"{sorted(CONCURRENCY_RULES)}")
    analyzer = Analyzer(sources)
    out = [
        f for f in analyzer.findings()
        if f.rule in codes and not _suppressed(f, analyzer.index.lines)
    ]
    return sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule))


def plane_files(paths: Iterable[str | pathlib.Path]) -> list[pathlib.Path]:
    """The plane (.py) files under ``paths``: every file with a
    serve/store/obs/guard/pilot path component."""
    out = []
    for f in iter_python_files(paths):
        if any(part in PLANE_DIRS for part in f.parts):
            out.append(f)
    return out


def analyze_paths(paths: Iterable[str | pathlib.Path],
                  select: Iterable[str] | None = None) -> list[Finding]:
    """Project-wide concurrency analysis over the plane files under
    ``paths`` (directories are scanned recursively; non-plane files are
    ignored — the rules are about the threaded planes)."""
    sources = {str(f): f.read_text() for f in plane_files(paths)}
    return analyze_sources(sources, select=select)


def build_analyzer(paths: Iterable[str | pathlib.Path]) -> Analyzer:
    """An :class:`Analyzer` over the plane files under ``paths`` — the
    introspection entry point (doctor, ARCHITECTURE docs) when the caller
    wants the lock graph, not just findings."""
    return Analyzer({str(f): f.read_text() for f in plane_files(paths)})
