"""Protocol-drift pass: declared contracts vs. what the AST actually does.

Three structural invariants that ``runtime_checkable`` cannot see:

1. **Policy hints** (``policies.py``).  ``Policy.uses_predictor`` /
   ``unlimited_caps`` / ``uniform_caps`` let machines skip per-block
   predictor bookkeeping, cap queries and per-SM cap fan-outs.  A wrong
   hint is not a crash — it is a silently different (or slower) schedule.
   For every registry policy the pass checks the hint against the class's
   own code (its AST-MRO chain): predictor reads require
   ``uses_predictor=True`` and vice versa; a ``residency_cap`` override
   requires ``unlimited_caps=False`` and vice versa; a cap body that uses
   its ``sm`` parameter requires ``uniform_caps=False`` and vice versa.

2. **Fused fast paths** (``machine.py``).  ``SchedulerCore`` dispatches
   the two per-block events through fused methods
   (``post_block_start``/``post_block_end``) that must perform exactly the
   dispatch of the corresponding typed branches of ``post()`` (their
   bit-identical guarantee).  The pass extracts the (receiver, method,
   argument) call sequence from both sides — resolving the bound-method
   aliases ``bind()`` installs — and requires them identical.

3. **Machine signatures** (``machine.py`` vs. the concrete machines).
   ``isinstance(sim, Machine)`` only checks member *names*; here every
   protocol method is resolved through each implementation's class chain
   and its positional parameter names must match the protocol exactly,
   and each protocol attribute must be assigned in some ``__init__`` of
   the chain.

All checks are AST-only so they run against mutated tree copies.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .importgraph import CORE_DIR, list_modules
from .report import Finding

#: Hint attributes checked on every registry policy, with defaults from
#: the ``Policy`` base (kept in sync by the check itself: the base's
#: literal values are read from the AST, not hardcoded).
HINT_NAMES = ("uses_predictor", "unlimited_caps", "uniform_caps")

POLICY_BASE = "Policy"
REGISTRY_NAME = "POLICIES"
CORE_CLASS = "SchedulerCore"
PROTOCOL_CLASS = "Machine"
MACHINE_BASE = "MachineBase"
#: Concrete machines whose conformance is checked (module stem, class).
MACHINE_IMPLS = (("simulator", "Simulator"), ("executor", "LaneExecutor"))


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _classes(tree: ast.Module) -> Dict[str, ast.ClassDef]:
    return {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}


def _base_names(cls: ast.ClassDef) -> List[str]:
    out = []
    for b in cls.bases:
        if isinstance(b, ast.Name):
            out.append(b.id)
        elif isinstance(b, ast.Attribute):
            out.append(b.attr)
    return out


def _chain(name: str, classes: Dict[str, ast.ClassDef],
           stop: Optional[str] = None) -> List[ast.ClassDef]:
    """Linearized single-inheritance chain ``[cls, base, base's base, …]``
    restricted to classes defined in ``classes``; stops *before* ``stop``.
    """
    chain: List[ast.ClassDef] = []
    cur: Optional[str] = name
    seen = set()
    while cur is not None and cur in classes and cur not in seen:
        if cur == stop:
            break
        seen.add(cur)
        cls = classes[cur]
        chain.append(cls)
        bases = _base_names(cls)
        cur = bases[0] if bases else None
    return chain


def _methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _class_attr(chain: Sequence[ast.ClassDef], name: str):
    """Nearest literal class-level assignment of ``name`` in the chain.

    Returns (value, found); non-literal values count as found=True with
    value None (the checker then refuses to judge them).
    """
    for cls in chain:
        for node in cls.body:
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                target = node.targets[0].id
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.value is not None:
                target = node.target.id
            if target == name:
                try:
                    return ast.literal_eval(node.value), True
                except ValueError:
                    return None, True
    return None, False


def _reads_attr(nodes: Sequence[ast.AST], attr: str) -> Optional[int]:
    """First line where any node's subtree reads ``.<attr>``, else None."""
    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, ast.Attribute) and node.attr == attr:
                return node.lineno
    return None


def _uses_name(fn: ast.FunctionDef, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for stmt in fn.body for n in ast.walk(stmt))


# --------------------------------------------------------------- pass 1
def check_policy_hints(core_dir: Optional[Path] = None) -> List[Finding]:
    core_dir = Path(core_dir) if core_dir is not None else CORE_DIR
    findings: List[Finding] = []
    path = (Path(core_dir) / "policies.py")
    tree = _parse(path)
    classes = _classes(tree)

    def finding(rule, context, line, message):
        findings.append(Finding("protocol", rule, "policies", context,
                                line, message))

    if POLICY_BASE not in classes:
        finding("policy-base-missing", "", 1,
                f"class {POLICY_BASE} not found in policies.py")
        return findings

    registry: List[str] = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == REGISTRY_NAME \
                and isinstance(node.value, ast.Dict):
            for v in node.value.values:
                if isinstance(v, ast.Name):
                    registry.append(v.id)
    if not registry:
        finding("registry-missing", "", 1,
                f"{REGISTRY_NAME} dict of policy classes not found")
        return findings

    for name in registry:
        if name not in classes:
            finding("registry-unknown-class", name, 1,
                    f"{REGISTRY_NAME} references {name} but no such class "
                    "is defined in policies.py")
            continue
        chain = _chain(name, classes)          # includes Policy base
        below_base = _chain(name, classes, stop=POLICY_BASE)
        hints = {}
        for hint in HINT_NAMES:
            value, found = _class_attr(chain, hint)
            if found and not isinstance(value, bool):
                finding("hint-not-literal", name, classes[name].lineno,
                        f"{name}.{hint} is not a literal bool; the "
                        "analyzer (and readers) cannot verify it")
                value = None
            if not found:
                finding("hint-unresolved", name, classes[name].lineno,
                        f"{name}.{hint} is not declared anywhere in its "
                        "class chain")
                value = None
            hints[hint] = value

        methods: List[ast.FunctionDef] = []
        for cls in chain:
            methods.extend(_methods(cls).values())

        # -- uses_predictor vs. predictor reads ---------------------------
        read_line = _reads_attr(methods, "predictor")
        if hints["uses_predictor"] is False and read_line is not None:
            finding("undeclared-predictor-use", name, read_line,
                    f"{name} declares uses_predictor=False but its class "
                    "chain reads .predictor — machines would skip the "
                    "Algorithm-1 bookkeeping this policy depends on")
        if hints["uses_predictor"] is True and read_line is None:
            finding("stale-predictor-hint", name, classes[name].lineno,
                    f"{name} declares uses_predictor=True but its class "
                    "chain never reads .predictor — per-block predictor "
                    "bookkeeping runs for nothing")

        # -- unlimited_caps vs. residency_cap overrides -------------------
        cap_defs = [m for cls in below_base
                    for m in [_methods(cls).get("residency_cap")]
                    if m is not None]
        if cap_defs and hints["unlimited_caps"] is True:
            finding("undeclared-cap-override", name, cap_defs[0].lineno,
                    f"{name} overrides residency_cap but declares "
                    "unlimited_caps=True — machines would skip the cap "
                    "query entirely and the override would never run")
        if not cap_defs and hints["unlimited_caps"] is False:
            finding("stale-cap-hint", name, classes[name].lineno,
                    f"{name} declares unlimited_caps=False but inherits "
                    "the uncapped base residency_cap")

        # -- uniform_caps vs. per-SM cap logic ----------------------------
        sm_using = [m for m in cap_defs if len(m.args.args) >= 3
                    and _uses_name(m, m.args.args[2].arg)]
        if sm_using and hints["uniform_caps"] is True:
            finding("undeclared-per-sm-caps", name, sm_using[0].lineno,
                    f"{name}.residency_cap uses its per-unit argument but "
                    "declares uniform_caps=True — cap syncs would fan one "
                    "unit's answer out to all units")
        if cap_defs and not sm_using and hints["uniform_caps"] is False:
            finding("stale-per-sm-hint", name, classes[name].lineno,
                    f"{name} declares uniform_caps=False but its "
                    "residency_cap ignores the per-unit argument")
    return findings


# --------------------------------------------------------------- pass 2
Call = Tuple[str, str, Tuple[str, ...]]   # (receiver, method, arg names)


def _arg_names(call: ast.Call) -> Tuple[str, ...]:
    names = []
    for a in call.args:
        if isinstance(a, ast.Name):
            names.append(a.id)
        elif isinstance(a, ast.Attribute):       # event.key -> key
            names.append(a.attr)
        else:
            names.append(ast.dump(a))
    return tuple(names)


def _dispatch_calls(stmts: Sequence[ast.stmt],
                    aliases: Dict[str, Tuple[str, str]],
                    skip_lost: bool = False) -> List[Call]:
    """(receiver, method, args) sequence of predictor/policy dispatches in
    ``stmts``, in source order.  ``skip_lost`` skips `if <...>.lost:`
    sub-branches (the fault path is typed-post-only by design)."""
    calls: List[Call] = []

    def walk(stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            if skip_lost and isinstance(stmt, ast.If) \
                    and any(isinstance(n, ast.Attribute) and n.attr == "lost"
                            for n in ast.walk(stmt.test)):
                walk(stmt.orelse)
                continue
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if not isinstance(func, ast.Attribute):
                    continue
                if isinstance(func.value, ast.Attribute) \
                        and isinstance(func.value.value, ast.Name) \
                        and func.value.value.id == "self" \
                        and func.value.attr in ("predictor", "policy"):
                    calls.append((func.value.attr, func.attr,
                                  _arg_names(node)))
                elif isinstance(func.value, ast.Name) \
                        and func.value.id == "self" \
                        and func.attr in aliases:
                    recv, meth = aliases[func.attr]
                    calls.append((recv, meth, _arg_names(node)))

    walk(stmts)
    return calls


def check_fused_paths(core_dir: Optional[Path] = None) -> List[Finding]:
    core_dir = Path(core_dir) if core_dir is not None else CORE_DIR
    findings: List[Finding] = []
    tree = _parse(Path(core_dir) / "machine.py")
    classes = _classes(tree)

    def finding(rule, context, line, message):
        findings.append(Finding("protocol", rule, "machine", context,
                                line, message))

    core = classes.get(CORE_CLASS)
    if core is None:
        finding("core-missing", "", 1,
                f"class {CORE_CLASS} not found in machine.py")
        return findings
    methods = _methods(core)

    # Bound-method aliases installed by bind():
    # self._predictor_on_block_end = self.predictor.on_block_end
    aliases: Dict[str, Tuple[str, str]] = {}
    bind = methods.get("bind")
    if bind is not None:
        for stmt in ast.walk(bind):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                t, v = stmt.targets[0], stmt.value
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self" \
                        and isinstance(v, ast.Attribute) \
                        and isinstance(v.value, ast.Attribute) \
                        and isinstance(v.value.value, ast.Name) \
                        and v.value.value.id == "self" \
                        and v.value.attr in ("predictor", "policy"):
                    aliases[t.attr] = (v.value.attr, v.attr)

    post = methods.get("post")
    if post is None:
        finding("post-missing", CORE_CLASS, core.lineno,
                f"{CORE_CLASS}.post not found")
        return findings

    # Typed branches of post(): event class name -> branch body.
    branches: Dict[str, List[ast.stmt]] = {}
    for stmt in post.body:
        node = stmt
        while isinstance(node, ast.If):
            test = node.test
            if isinstance(test, ast.Call) \
                    and isinstance(test.func, ast.Name) \
                    and test.func.id == "isinstance" \
                    and len(test.args) == 2 \
                    and isinstance(test.args[1], ast.Name):
                branches[test.args[1].id] = node.body
            node = node.orelse[0] if len(node.orelse) == 1 \
                and isinstance(node.orelse[0], ast.If) else None

    pairs = (("post_block_start", "BlockStarted", False),
             ("post_block_end", "BlockEnded", True))
    for fused_name, event_cls, skip_lost in pairs:
        fused = methods.get(fused_name)
        if fused is None:
            finding("fused-path-missing", f"{CORE_CLASS}.{fused_name}",
                    core.lineno,
                    f"{CORE_CLASS}.{fused_name} not found")
            continue
        branch = branches.get(event_cls)
        if branch is None:
            finding("typed-branch-missing", f"{CORE_CLASS}.post",
                    post.lineno,
                    f"post() has no isinstance(event, {event_cls}) branch")
            continue
        fused_calls = _dispatch_calls(fused.body, aliases)
        typed_calls = _dispatch_calls(branch, aliases, skip_lost=skip_lost)
        if fused_calls != typed_calls:
            finding(
                "fused-path-drift", f"{CORE_CLASS}.{fused_name}",
                fused.lineno,
                f"fused {fused_name} dispatch {fused_calls} != typed "
                f"post()/{event_cls} dispatch {typed_calls}; the two "
                "paths must stay bit-identical (DESIGN.md Section 8)")
    return findings


# --------------------------------------------------------------- pass 3
def check_machine_signatures(core_dir: Optional[Path] = None
                             ) -> List[Finding]:
    core_dir = Path(core_dir) if core_dir is not None else CORE_DIR
    findings: List[Finding] = []
    modules = list_modules(core_dir)

    machine_tree = _parse(modules["machine"])
    machine_classes = _classes(machine_tree)

    def finding(rule, module, context, line, message):
        findings.append(Finding("protocol", rule, module, context, line,
                                message))

    proto = machine_classes.get(PROTOCOL_CLASS)
    if proto is None:
        finding("protocol-missing", "machine", "", 1,
                f"class {PROTOCOL_CLASS} not found in machine.py")
        return findings

    proto_methods = {
        name: [a.arg for a in fn.args.args[1:]]     # drop self
        for name, fn in _methods(proto).items()
    }
    proto_attrs = [n.target.id for n in proto.body
                   if isinstance(n, ast.AnnAssign)
                   and isinstance(n.target, ast.Name)]

    # Class map spanning machine.py and the implementation modules.
    all_classes = dict(machine_classes)
    impl_module: Dict[str, str] = {c: "machine" for c in machine_classes}
    for stem, cls_name in MACHINE_IMPLS:
        if stem not in modules:
            continue
        tree = _parse(modules[stem])
        for n, c in _classes(tree).items():
            all_classes.setdefault(n, c)
            impl_module.setdefault(n, stem)

    for stem, cls_name in MACHINE_IMPLS:
        if stem not in modules:
            continue
        if cls_name not in all_classes:
            finding("impl-missing", stem, cls_name, 1,
                    f"expected machine implementation {cls_name} not "
                    f"found in {stem}.py")
            continue
        chain = _chain(cls_name, all_classes)
        if not any(c.name == MACHINE_BASE for c in chain):
            finding("impl-base-drift", stem, cls_name,
                    all_classes[cls_name].lineno,
                    f"{cls_name} no longer derives from {MACHINE_BASE}; "
                    "the analyzer cannot resolve its protocol methods")
            continue

        for name, proto_args in sorted(proto_methods.items()):
            impl = None
            for cls in chain:
                impl = _methods(cls).get(name)
                if impl is not None:
                    break
            if impl is None:
                finding("method-missing", stem, f"{cls_name}.{name}",
                        all_classes[cls_name].lineno,
                        f"{cls_name} does not implement protocol method "
                        f"{name}() anywhere in its class chain")
                continue
            impl_args = [a.arg for a in impl.args.args[1:]]
            if impl_args != proto_args:
                finding(
                    "signature-drift", impl_module.get(cls.name, stem),
                    f"{cls.name}.{name}", impl.lineno,
                    f"{cls.name}.{name}({', '.join(impl_args)}) does not "
                    f"match protocol {PROTOCOL_CLASS}.{name}"
                    f"({', '.join(proto_args)}); positional names are "
                    "part of the contract (callers use keywords)")

        inits = [m for cls in chain
                 for m in [_methods(cls).get("__init__")] if m is not None]
        for attr in proto_attrs:
            assigned = False
            for init in inits:
                for node in ast.walk(init):
                    if isinstance(node, (ast.Assign, ast.AnnAssign)):
                        targets = node.targets \
                            if isinstance(node, ast.Assign) \
                            else [node.target]
                        for t in targets:
                            if isinstance(t, ast.Attribute) \
                                    and isinstance(t.value, ast.Name) \
                                    and t.value.id == "self" \
                                    and t.attr == attr:
                                assigned = True
            if not assigned:
                finding("attr-missing", stem, cls_name,
                        all_classes[cls_name].lineno,
                        f"{cls_name} never assigns protocol attribute "
                        f"self.{attr} in any __init__ of its chain")
    return findings


def check_protocols(core_dir: Optional[Path] = None) -> List[Finding]:
    """All three protocol-drift checks."""
    return (check_policy_hints(core_dir)
            + check_fused_paths(core_dir)
            + check_machine_signatures(core_dir))
