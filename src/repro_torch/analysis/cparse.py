"""Mini C front end for the generated-engine body (``fastsim_c._C_BODY``).

The translation validator (:mod:`repro_torch.analysis.translate`) needs a
*structural* view of the hand-written C translation — functions, control
flow, array accesses, operators — not a compiler.  The body is written in
a deliberately tiny C89 dialect (see DESIGN.md Section 11), so a small
tokenizer + recursive-descent parser covers it exactly:

* preprocessor: ``#include`` (ignored), object-like ``#define NAME val``
  (recorded — the drift check compares them against the twin's
  constants), function-like ``#define M(a, b) (...)`` accessor macros
  (recorded and expanded at call sites);
* ``typedef struct { ... } Name;`` (field order recorded — the ``Ev``
  struct defines the 7-tuple return convention, ``St`` the state-array
  order);
* ``static`` functions over ``int64_t``/``double``/``int``/``void``/
  struct types, C89 multi-declarator declarations, ``if``/``else``,
  ``while``, ``for`` (including ``for (;;)``), ``return``, ``break``,
  ``continue``, bare blocks;
* expressions: ``?:``, ``||``/``&&``/``!``, comparisons, ``+ - * /``,
  ``>>``/``<<``, casts, unary ``- & *``, postfix calls / ``[i]`` /
  ``.f`` / ``->f`` / ``++``/``--``, parentheses, int/float literals.

Anything outside the dialect raises :class:`CParseError` with a line
number; the validator turns that into a blocking finding (an engine edit
that the validator cannot read must not ship silently).

Expression nodes are plain tuples (first element is the tag)::

    ("num", value)            ("name", ident)
    ("call", name, [args])    ("idx", base, index)
    ("mem", base, field)      ("un", op, e)        op in {"-", "!", "&", "*"}
    ("bin", op, a, b)         ("cmp", op, a, b)
    ("bool", op, [parts])     op in {"&&", "||"}
    ("tern", cond, a, b)      ("cast", ctype, e)

``base->field`` is normalized to ``("mem", base, field)`` (the dialect
has no pointer-vs-value distinction worth keeping).  Statements are
small dataclasses (:class:`CIf`, :class:`CWhile`, ...).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CParseError",
    "CMacro",
    "CStruct",
    "CDecl",
    "CAssign",
    "CIf",
    "CWhile",
    "CFor",
    "CReturn",
    "CBreak",
    "CContinue",
    "CExprStmt",
    "CFunc",
    "CUnit",
    "parse_c",
]


class CParseError(SyntaxError):
    """The C body stepped outside the dialect the validator can read."""

    def __init__(self, message: str, line: int):
        super().__init__(f"line {line}: {message}")
        self.line = line


# --------------------------------------------------------------- tokenizer
_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+)
    | (?P<comment>/\*.*?\*/)
    | (?P<num>(?:\d+\.\d*(?:[eE][+-]?\d+)?)|(?:\.\d+(?:[eE][+-]?\d+)?)
             |(?:\d+[eE][+-]?\d+)|(?:\d+))
    | (?P<name>[A-Za-z_]\w*)
    | (?P<op>\+\+|--|\+=|-=|\*=|/=|<<|>>|<=|>=|==|!=|&&|\|\||->
            |[-+*/%<>=!&|?:;,.(){}\[\]])
    """,
    re.VERBOSE | re.DOTALL,
)


@dataclass
class _Tok:
    kind: str        # "num" | "name" | "op"
    text: str
    line: int


def _tokenize(src: str, start_line: int = 1) -> List[_Tok]:
    toks: List[_Tok] = []
    pos = 0
    line = start_line
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise CParseError(f"unreadable character {src[pos]!r}", line)
        kind = m.lastgroup
        text = m.group()
        if kind not in ("ws", "comment"):
            toks.append(_Tok(kind, text, line))
        line += text.count("\n")
        pos = m.end()
    return toks


def _parse_num(text: str):
    if re.fullmatch(r"\d+", text):
        return int(text)
    return float(text)


# ------------------------------------------------------------ declarations
@dataclass
class CMacro:
    """A ``#define``; ``params is None`` means object-like."""

    name: str
    params: Optional[List[str]]
    body: List[_Tok]
    line: int


@dataclass
class CStruct:
    name: str
    # (ctype, is_pointer, field_name) in declaration order.
    fields: List[Tuple[str, bool, str]]
    line: int


@dataclass
class CDecl:
    """One declarator of a declaration statement (``int64_t a = e, b;``
    yields two CDecls)."""

    ctype: str
    is_pointer: bool
    name: str
    init: Optional[tuple]
    array_dims: List[tuple] = field(default_factory=list)
    line: int = 0


@dataclass
class CAssign:
    target: tuple
    op: str            # "=", "+=", "-=", "*=", "/="
    value: tuple
    line: int = 0


@dataclass
class CIf:
    cond: tuple
    then: List[object]
    orelse: List[object]
    line: int = 0


@dataclass
class CWhile:
    cond: tuple
    body: List[object]
    line: int = 0


@dataclass
class CFor:
    """``for (init; cond; step)``; all three may be None (``for (;;)``)."""

    init: Optional[object]
    cond: Optional[tuple]
    step: Optional[object]
    body: List[object]
    line: int = 0


@dataclass
class CReturn:
    value: Optional[tuple]
    line: int = 0


@dataclass
class CBreak:
    line: int = 0


@dataclass
class CContinue:
    line: int = 0


@dataclass
class CExprStmt:
    expr: tuple
    line: int = 0


@dataclass
class CFunc:
    name: str
    rtype: str
    rtype_pointer: bool
    static: bool
    # (ctype, is_pointer, name) in order.
    params: List[Tuple[str, bool, str]]
    body: List[object]
    line: int = 0


@dataclass
class CUnit:
    macros: Dict[str, CMacro]
    object_defines: List[CMacro]
    structs: Dict[str, CStruct]
    functions: List[CFunc]


_TYPE_WORDS = {
    "int64_t", "int32_t", "int16_t", "int8_t", "uint64_t", "uint32_t",
    "double", "float", "int", "long", "short", "char", "void",
    "unsigned", "signed", "const", "static",
}

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/="}

_CMP_OPS = {"==", "!=", "<", "<=", ">", ">="}


# ----------------------------------------------------------------- parser
class _Parser:
    def __init__(self, toks: List[_Tok], macros: Dict[str, CMacro],
                 struct_names: Sequence[str]):
        self.toks = toks
        self.i = 0
        self.macros = macros
        self.struct_names = set(struct_names)

    # -- token helpers
    def _peek(self, ahead: int = 0) -> Optional[_Tok]:
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else None

    def _line(self) -> int:
        t = self._peek()
        return t.line if t else (self.toks[-1].line if self.toks else 0)

    def _next(self) -> _Tok:
        t = self._peek()
        if t is None:
            raise CParseError("unexpected end of input",
                              self.toks[-1].line if self.toks else 0)
        self.i += 1
        return t

    def _expect(self, text: str) -> _Tok:
        t = self._next()
        if t.text != text:
            raise CParseError(f"expected {text!r}, found {t.text!r}", t.line)
        return t

    def _at(self, text: str, ahead: int = 0) -> bool:
        t = self._peek(ahead)
        return t is not None and t.text == text

    # -- types
    def _looks_like_type(self) -> bool:
        t = self._peek()
        if t is None or t.kind != "name":
            return False
        return t.text in _TYPE_WORDS or t.text in self.struct_names

    def _parse_type(self) -> Tuple[str, bool]:
        words = []
        while self._looks_like_type():
            w = self._next().text
            if w not in ("const", "static"):
                words.append(w)
        if not words:
            raise CParseError("expected a type", self._line())
        is_ptr = False
        while self._at("*"):
            self._next()
            is_ptr = True
        return " ".join(words), is_ptr

    # -- expressions (precedence climbing)
    def parse_expr(self) -> tuple:
        return self._ternary()

    def _ternary(self) -> tuple:
        cond = self._or()
        if self._at("?"):
            self._next()
            a = self._ternary()
            self._expect(":")
            b = self._ternary()
            return ("tern", cond, a, b)
        return cond

    def _or(self) -> tuple:
        parts = [self._and()]
        while self._at("||"):
            self._next()
            parts.append(self._and())
        return parts[0] if len(parts) == 1 else ("bool", "||", parts)

    def _and(self) -> tuple:
        parts = [self._cmp()]
        while self._at("&&"):
            self._next()
            parts.append(self._cmp())
        return parts[0] if len(parts) == 1 else ("bool", "&&", parts)

    def _cmp(self) -> tuple:
        e = self._shift()
        while (t := self._peek()) is not None and t.text in _CMP_OPS:
            op = self._next().text
            e = ("cmp", op, e, self._shift())
        return e

    def _shift(self) -> tuple:
        e = self._add()
        while (t := self._peek()) is not None and t.text in ("<<", ">>"):
            op = self._next().text
            e = ("bin", op, e, self._add())
        return e

    def _add(self) -> tuple:
        e = self._mul()
        while (t := self._peek()) is not None and t.text in ("+", "-"):
            op = self._next().text
            e = ("bin", op, e, self._mul())
        return e

    def _mul(self) -> tuple:
        e = self._unary()
        while (t := self._peek()) is not None and t.text in ("*", "/", "%"):
            op = self._next().text
            e = ("bin", op, e, self._unary())
        return e

    def _unary(self) -> tuple:
        t = self._peek()
        if t is None:
            raise CParseError("unexpected end of expression", self._line())
        if t.text in ("-", "!", "&", "*"):
            self._next()
            return ("un", t.text, self._unary())
        if t.text == "(":
            # Cast or parenthesized expression.
            save = self.i
            self._next()
            if self._looks_like_type():
                ctype, is_ptr = self._parse_type()
                if self._at(")"):
                    self._next()
                    e = self._unary()
                    return ("cast", ctype + ("*" if is_ptr else ""), e)
            self.i = save
        return self._postfix()

    def _postfix(self) -> tuple:
        e = self._primary()
        while True:
            if self._at("("):
                if e[0] != "name":
                    raise CParseError("call of a non-identifier",
                                      self._line())
                self._next()
                args = []
                if not self._at(")"):
                    args.append(self.parse_expr())
                    while self._at(","):
                        self._next()
                        args.append(self.parse_expr())
                self._expect(")")
                e = ("call", e[1], args)
            elif self._at("["):
                self._next()
                idx = self.parse_expr()
                self._expect("]")
                e = ("idx", e, idx)
            elif self._at(".") or self._at("->"):
                self._next()
                f = self._next()
                if f.kind != "name":
                    raise CParseError("expected field name", f.line)
                e = ("mem", e, f.text)
            else:
                return e

    def _primary(self) -> tuple:
        t = self._next()
        if t.kind == "num":
            return ("num", _parse_num(t.text))
        if t.kind == "name":
            if t.text in self.macros and self.macros[t.text].params is not None \
                    and self._at("("):
                self._next()
                args: List[tuple] = []
                if not self._at(")"):
                    args.append(self.parse_expr())
                    while self._at(","):
                        self._next()
                        args.append(self.parse_expr())
                self._expect(")")
                macro = self.macros[t.text]
                if len(args) != len(macro.params or ()):
                    raise CParseError(
                        f"macro {t.text} called with {len(args)} arg(s), "
                        f"defined with {macro.params}", t.line)
                return ("mcall", t.text, args)
            return ("name", t.text)
        if t.text == "(":
            e = self.parse_expr()
            self._expect(")")
            return e
        raise CParseError(f"unexpected token {t.text!r}", t.line)

    # -- statements
    def _parse_block(self) -> List[object]:
        self._expect("{")
        stmts: List[object] = []
        while not self._at("}"):
            stmts.extend(self._parse_stmt())
        self._expect("}")
        return stmts

    def _parse_stmt_or_block(self) -> List[object]:
        if self._at("{"):
            return self._parse_block()
        return self._parse_stmt()

    def _parse_decl_stmt(self) -> List[CDecl]:
        line = self._line()
        ctype, first_ptr = self._parse_type()
        decls: List[CDecl] = []
        while True:
            is_ptr = first_ptr
            while self._at("*"):
                self._next()
                is_ptr = True
            name_tok = self._next()
            if name_tok.kind != "name":
                raise CParseError("expected declarator name", name_tok.line)
            dims: List[tuple] = []
            while self._at("["):
                self._next()
                dims.append(self.parse_expr())
                self._expect("]")
            init = None
            if self._at("="):
                self._next()
                init = self.parse_expr()
            decls.append(CDecl(ctype, is_ptr, name_tok.text, init, dims,
                               line))
            if self._at(","):
                self._next()
                first_ptr = False
                continue
            self._expect(";")
            return decls

    def _parse_simple_stmt(self, terminator: str) -> Optional[object]:
        """Assignment / call / ++ / -- up to ``terminator`` (not eaten)."""
        if self._at(terminator):
            return None
        line = self._line()
        e = self.parse_expr()
        t = self._peek()
        if t is not None and t.text in _ASSIGN_OPS:
            op = self._next().text
            value = self.parse_expr()
            return CAssign(e, op, value, line)
        if t is not None and t.text in ("++", "--"):
            self._next()
            one = ("num", 1)
            return CAssign(e, "+=" if t.text == "++" else "-=", one, line)
        return CExprStmt(e, line)

    def _parse_stmt(self) -> List[object]:
        t = self._peek()
        if t is None:
            raise CParseError("unexpected end of function body", self._line())
        line = t.line
        if t.text == "{":
            # Bare block: flatten (scopes carry no meaning in the IR).
            return self._parse_block()
        if t.text == ";":
            self._next()
            return []
        if t.kind == "name" and (t.text in _TYPE_WORDS
                                 or t.text in self.struct_names):
            return list(self._parse_decl_stmt())
        if t.text == "if":
            self._next()
            self._expect("(")
            cond = self.parse_expr()
            self._expect(")")
            then = self._parse_stmt_or_block()
            orelse: List[object] = []
            if self._at("else"):
                self._next()
                orelse = self._parse_stmt_or_block()
            return [CIf(cond, then, orelse, line)]
        if t.text == "while":
            self._next()
            self._expect("(")
            cond = self.parse_expr()
            self._expect(")")
            return [CWhile(cond, self._parse_stmt_or_block(), line)]
        if t.text == "for":
            self._next()
            self._expect("(")
            init: Optional[object] = None
            if not self._at(";"):
                if self._looks_like_type():
                    raise CParseError(
                        "C89 dialect: no declarations in for-init", line)
                init = self._parse_simple_stmt(";")
            self._expect(";")
            cond = None if self._at(";") else self.parse_expr()
            self._expect(";")
            step = self._parse_simple_stmt(")")
            self._expect(")")
            return [CFor(init, cond, step, self._parse_stmt_or_block(), line)]
        if t.text == "return":
            self._next()
            value = None if self._at(";") else self.parse_expr()
            self._expect(";")
            return [CReturn(value, line)]
        if t.text == "break":
            self._next()
            self._expect(";")
            return [CBreak(line)]
        if t.text == "continue":
            self._next()
            self._expect(";")
            return [CContinue(line)]
        stmt = self._parse_simple_stmt(";")
        self._expect(";")
        return [stmt] if stmt is not None else []


# ------------------------------------------------------- top-level parsing
_DEFINE_RE = re.compile(r"^[ \t]*#[ \t]*define[ \t]+(\w+)(\(([^)]*)\))?"
                        r"[ \t]*(.*?)[ \t]*$")


def _strip_preprocessor(src: str) -> Tuple[str, Dict[str, CMacro],
                                           List[CMacro]]:
    """Collect #defines; blank out all # lines (preserving line count)."""
    macros: Dict[str, CMacro] = {}
    object_defines: List[CMacro] = []
    out_lines: List[str] = []
    for lineno, raw in enumerate(src.split("\n"), start=1):
        stripped = raw.lstrip()
        if not stripped.startswith("#"):
            out_lines.append(raw)
            continue
        out_lines.append("")
        m = _DEFINE_RE.match(raw)
        if m is None:
            continue            # include etc.
        name, has_params, params_text, body_text = (
            m.group(1), m.group(2), m.group(3), m.group(4))
        params = None
        if has_params is not None:
            params = [p.strip() for p in params_text.split(",") if p.strip()]
        body = _tokenize(body_text, lineno)
        macro = CMacro(name, params, body, lineno)
        if params is None:
            object_defines.append(macro)
        else:
            macros[name] = macro
    return "\n".join(out_lines), macros, object_defines


_STRUCT_RE = re.compile(
    r"typedef\s+struct\s*\{(?P<body>[^}]*)\}\s*(?P<name>\w+)\s*;",
    re.DOTALL,
)


def _parse_structs(src: str) -> Tuple[str, Dict[str, CStruct]]:
    structs: Dict[str, CStruct] = {}

    def grab(m: re.Match) -> str:
        body = m.group("body")
        name = m.group("name")
        line = src[:m.start()].count("\n") + 1
        fields: List[Tuple[str, bool, str]] = []
        for decl in body.split(";"):
            decl = decl.strip()
            if not decl:
                continue
            toks = _tokenize(decl, line)
            words = [t.text for t in toks]
            type_words = []
            k = 0
            while k < len(words) and words[k] in _TYPE_WORDS:
                type_words.append(words[k])
                k += 1
            ctype = " ".join(type_words)
            is_ptr = False
            cur_name = None
            for w in words[k:]:
                if w == "*":
                    is_ptr = True
                elif w == ",":
                    fields.append((ctype, is_ptr, cur_name))
                    is_ptr = False
                    cur_name = None
                else:
                    cur_name = w
            if cur_name is not None:
                fields.append((ctype, is_ptr, cur_name))
        structs[name] = CStruct(name, fields, line)
        # Blank out, preserving newlines so later line numbers survive.
        return "\n" * m.group(0).count("\n")

    return _STRUCT_RE.sub(grab, src), structs


def parse_c(src: str) -> CUnit:
    """Parse the engine's C dialect into a :class:`CUnit`."""
    src, macros, object_defines = _strip_preprocessor(src)
    src, structs = _parse_structs(src)
    toks = _tokenize(src)
    parser = _Parser(toks, macros, list(structs))
    functions: List[CFunc] = []
    while parser._peek() is not None:
        line = parser._line()
        static = False
        if parser._at("static"):
            parser._next()
            static = True
        rtype, rptr = parser._parse_type()
        name_tok = parser._next()
        if name_tok.kind != "name":
            raise CParseError("expected function name", name_tok.line)
        parser._expect("(")
        params: List[Tuple[str, bool, str]] = []
        if not parser._at(")"):
            while True:
                ptype, pptr = parser._parse_type()
                ptok = parser._next()
                if ptok.kind != "name":
                    raise CParseError("expected parameter name", ptok.line)
                params.append((ptype, pptr, ptok.text))
                if parser._at(","):
                    parser._next()
                    continue
                break
        parser._expect(")")
        body = parser._parse_block()
        functions.append(CFunc(name_tok.text, rtype, rptr, static, params,
                               body, line))
    return CUnit(macros=macros, object_defines=object_defines,
                 structs=structs, functions=functions)
